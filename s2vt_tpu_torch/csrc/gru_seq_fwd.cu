// Per-layer GRU sequence forward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_gru.py::_fwd_kernel (launched by _run_forward).
// One GRU layer over T steps, torch gate order (r, z, n):
//
//   gh_t = h_{t-1} @ W_hh^T + b_hh           (x_proj_t carries b_ih only)
//   r = sigmoid(xp_r + gh_r) ;  z = sigmoid(xp_z + gh_z)
//   n = tanh(xp_n + r * gh_n) ;  h_t = (1 - z) * n + z * h_{t-1}
//
// from h0, emitting in time order the h sequence, the post-activation gates
// (r, z, n), gh_n (the hidden projection's n-column before the reset gate,
// which the backward needs) and the final hT. b_hh is added after the
// product and before x_proj, in the TPU kernel's order: the reset gate
// multiplies gh_n, so b_hh cannot be folded into x_proj. Everything it reads
// and writes is float32; with bf16 != 0 the operands of the recurrent
// product (h_{t-1} and W_hh) are rounded to bf16 first, as the TPU kernel
// does, and nothing else is (the h_{t-1} of the update is float32).
//
// Three routes, chosen by the caller before the launch
// (ops/fused_gru.py::gru_seq_fwd_route): "mma" (below, after the direct
// kernel: batch groups, bf16 on the tensor cores, h exchanged as step-tagged
// words) for the widths and batches where it was measured faster, "direct"
// for every other shape whose weights fit its blocks' shared memory, and
// "stream" (last, on stream.cuh: one launch per step, W_hh read from global
// memory) for the widths beyond.
//
// "direct" route.
// Design (that of lstm_seq_fwd.cu's direct route with three gate rows per
// unit):
//  - One persistent cooperative launch; one grid-wide barrier between steps
//    (T - 1 of them). The grid is ceil(H / U) blocks, one per SM.
//  - Block b owns hidden units j in [b*U, b*U + U). It keeps the three gate
//    rows of W_hh for those units (3*U rows of H values, float32) resident in
//    shared memory for the whole launch, so each unit's gates are formed
//    inside its own block and no gate value crosses blocks.
//  - h_{t-1} is read back from the h-sequence output written by all blocks
//    one step earlier (h0 at t = 0), with __ldcg (L2, not the incoherent L1):
//    the output is the exchange buffer, so no ping-pong buffer is needed.
//    The float32 h_{t-1} of the update is read back by the thread that wrote
//    it.
//  - Per batch tile of up to 16 rows: the h tile goes to shared memory
//    (rounded to bf16 first in bf16 mode); each warp takes one (unit, group
//    of 4 rows) item, its 32 lanes split the k range and accumulate a 3-gate
//    x 4-row register tile (padded to the 16 sums the reduce-scatter takes),
//    and a warp reduce-scatter leaves the sums with lanes 0-15; one thread
//    per (row, unit) then runs the gate math.
//  - Products and sums float32 on the CUDA cores (no tensor cores in this
//    version).
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, float32:
//  - beam encode, T = 80: x_proj and gates 7.9 MB each, the h and gh_n
//    sequences 2.6 MB each, W_hh 3 MB: ~24 MB -> ~7 us at 3.35 TB/s;
//    2*T*B*3H*H = 2.0 GFLOP -> ~30 us at the 67 TFLOP/s float32 peak. The
//    operations set the bound (in bf16, at the tensor-core peak, the bytes).
//  - In practice neither: the floor is the chain of T dependent steps, each
//    ending in a grid-wide barrier and starting with a re-read of h (B * H
//    floats) from L2 in every block. The design keeps everything else off
//    that chain: the weights never leave shared memory.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "exchange.cuh"
#include "mma.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchTile = 16;  // batch rows per shared-memory h tile
constexpr int kRowBlock = 4;    // batch rows per warp item (register tile)
constexpr int kGates = 3;
constexpr int kVals = 16;       // sums per item: 3 gates x 4 rows, padded to 16
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

size_t smem_floats(int H, int U) {
  const size_t w = (size_t)kGates * U * H;                        // [U][3][H]
  const size_t h = (size_t)kBatchTile * H;                        // [16][H]
  const size_t red = (size_t)U * (kBatchTile / kRowBlock) * kVals;  // item sums
  return w + h + red;
}

int threads_for(int U) {
  const int t = 32 * U * (kBatchTile / kRowBlock);  // one warp per item
  return t < kMaxThreads ? t : kMaxThreads;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
gru_seq_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                   const float* __restrict__ bhh, const float* __restrict__ h0, float* out,
                   float* gates, float* ghn, float* hT, int T, int B, int H, int U, int bf16) {
  extern __shared__ float smem[];
  float* wsm = smem;                              // [U][3][H]
  float* hsm = wsm + (size_t)kGates * U * H;      // [16][H]
  float* red = hsm + (size_t)kBatchTile * H;      // [U * 4][16]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int j0 = blockIdx.x * U;
  const int G = kGates * H;

  // Resident weights: wsm[(u*3 + g)*H + k] = W_hh[g*H + j0 + u, k].
  for (int idx = tid; idx < kGates * U * H; idx += nthr) {
    const int k = idx % H, r = idx / H;
    const int g = r % kGates, u = r / kGates;
    const int j = j0 + u;
    const float v = j < H ? w[(size_t)(g * H + j) * H + k] : 0.0f;
    wsm[idx] = bf16 ? round_bf16(v) : v;
  }

  for (int t = 0; t < T; ++t) {
    const float* hin = t == 0 ? h0 : out + (size_t)(t - 1) * B * H;

    for (int b0 = 0; b0 < B; b0 += kBatchTile) {
      const int bt = min(kBatchTile, B - b0);
      const int nbg = (bt + kRowBlock - 1) / kRowBlock;
      const int items = U * nbg;

      __syncthreads();  // weights loaded / the previous tile's readers done
      // The tile's rows are contiguous in hin: float4 copies when H % 4 == 0
      // (every row then starts 16-byte aligned), four in flight per thread
      // before any store; single floats otherwise.
      if ((H & 3) == 0) {
        const float4* src = reinterpret_cast<const float4*>(hin + (size_t)b0 * H);
        float4* dst = reinterpret_cast<float4*>(hsm);
        const int n4 = bt * H / 4;
        for (int i0 = tid; i0 < n4; i0 += 4 * nthr) {
          float4 v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i0 + q * nthr < n4) v[q] = __ldcg(src + i0 + q * nthr);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (i0 + q * nthr >= n4) break;
            if (bf16) {
              v[q].x = round_bf16(v[q].x);
              v[q].y = round_bf16(v[q].y);
              v[q].z = round_bf16(v[q].z);
              v[q].w = round_bf16(v[q].w);
            }
            dst[i0 + q * nthr] = v[q];
          }
        }
      } else {
        const float* src = hin + (size_t)b0 * H;
        for (int i = tid; i < bt * H; i += nthr) {
          const float v = __ldcg(src + i);
          hsm[i] = bf16 ? round_bf16(v) : v;
        }
      }
      __syncthreads();

      // Products: warp-uniform loop over items, lanes over k.
      for (int item = warp; item < items; item += nwarps) {
        const int bg = item % nbg, u = item / nbg;
        const float* wu = wsm + (size_t)u * kGates * H;
        const float* hr[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) hr[n] = hsm + min(bg * kRowBlock + n, bt - 1) * H;
        float acc[kVals];
#pragma unroll
        for (int i = 0; i < kVals; ++i) acc[i] = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const float w0 = wu[k], w1 = wu[H + k], w2 = wu[2 * H + k];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            const float hv = hr[n][k];
            acc[0 * kRowBlock + n] = fmaf(w0, hv, acc[0 * kRowBlock + n]);
            acc[1 * kRowBlock + n] = fmaf(w1, hv, acc[1 * kRowBlock + n]);
            acc[2 * kRowBlock + n] = fmaf(w2, hv, acc[2 * kRowBlock + n]);
          }
        }
        reduce_scatter(acc, lane);
        if (lane < kVals) red[item * kVals + lane] = acc[0];
      }
      __syncthreads();

      // Gate math: one thread per (row, unit). The thread that runs (b, j)
      // is the same at every step, so it reads back the h_{t-1} it wrote.
      for (int idx = tid; idx < bt * U; idx += nthr) {
        const int u = idx % U, r = idx / U;
        const int j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        const float* p = red + (size_t)(u * nbg + r / kRowBlock) * kVals + r % kRowBlock;
        const size_t grow = ((size_t)t * B + b) * G + j;
        const size_t hrow = (size_t)b * H + j;
        const float ghr = p[0 * kRowBlock] + bhh[j];
        const float ghz = p[1 * kRowBlock] + bhh[H + j];
        const float ghnv = p[2 * kRowBlock] + bhh[2 * H + j];
        const float rg = sigmoid_f(xp[grow] + ghr);
        const float zg = sigmoid_f(xp[grow + H] + ghz);
        const float ng = tanhf(xp[grow + 2 * H] + rg * ghnv);
        const float hprev = t > 0 ? out[(size_t)(t - 1) * B * H + hrow] : h0[hrow];
        const float h = (1.0f - zg) * ng + zg * hprev;
        gates[grow] = rg;
        gates[grow + H] = zg;
        gates[grow + 2 * H] = ng;
        ghn[(size_t)t * B * H + hrow] = ghnv;
        out[(size_t)t * B * H + hrow] = h;
        if (t == T - 1) hT[hrow] = h;
      }
    }
    if (t + 1 < T) grid.sync();
  }
}


// ---------------------------------------------------------------------------
// "mma" route. Replaces the same TPU kernel (pallas_gru.py::_fwd_kernel) for
// the shapes ops/fused_gru.py::gru_seq_fwd_route sends here. On an H100 the
// direct route's step goes to the grid barrier, every block's serial re-read
// of all of h_{t-1} in 16-row tiles and the products on the CUDA cores, in
// bf16 as in float32. This route is lstm_seq_fwd.cu's mma route with three
// gate rows per unit:
//
//  - Splits the batch into groups. The grid is G groups of P = H / U blocks
//    (G P <= the card's SMs); block p of group q runs the cells of units
//    [p U, p U + U) for the group's batch rows [q R, q R + R), R = ceil(B/G),
//    and reads only its group's rows of h_{t-1}. ops/fused_gru.py::
//    gru_mma_plan picks U (4, 8, 16; 32 in bf16: the one measured fastest
//    for the batch and mode), G and the m16 row tiles per pass from the
//    card's SMs and shared memory.
//  - Keeps the block's 3U gate rows of W_hh (row g U + u, zero rows after
//    them up to whole n8 tiles: 16 rows at U = 4) resident in shared memory,
//    in the operand type, for the whole launch, and runs all of the group's
//    rows in one pass where shared memory and a thread's kSlots cells allow.
//  - bf16: the products on the tensor cores, m16n8k16 on bf16 operands with
//    float32 accumulation. The columns are 2 n8 tiles at U = 4 (one warp
//    each), 3 at U = 8 (every warp takes all 3 over its own k share), 6 at
//    U = 16 and 12 at U = 32 (3 per warp); operands come by ldmatrix, two k
//    slices at a time; the k shares meet in shared memory and the cells add
//    them in a fixed order.
//  - float32: the products on the CUDA cores, each gate sum formed in the
//    direct route's order (per unit and 4 rows, lane-strided k, fused
//    multiply-adds into slot g * 4 + n of 16 with slots 12-15 zero, the warp
//    reduce-scatter), so that the two routes' float32 results are equal bit
//    for bit. A warp item is 2 units x 4 rows (10 shared loads per 24
//    multiply-adds).
//  - Runs each cell in one lane: it adds its three gates' k shares, b_hh
//    (after the sum, as the direct route: the reset gate multiplies gh_n),
//    then x_proj, and forms r, z, n and h in the direct route's expressions
//    as the direct kernel compiles them (n = tanh(fma(r, gh_n, xp_n)), h =
//    fma(1 - z, n, z h_{t-1})). The lane keeps its cell's float32 h_{t-1}
//    in a register for the whole launch (h0 at t = 0): the exchanged word
//    carries only a bf16 operand in bf16 mode and is never read for the
//    update. b_hh is loaded once. A pass's x_proj is loaded into registers
//    before its poll, so that it lands while the block waits for the
//    step's words (tools/gru_fwd_variants.py: loaded after the poll, or by
//    each cell as it runs, it measured slower; a cell in the 4 lanes of a
//    quad, r shuffled to the n lane, spilled and ran slower).
//  - Has no grid-wide barrier and no flag. Beside `out`, a cell writes h_t
//    into an exchange buffer xch [2][B][H] (by step parity) as an 8-byte
//    {value, step + 1} word (exchange.cuh); in bf16 mode a word carries the
//    bf16 operands of two neighbouring units [2][B][H/2], since the product
//    reads only those. The block's threads poll the words of its group's
//    rows, 16 bytes per load, until every tag is the step's, and stage them
//    in shared memory. A poll that waits kSpinLimitNs of wall time traps
//    with a message. The launch is cooperative, so every block is resident
//    at once or the launch fails. The word goes out before the stores of
//    the gates, gh_n, h and hT, which are off the chain.
//
// Bounds (chip_smoke.py recomputes them): the direct route's bytes and, in
// float32, its operations at the float32 peak (60 us at B = 16, T = 159);
// in bf16 the operations of h @ W_hh^T at the bf16 peak, so the bytes (13
// us). In practice the chain of T dependent steps: each step's poll waits
// for the slowest block of the group, then the products and the cells run
// before any word of the next step can be written. Block 0's clock cycles
// per step at H = 512, T = 159 (tools/gru_fwd_variants.py, phase_clock):
// B = 16 (U = 8) poll 2218, products 2822, cells 1118 in float32; 2172,
// 1212, 1208 in bf16. At B = 96 (U = 16) the float32 products take 16076
// of 21837 (48 CUDA-core items of 2 units x 4 rows over 8 warps), bf16
// poll 2764, products 2520, cells 2012.

namespace mma_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                        // cells per thread per step
constexpr int kMaxTiles = 4;                     // m16 row tiles staged per pass
constexpr int kMaxHidden = 512;                  // a lane's loads per row: H / 64 or H / 128
constexpr int kLoads = 16;                       // 16-byte exchange loads per thread in flight

template <int kBf16, int kU>
struct Tile {
  using Elem = typename std::conditional<kBf16 != 0, __nv_bfloat16, float>::type;
  static constexpr int kN = (3 * kU + 7) / 8 * 8;            // gate columns, whole n8 tiles
  static constexpr int kNT = kN / 8;                         // n8 tiles
  static constexpr int kNTW = kNT % 3 == 0 ? 3 : (kNT > kWarps ? kNT / kWarps : 1);
  static constexpr int kWarpsN = kNT / kNTW;                 // n8 tiles per warp: kNTW
  static constexpr int kWarpsK = kWarps / kWarpsN;           // k shares
  static constexpr int kKStep = 16;                          // k per mma.sync (bf16)
  static constexpr int kPad = kBf16 ? 8 : 4;                 // 16 bytes per staged row
  static constexpr int kRedStride = kN + 4;                  // k-share row, in floats
  static constexpr int kPerLane = kBf16 ? 4 : 8;             // 16-byte loads per lane and row
  static constexpr int kRowsW = kLoads / kPerLane;           // rows per warp per poll chunk
  static constexpr int kGroup = 2;                           // k slices in flight per warp
  static constexpr int kShares = kBf16 ? kWarpsK : 1;        // k shares of a gate sum
  static_assert(kNT % kNTW == 0 && kWarpsN * kWarpsK == kWarps,
                "warps tile the columns and the k range");
};

template <int kBf16, int kU>
size_t smem_bytes(int H, int tiles) {
  using C = Tile<kBf16, kU>;
  return (size_t)(C::kN + 16 * tiles) * (H + C::kPad) * sizeof(typename C::Elem) +
         (size_t)4 * C::kShares * 16 * tiles * C::kRedStride;
}

// Cells per thread per pass: the pass's 16 tiles U cells over the threads.
__host__ __device__ __forceinline__ int cells_per_pass(int U, int tiles) {
  return (16 * tiles * U + kThreads - 1) / kThreads;
}

template <int kBf16>
__device__ __forceinline__ typename Tile<kBf16, 4>::Elem operand(float v) {
  if constexpr (kBf16) return __float2bfloat16_rn(v);
  else return v;
}

__device__ __noinline__ void poll_trap(unsigned long long waited, int step, int row) {
  printf("gru_seq_fwd mma route: block %d thread %d polled %llu ns for batch row %d of "
         "step %d's h; trapping\n", blockIdx.x, threadIdx.x, waited, row, step);
  __trap();
}

// One more round of a poll that started at `start` (0: not yet): traps once
// it has waited kSpinLimitNs of wall time.
__device__ __forceinline__ void poll_round(unsigned long long& start, int step, int row) {
  const unsigned long long now = global_ns();
  if (start == 0) start = now;
  else if (now - start > kSpinLimitNs) poll_trap(now - start, step, row);
}

template <int kBf16, int kU>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_fwd_kernel_mma(const float* __restrict__ xp, const float* __restrict__ w,
                       const float* __restrict__ bhh, const float* __restrict__ h0,
                       float* __restrict__ out, float* __restrict__ gates,
                       float* __restrict__ ghn, float* __restrict__ hT,
                       unsigned long long* xch, int T, int B, int H, int groups, int tiles) {
  using C = Tile<kBf16, kU>;
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = H + C::kPad;                   // staged row, in elements
  const int RP = 16 * tiles;                        // rows per pass
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw);    // [kN][stride]: row g U + u
  Elem* hs = wsm + (size_t)C::kN * stride;          // [RP][stride]
  float* red = reinterpret_cast<float*>(hs + (size_t)RP * stride);   // [kShares][RP][kRedStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int P = gridDim.x / groups;                 // blocks per group
  const int j0 = (blockIdx.x % P) * kU;             // units [j0, j0 + kU)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;              // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int npass = (rows + RP - 1) / RP;
  const int ppp = cells_per_pass(kU, tiles);        // slots per pass
  const int G3 = 3 * H;
  const int wrow = kBf16 ? H / 2 : H;               // exchange words per batch row

  // Resident weights: wsm[(g U + u) * stride + k] = W_hh[g H + j0 + u, k];
  // zeros in the rows past 3U.
  for (int idx = tid; idx < C::kN * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H;
    const int gi = n / kU, u = n - gi * kU;
    const float v = gi < 3 ? w[(size_t)(gi * H + j0 + u) * H + k] : 0.0f;
    wsm[(size_t)n * stride + k] = operand<kBf16>(v);
  }

  // This thread's cells: slot s of pass ps = s / ppp is cell m * kThreads +
  // tid (m = s % ppp) of the pass, row-major over the pass's rows and the
  // block's units; each keeps its float32 h_{t-1} and its units' b_hh.
  int cell_of[kSlots];                              // b * kU + u, or -1
  float carry[kSlots];                              // the cell's h_{t-1}
  float bias[kSlots][3];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    cell_of[s] = -1;
    carry[s] = 0.0f;
    bias[s][0] = bias[s][1] = bias[s][2] = 0.0f;
    const int ps = s / ppp, m = s - ps * ppp;
    if (ps >= npass) continue;
    const int cell = m * kThreads + tid;
    const int r = cell / kU, u = cell % kU;
    if (r >= min(RP, rows - ps * RP)) continue;
    const int b = b0 + ps * RP + r;
    cell_of[s] = b * kU + u;
    carry[s] = h0[(size_t)b * H + j0 + u];
#pragma unroll
    for (int gi = 0; gi < 3; ++gi) bias[s][gi] = bhh[gi * H + j0 + u];
  }
  const int wn = warp % C::kWarpsN, wk = warp / C::kWarpsN;
  const int per = H / C::kKStep / C::kWarpsK;       // k slices of this warp's share (bf16)
  const uint32_t w_addr = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t h_addr = (uint32_t)__cvta_generic_to_shared(hs);

  for (int t = 0; t < T; ++t) {
    for (int ps = 0; ps < npass; ++ps) {
      const int pr0 = ps * RP;
      const int rp = min(RP, rows - pr0);
      // x_proj of the pass's cells, loaded before the poll so that it lands
      // while the block waits for the step's words.
      float xv[kSlots][3];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        xv[s][0] = xv[s][1] = xv[s][2] = 0.0f;
        if (s < ps * ppp || s >= (ps + 1) * ppp || cell_of[s] < 0) continue;
        const int b = cell_of[s] / kU, u = cell_of[s] % kU;
        const float* x = xp + ((size_t)t * B + b) * G3 + j0 + u;
#pragma unroll
        for (int gi = 0; gi < 3; ++gi) xv[s][gi] = x[gi * H];
      }
      // h_{t-1} of rows [b0 + pr0, + rp) into hs, as product operands.
      if (t == 0) {
        for (int idx = tid; idx < rp * H; idx += kThreads) {
          const int r = idx / H, k = idx - r * H;
          hs[(size_t)r * stride + k] = operand<kBf16>(h0[(size_t)(b0 + pr0 + r) * H + k]);
        }
      } else {
        const unsigned tag = t;                     // written by step t - 1
        const unsigned long long* base = xch + ((size_t)((t - 1) & 1) * B + b0 + pr0) * wrow;
        const int v2row = wrow / 2;                 // 16-byte loads per row
        for (int r0 = 0; r0 < rp; r0 += kWarps * C::kRowsW) {
          unsigned long long v[C::kRowsW][C::kPerLane][2];
#pragma unroll
          for (int rr = 0; rr < C::kRowsW; ++rr)
#pragma unroll
            for (int i = 0; i < C::kPerLane; ++i) {
              const int r = r0 + warp + kWarps * rr, col = lane + 32 * i;
              if (r < rp && col < v2row) ld_words(v[rr][i], base + (size_t)r * wrow + 2 * col);
            }
          unsigned long long start = 0;
          for (;;) {
            bool stale = false;
#pragma unroll
            for (int rr = 0; rr < C::kRowsW; ++rr)
#pragma unroll
              for (int i = 0; i < C::kPerLane; ++i) {
                const int r = r0 + warp + kWarps * rr, col = lane + 32 * i;
                stale |= r < rp && col < v2row && !tagged(v[rr][i], tag);
              }
            if (!stale) break;
            poll_round(start, t - 1, b0 + pr0 + r0 + warp);
#pragma unroll
            for (int rr = 0; rr < C::kRowsW; ++rr)   // every stale word again, together
#pragma unroll
              for (int i = 0; i < C::kPerLane; ++i) {
                const int r = r0 + warp + kWarps * rr, col = lane + 32 * i;
                if (r < rp && col < v2row && !tagged(v[rr][i], tag))
                  ld_words(v[rr][i], base + (size_t)r * wrow + 2 * col);
              }
          }
#pragma unroll
          for (int rr = 0; rr < C::kRowsW; ++rr)
#pragma unroll
            for (int i = 0; i < C::kPerLane; ++i) {
              const int r = r0 + warp + kWarps * rr, col = lane + 32 * i;
              if (r >= rp || col >= v2row) continue;
              const uint2 x = make_uint2((unsigned)v[rr][i][0], (unsigned)v[rr][i][1]);
              *reinterpret_cast<uint2*>(hs + (size_t)r * stride + (kBf16 ? 4 : 2) * col) = x;
            }
        }
      }
      __syncthreads();                              // hs holds the pass's rows
      if constexpr (kBf16) {
        // Products: this warp's n8 tiles over its k share, every m16 tile of
        // the pass, two k slices' fragments loaded together.
        const int mtiles = (rp + 15) / 16;
        const int s_end = (wk + 1) * per;
        float acc[kMaxTiles][C::kNTW][4];
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
#pragma unroll 1
        for (int s0 = wk * per; s0 < s_end; s0 += C::kGroup) {
          uint32_t bw[C::kGroup][C::kNTW][2];
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u) {
            if (s0 + u >= s_end) break;             // an odd share's last slice
#pragma unroll
            for (int nt = 0; nt < C::kNTW; ++nt) {
              const int n0 = (wn * C::kNTW + nt) * 8;
              ldsm_x2(bw[u][nt], w_addr + (uint32_t)(((n0 + (lane & 7)) * stride +
                                                      (s0 + u) * C::kKStep +
                                                      ((lane >> 3) & 1) * (C::kKStep / 2)) *
                                                     sizeof(Elem)));
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt) {
            if (mt >= mtiles) break;
            uint32_t a[C::kGroup][4];
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u) {
              if (s0 + u >= s_end) break;
              ldsm_x4(a[u], h_addr + (uint32_t)(((mt * 16 + (lane & 15)) * stride +
                                                 (s0 + u) * C::kKStep +
                                                 (lane >> 4) * (C::kKStep / 2)) * sizeof(Elem)));
            }
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u) {
              if (s0 + u >= s_end) break;
#pragma unroll
              for (int nt = 0; nt < C::kNTW; ++nt) mma_bf16(acc[mt][nt], a[u], bw[u][nt]);
            }
          }
        }
        // This warp's k share: rows g and g + 8 of each m16 tile, columns
        // 2 tig + {0, 1} of each of its n8 tiles.
        float* rw = red + (size_t)wk * RP * C::kRedStride;
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt) {
          if (mt >= mtiles) break;
#pragma unroll
          for (int nt = 0; nt < C::kNTW; ++nt) {
            float* o = rw + (mt * 16 + g) * C::kRedStride + (wn * C::kNTW + nt) * 8 + 2 * tig;
            *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(o + 8 * C::kRedStride) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      } else {
        // float32 on the CUDA cores, each gate sum formed as the direct
        // route forms it: per unit and 4 rows, a warp's lanes take k = lane
        // + 32 i in order, fused multiply-adds into slot g * 4 + n of 16
        // (slots 12-15 zero), then the warp reduce-scatter of those 16 sums;
        // so the route's float32 results are the direct route's, bit for
        // bit. A warp item is 2 units x 4 rows, k unrolled so that loads
        // overlap.
        const int nbg = (rp + 3) / 4;
        for (int item = warp; item < kU / 2 * nbg; item += kWarps) {
          const int bg = item % nbg, u2 = 2 * (item / nbg);     // units u2, u2 + 1
          const float* hr[4];
#pragma unroll
          for (int n = 0; n < 4; ++n) hr[n] = hs + (size_t)min(bg * 4 + n, rp - 1) * stride;
          float sums[2][16];
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int i = 0; i < 16; ++i) sums[v][i] = 0.0f;
#pragma unroll 4
          for (int k = lane; k < H; k += 32) {
            float wv[2][3];
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
              for (int gi = 0; gi < 3; ++gi)
                wv[v][gi] = wsm[(size_t)(gi * kU + u2 + v) * stride + k];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float hv = hr[n][k];
#pragma unroll
              for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int gi = 0; gi < 3; ++gi)
                  sums[v][gi * 4 + n] = fmaf(wv[v][gi], hv, sums[v][gi * 4 + n]);
            }
          }
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            reduce_scatter(sums[v], lane);          // lane 4 gate + n: row n's gate
            if (lane < 12)
              red[(size_t)(bg * 4 + lane % 4) * C::kRedStride + (lane / 4) * kU + u2 + v] =
                  sums[v][0];
          }
        }
      }
      __syncthreads();                              // every k share of the pass is written

      // Cells of the pass: one lane each.
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < ps * ppp || s >= (ps + 1) * ppp) continue;   // the same for every thread
        const int cell = cell_of[s];
        const bool valid = cell >= 0;
        const int b = valid ? cell / kU : b0, u = valid ? cell % kU : 0;
        const int j = j0 + u;
        float rg = 0.0f, zg = 0.0f, ng = 0.0f, ghnv = 0.0f, h = 0.0f;
        if (valid) {
          const float* rs = red + (size_t)(b - b0 - pr0) * C::kRedStride + u;
          float sr = rs[0], sz = rs[kU], sn = rs[2 * kU];
#pragma unroll
          for (int k = 1; k < C::kShares; ++k) {
            const float* rk = rs + (size_t)k * RP * C::kRedStride;
            sr += rk[0];
            sz += rk[kU];
            sn += rk[2 * kU];
          }
          const float xr = xv[s][0], xz = xv[s][1], xn = xv[s][2];
          // b_hh after the sum, then x_proj, in the direct route's
          // expressions as it compiles them (one fused multiply-add each:
          // xp_n + r gh_n as fma(r, gh_n, xp_n), (1 - z) n + z h_{t-1} as
          // fma(1 - z, n, z h_{t-1})), so that float32 h is the direct
          // route's.
          const float ghr = sr + bias[s][0];
          const float ghz = sz + bias[s][1];
          ghnv = sn + bias[s][2];
          rg = sigmoid_f(xr + ghr);
          zg = sigmoid_f(xz + ghz);
          ng = tanhf(fmaf(rg, ghnv, xn));
          h = fmaf(1.0f - zg, ng, zg * carry[s]);
          carry[s] = h;
        }
        float h_next = 0.0f;                        // bf16: h of unit u + 1, same row
        if constexpr (kBf16) h_next = __shfl_down_sync(0xffffffffu, h, 1);
        if (!valid) continue;
        unsigned long long* word = xch + ((size_t)(t & 1) * B + b) * wrow;
        if constexpr (kBf16) {
          if ((u & 1) == 0) st_word(word + j / 2, __uint_as_float(pack_bf16(h, h_next)), t + 1);
        } else {
          st_word(word + j, h, t + 1);
        }
        const size_t row = (size_t)t * B + b;       // off the critical path
        float* gr = gates + row * G3 + j;
        gr[0] = rg;
        gr[H] = zg;
        gr[2 * H] = ng;
        ghn[row * H + j] = ghnv;
        out[row * H + j] = h;
        if (t == T - 1) hT[(size_t)b * H + j] = h;
      }
    }
  }
}

template <int kBf16, int kU>
cudaError_t launch(const float* xp, const float* w, const float* bhh, const float* h0, float* out,
                   float* gates, float* ghn, float* hT, unsigned long long* xch, int T, int B,
                   int H, int groups, int tiles, cudaStream_t stream) {
  auto kernel = gru_seq_fwd_kernel_mma<kBf16, kU>;
  const size_t smem = smem_bytes<kBf16, kU>(H, tiles);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &w, &bhh, &h0, &out, &gates, &ghn, &hT, &xch,
                  &T,  &B, &H,   &groups, &tiles};
  const dim3 grid(groups * (H / kU)), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
}

// Whether the route serves H, B with U units per block, `groups` batch
// groups and `tiles` m16 tiles per pass: 128 <= H <= 512, H % 128 == 0 (a
// warp's k share is whole k slices, a lane's exchange loads cover a row),
// every group holds rows, and a thread runs at most kSlots cells. (Shared
// memory and SMs are the caller's check.)
bool serves(int H, int B, int U, int groups, int tiles, int bf16) {
  if (H < 128 || H > kMaxHidden || H % 128 || B < 1 || groups < 1 || tiles < 1 ||
      tiles > kMaxTiles || !(U == 4 || U == 8 || U == 16 || (U == 32 && bf16)))
    return false;
  const int rows = (B + groups - 1) / groups;
  const int passes = ((rows + 15) / 16 + tiles - 1) / tiles;
  return (B + rows - 1) / rows == groups && passes * cells_per_pass(U, tiles) <= kSlots;
}

}  // namespace mma_route

// ---------------------------------------------------------------------------
// The "stream" route (stream.cuh): one launch per step, W_hh read from global
// memory, for the widths whose weights do not fit the resident routes. A
// block of kStreamWarps warps takes kStreamWarps units, a warp one unit's
// gate rows.
// ---------------------------------------------------------------------------

constexpr int kStreamWarps = 16;

__global__ void __launch_bounds__(32 * kStreamWarps)
gru_seq_fwd_stream_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                          const float* __restrict__ bhh, const float* __restrict__ h0,
                          float* __restrict__ out, float* __restrict__ gates,
                          float* __restrict__ ghn, float* __restrict__ hT, int t, int T, int B,
                          int H, int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kStreamWarps + (threadIdx.x >> 5), b0 = blockIdx.y * sr::kRows;
  const size_t BH = (size_t)B * H, G = 3 * (size_t)H;
  const float* hp = t > 0 ? out + (t - 1) * BH : h0;
  float acc[3][sr::kRows], s[3];
  sr::lane_sums<3>([=](int b, int k) { return hp[(size_t)b * H + k]; },
                   [=](int g, int k) { return __ldg(w + ((size_t)g * H + j) * H + k); }, 0, H,
                   B, b0, j < H, bf16, xs, acc);
  sr::warp_sums<3>(acc, s, lane);
  const int b = b0 + lane;
  if (j >= H || lane >= sr::kRows || b >= B) return;
  const size_t grow = ((size_t)t * B + b) * G + j, hrow = (size_t)b * H + j;
  const float ghr = s[0] + bhh[j];
  const float ghz = s[1] + bhh[H + j];
  const float ghnv = s[2] + bhh[2 * H + j];
  const float rg = sigmoid_f(xp[grow] + ghr);
  const float zg = sigmoid_f(xp[grow + H] + ghz);
  const float ng = tanhf(xp[grow + 2 * H] + rg * ghnv);
  const float hprev = t > 0 ? out[(t - 1) * BH + hrow] : h0[hrow];
  const float h = (1.0f - zg) * ng + zg * hprev;
  gates[grow] = rg;
  gates[grow + H] = zg;
  gates[grow + 2 * H] = ng;
  ghn[t * BH + hrow] = ghnv;
  out[t * BH + hrow] = h;
  if (t == T - 1) hT[hrow] = h;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t gru_seq_fwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// xp [T, B, 3H] (x @ W_ih^T + b_ih), w [3H, H] (W_hh), bhh [3H], h0 [B, H];
// outputs out and ghn [T, B, H], gates [T, B, 3H] (r, z, n) and hT [B, H].
// All float32, contiguous, on card `device`. bf16 != 0 rounds h and W_hh to
// bf16 as product operands. Launches on `stream`; returns the cudaError_t of
// the launch.
int gru_seq_fwd(const void* xp, const void* w, const void* bhh, const void* h0, void* out,
                void* gates, void* ghn, void* hT, int T, int B, int H, int U, int bf16,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(H, U) * sizeof(float);
  err = cudaFuncSetAttribute(gru_seq_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* pxp = static_cast<const float*>(xp);
  const float* pw = static_cast<const float*>(w);
  const float* pb = static_cast<const float*>(bhh);
  const float* ph0 = static_cast<const float*>(h0);
  float* pout = static_cast<float*>(out);
  float* pgates = static_cast<float*>(gates);
  float* pghn = static_cast<float*>(ghn);
  float* phT = static_cast<float*>(hT);
  void* args[] = {&pxp, &pw, &pb, &ph0, &pout, &pgates, &pghn, &phT,
                  &T,   &B,  &H,  &U,   &bf16};
  const dim3 grid((H + U - 1) / U), block(threads_for(U));
  err = cudaLaunchCooperativeKernel((const void*)gru_seq_fwd_kernel, grid, block, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one mma-route block: hidden size H, U units per
// block, `tiles` m16 tiles per pass.
size_t gru_seq_fwd_mma_smem_bytes(int H, int U, int tiles, int bf16) {
  using namespace mma_route;
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: return smem_bytes<0, 4>(H, tiles);
    case 9: return smem_bytes<1, 4>(H, tiles);
    case 16: return smem_bytes<0, 8>(H, tiles);
    case 17: return smem_bytes<1, 8>(H, tiles);
    case 32: return smem_bytes<0, 16>(H, tiles);
    case 33: return smem_bytes<1, 16>(H, tiles);
    case 65: return smem_bytes<1, 32>(H, tiles);
    default: return 0;
  }
}

// The mma route: the arguments of gru_seq_fwd, then `xch`, the exchange of
// this launch alone (zeroed 8-byte words: 2 * B * H in float32, 2 * B * H / 2
// in bf16), with U units per block (4, 8, 16; 32 in bf16), `groups` batch
// groups (groups * H / U blocks, all resident at once) and `tiles` m16 row
// tiles per pass. Returns the cudaError_t of the launch.
int gru_seq_fwd_mma(const void* xp, const void* w, const void* bhh, const void* h0, void* out,
                    void* gates, void* ghn, void* hT, void* xch, int T, int B, int H, int U,
                    int groups, int tiles, int bf16, int device, void* stream) {
  if (!mma_route::serves(H, B, U, groups, tiles, bf16) || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(xp), static_cast<const float*>(w),
                       static_cast<const float*>(bhh), static_cast<const float*>(h0)};
  float* o[] = {static_cast<float*>(out), static_cast<float*>(gates), static_cast<float*>(ghn),
                static_cast<float*>(hT)};
  unsigned long long* words = static_cast<unsigned long long*>(xch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2VT_GRU_MMA(BF, UU)                                                                    \
  mma_route::launch<BF, UU>(in[0], in[1], in[2], in[3], o[0], o[1], o[2], o[3], words, T, B, H, \
                            groups, tiles, st)
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: err = S2VT_GRU_MMA(0, 4); break;
    case 9: err = S2VT_GRU_MMA(1, 4); break;
    case 16: err = S2VT_GRU_MMA(0, 8); break;
    case 17: err = S2VT_GRU_MMA(1, 8); break;
    case 32: err = S2VT_GRU_MMA(0, 16); break;
    case 33: err = S2VT_GRU_MMA(1, 16); break;
    case 65: err = S2VT_GRU_MMA(1, 32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2VT_GRU_MMA
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stream route: the arguments of gru_seq_fwd without U, for any H and
// B; T launches on `stream`, one per step. Returns the cudaError_t of the
// first call that fails.
int gru_seq_fwd_stream(const void* xp, const void* w, const void* bhh, const void* h0, void* out,
                       void* gates, void* ghn, void* hT, int T, int B, int H, int bf16,
                       int device, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stream_route::smem_bytes(H);
  if ((err = stream_route::allow_smem(gru_seq_fwd_stream_kernel, smem)) != cudaSuccess)
    return (int)err;
  for (int t = 0; t < T; ++t) {
    gru_seq_fwd_stream_kernel<<<stream_route::grid(B, H, kStreamWarps), 32 * kStreamWarps, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xp), static_cast<const float*>(w),
        static_cast<const float*>(bhh), static_cast<const float*>(h0), static_cast<float*>(out),
        static_cast<float*>(gates), static_cast<float*>(ghn), static_cast<float*>(hT), t, T, B,
        H, bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
