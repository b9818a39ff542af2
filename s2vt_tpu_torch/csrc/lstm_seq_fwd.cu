// Per-layer LSTM sequence forward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_rnn.py::_fwd_kernel (launched by _run_forward).
// One LSTM layer over T steps:
//
//   gates_t = x_proj_t + h_{t-1} @ W_hh^T      (x_proj_t carries b_ih + b_hh)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c_t = f * c_{t-1} + i * g ;  h_t = o * tanh(c_t)
//
// from (h0, c0), emitting in time order the h sequence, the post-activation
// gates (i, f, g, o) and the c sequence, and the final (hT, cT). Everything
// it reads and writes is float32; with bf16 != 0 the operands of the
// recurrent product (h_{t-1} and W_hh) are rounded to bf16 first, as the TPU
// kernel does, and nothing else is.
//
// Three routes, chosen by the caller before the launch
// (ops/fused_rnn.py::lstm_seq_fwd_route): "mma" (below, after the direct
// kernel: batch groups, the tensor cores, h exchanged as step-tagged words)
// for the widths and batches where it was measured faster -- H = 512 at the
// beam-encode and training batches among them --, "direct" for every other
// shape whose weights fit its blocks' shared memory, and "stream" (last, on
// stream.cuh: one launch per step, W_hh read from global memory) for the
// widths beyond.
//
// "direct" route.
// Design:
//  - One persistent cooperative launch; one grid-wide barrier between steps
//    (T - 1 of them). The grid is ceil(H / U) blocks, one per SM.
//  - Block b owns hidden units j in [b*U, b*U + U). It keeps the four gate
//    rows of W_hh for those units (4*U rows of H values, float32) resident in
//    shared memory for the whole launch, so each cell runs inside its own
//    block and no gate value crosses blocks.
//  - h_{t-1} is read back from the h-sequence output written by all blocks
//    one step earlier (h0 at t = 0), with __ldcg (L2, not the incoherent L1):
//    the output is the exchange buffer, so no ping-pong buffer is needed.
//    c_{t-1} is read back from the c output by the thread that wrote it.
//  - Per batch tile of up to 16 rows: the h tile goes to shared memory
//    (rounded to bf16 first in bf16 mode); each warp takes one (unit, group
//    of 4 rows) item, its 32 lanes split the k range and accumulate a 4-gate
//    x 4-row register tile, and a warp reduce-scatter leaves the 16 sums with
//    lanes 0-15; one thread per (row, unit) then runs the cell.
//  - Products and sums float32 on the CUDA cores.
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, float32:
//  - beam encode, T = 80: x_proj and gates 10.5 MB each, the h and c
//    sequences 2.6 MB each, W_hh 4 MB: ~30 MB -> ~9 us at 3.35 TB/s;
//    2*T*B*4H*H = 2.7 GFLOP -> ~40 us at the 67 TFLOP/s float32 peak. The
//    operations set the bound (in bf16, at the tensor-core peak, the bytes).
//  - In practice neither: the floor is the chain of T dependent steps, each
//    ending in a grid-wide barrier and starting with a re-read of h (B * H
//    floats) from L2 in every block, 16 rows per serial pass
//    (tools/lstm_fwd_variants.py: at B = 96 the passes take 23 of 28.5 us
//    per step). The design keeps everything else off that chain: the
//    weights never leave shared memory and c never leaves the thread that
//    owns it.
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
constexpr int kVals = 4 * kRowBlock;  // sums per item: 4 gates x 4 rows
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

size_t smem_floats(int H, int U) {
  const size_t w = (size_t)4 * U * H;                             // [U][4][H]
  const size_t h = (size_t)kBatchTile * H;                        // [16][H]
  const size_t red = (size_t)U * (kBatchTile / kRowBlock) * kVals;  // item sums
  return w + h + red;
}

int threads_for(int U) {
  const int t = 32 * U * (kBatchTile / kRowBlock);  // one warp per item
  return t < kMaxThreads ? t : kMaxThreads;
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0, float* out,
                    float* gates, float* cseq, float* fin, int T, int B, int H, int U, int bf16) {
  extern __shared__ float smem[];
  float* wsm = smem;                              // [U][4][H]
  float* hsm = wsm + (size_t)4 * U * H;           // [16][H]
  float* red = hsm + (size_t)kBatchTile * H;      // [U * 4][16]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int j0 = blockIdx.x * U;
  const int G = 4 * H;

  // Resident weights: wsm[(u*4 + g)*H + k] = W_hh[g*H + j0 + u, k].
  for (int idx = tid; idx < 4 * U * H; idx += nthr) {
    const int k = idx % H, r = idx / H;
    const int g = r % 4, u = r / 4;
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
        const float* wu = wsm + (size_t)u * 4 * H;
        const float* hr[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) hr[n] = hsm + min(bg * kRowBlock + n, bt - 1) * H;
        float acc[kVals];
#pragma unroll
        for (int i = 0; i < kVals; ++i) acc[i] = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const float w0 = wu[k], w1 = wu[H + k], w2 = wu[2 * H + k], w3 = wu[3 * H + k];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            const float hv = hr[n][k];
            acc[0 * kRowBlock + n] = fmaf(w0, hv, acc[0 * kRowBlock + n]);
            acc[1 * kRowBlock + n] = fmaf(w1, hv, acc[1 * kRowBlock + n]);
            acc[2 * kRowBlock + n] = fmaf(w2, hv, acc[2 * kRowBlock + n]);
            acc[3 * kRowBlock + n] = fmaf(w3, hv, acc[3 * kRowBlock + n]);
          }
        }
        reduce_scatter(acc, lane);
        if (lane < kVals) red[item * kVals + lane] = acc[0];
      }
      __syncthreads();

      // Cells: one thread per (row, unit).
      for (int idx = tid; idx < bt * U; idx += nthr) {
        const int u = idx % U, r = idx / U;
        const int j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        const float* p = red + (size_t)(u * nbg + r / kRowBlock) * kVals + r % kRowBlock;
        const size_t grow = ((size_t)t * B + b) * G + j;
        const float ig = sigmoid_f(xp[grow] + p[0 * kRowBlock]);
        const float fg = sigmoid_f(xp[grow + H] + p[1 * kRowBlock]);
        const float gg = tanhf(xp[grow + 2 * H] + p[2 * kRowBlock]);
        const float og = sigmoid_f(xp[grow + 3 * H] + p[3 * kRowBlock]);
        const size_t crow = (size_t)b * H + j;
        const float cprev = t > 0 ? cseq[(size_t)(t - 1) * B * H + crow] : c0[crow];
        const float c = fg * cprev + ig * gg;
        const float h = og * tanhf(c);
        gates[grow] = ig;
        gates[grow + H] = fg;
        gates[grow + 2 * H] = gg;
        gates[grow + 3 * H] = og;
        cseq[(size_t)t * B * H + crow] = c;
        out[(size_t)t * B * H + crow] = h;
        if (t == T - 1) {
          fin[crow] = h;
          fin[(size_t)B * H + crow] = c;
        }
      }
    }
    if (t + 1 < T) grid.sync();
  }
}


// ---------------------------------------------------------------------------
// "mma" route. On an H100 the direct route's step goes to the re-read of the
// whole h_{t-1} by every block, the serial 16-row tiles on the CUDA cores and
// the grid barrier (tools/lstm_fwd_variants.py). This route:
//
//  - Splits the batch into groups. The grid is G groups of P = H / U blocks
//    (G P <= the card's SMs); block p of group q runs the cells of units
//    [p U, p U + U) for the group's batch rows [q R, q R + R), R = ceil(B/G).
//    Batch rows never meet, so a block reads only its group's rows of
//    h_{t-1}: 1/G of what every block of the direct route reads. At H = 512
//    U = 4 gives 128 blocks and one group, U = 8 64 blocks and up to 2
//    groups, U = 16 up to 4, U = 32 (bf16) up to 8 (ops/fused_rnn.py::
//    mma_plan picks U, G and the row tiles per pass: U = 4 at B = 16, U = 8
//    and two groups of 48 rows at B = 96).
//  - Keeps the block's 4U gate rows of W_hh (row n = 4u + gate) resident in
//    shared memory, in the operand type, for the whole launch, and runs all
//    of the group's rows in one pass (more passes only where the staged
//    rows outgrow shared memory or a thread's 16 pairs).
//  - bf16: the products on the tensor cores, m16n8k16 on bf16 operands.
//    Warps split the 4U columns into n8 tiles and the k range into shares;
//    operands come by ldmatrix, kGroup k slices at a time, so that each
//    warp keeps kGroup x kNTW independent mma.sync chains in flight; the k
//    shares meet in shared memory in a fixed order.
//  - float32: the products on the CUDA cores, each gate sum formed in the
//    direct route's order (per unit and 4 rows, lane-strided k, fused
//    multiply-adds, the warp reduce-scatter), so that the two routes'
//    float32 results are equal bit for bit. As 3xTF32 on the tensor cores
//    (kF32OnCores false: split_tf32, each k slice's three products into a
//    fresh partial joined by a round-to-nearest add, since the tensor cores
//    truncate as they accumulate) the sums are as close to the plain
//    version (4e-7 at B = 16) but rounded otherwise, and on an H100 that
//    flipped one of S2VT.beam's 96 best beams at a tie below float32's
//    resolution, which chip_smoke.py's float32 decode check refuses.
//  - Runs each cell in 4 lanes, one per gate: a lane sums its gate's k
//    shares, adds x_proj and applies the gate's activation; the lanes trade
//    the four gates by shuffles and each keeps c in a register for the whole
//    launch. Where a thread runs several pairs per pass, their x_proj is
//    loaded into registers before the products, so that it lands during
//    them; with one pair per pass (B <= 16 at H = 512) each cell reads its
//    own as it runs: staged one step ahead by cp.async, or loaded before
//    the products, it measured slower there (tools/lstm_fwd_variants.py,
//    variants cp_async, early_xp and late_xp).
//  - Has no grid-wide barrier and no flag. Beside `out`, the gate-0 lane of
//    a cell writes h_t into an exchange buffer xch [2][B][H] (by step
//    parity) as an 8-byte {value, step + 1} word (exchange.cuh); in bf16
//    mode a word carries the bf16 operands of two neighbouring units
//    [2][B][H/2], since the product reads only those, and `out` stays
//    float32. The block's threads poll the words of its group's rows, 16
//    bytes per load, until every tag is the step's, and stage them in
//    shared memory. A poll that waits kSpinLimitNs of wall time traps with
//    a message. The launch is cooperative, so every block is resident at
//    once or the launch fails.
//
// Bounds (chip_smoke.py recomputes them): the direct route's bytes and, in
// float32, its operations at the float32 peak (40 us at B = 16, T = 80);
// in bf16 the operations of h @ W_hh^T at the bf16 peak, so the bytes (9
// us). In practice the chain of T dependent steps: each step's poll waits
// for the slowest block of the group, then the products and the cells run
// before any word of the next step can be written. Block 0's clock cycles
// per step at H = 512, B = 16 (tools/lstm_fwd_variants.py, phase_clock):
// poll 2049, products 3422, cells 2663 in float32; 1838, 1070, 2508 in
// bf16. At B = 96 the float32 products take 20166 of 31808.

namespace mma_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;                       // (cell, gate) pairs per thread per step
constexpr int kMaxTiles = 4;                     // m16 row tiles staged per pass
constexpr int kMaxHidden = 512;                  // a lane's loads per row: H / 64 or H / 128
constexpr int kLoads = 16;                       // 16-byte exchange loads per thread in flight
// Float32 products on the CUDA cores in the direct route's order (else as
// 3xTF32 on the tensor cores; tools/lstm_fwd_variants.py, variant tf32x3).
constexpr bool kF32OnCores = true;

template <int kBf16, int kU>
struct Tile {
  using Elem = typename std::conditional<kBf16 != 0, __nv_bfloat16, float>::type;
  static constexpr int kN = 4 * kU;                          // gate columns of a block
  static constexpr int kNT = kN / 8;                         // n8 tiles
  static constexpr int kNTW = kNT > kWarps ? kNT / kWarps : 1;   // n8 tiles per warp
  static constexpr int kWarpsN = kNT / kNTW;
  static constexpr int kWarpsK = kWarps / kWarpsN;           // k shares
  static constexpr int kKStep = kBf16 ? 16 : 8;              // k per mma.sync
  static constexpr int kPad = kBf16 ? 8 : 4;                 // 16 bytes per staged row
  static constexpr int kRedStride = kN + 4;                  // k-share row, in floats
  static constexpr int kPerLane = kBf16 ? 4 : 8;             // 16-byte loads per lane and row
  static constexpr int kRowsW = kLoads / kPerLane;           // rows per warp per poll chunk
  static constexpr int kGroup = kBf16 ? 2 : 4;               // k slices in flight per warp
  static constexpr bool kTensorCores = kBf16 || !kF32OnCores;  // else float32 FMAs
  static constexpr int kShares = kTensorCores ? kWarpsK : 1;   // k shares of a gate sum
  static_assert(kWarpsN * kWarpsK == kWarps, "warps tile the columns and the k range");
};

template <int kBf16, int kU>
size_t smem_bytes(int H, int tiles) {
  using C = Tile<kBf16, kU>;
  return (size_t)(C::kN + 16 * tiles) * (H + C::kPad) * sizeof(typename C::Elem) +
         (size_t)4 * C::kShares * 16 * tiles * C::kRedStride;
}

// The plan a launch runs: rows per group, m16 tiles per group, passes and
// (cell, gate) slots per thread.
struct Plan {
  int rows, m_tiles, passes, slots;
};
inline Plan plan_of(int B, int U, int groups, int tiles) {
  Plan p;
  p.rows = (B + groups - 1) / groups;
  p.m_tiles = (p.rows + 15) / 16;
  p.passes = (p.m_tiles + tiles - 1) / tiles;
  p.slots = p.passes * tiles * U / 4;
  return p;
}

template <int kBf16>
__device__ __forceinline__ typename Tile<kBf16, 4>::Elem operand(float v) {
  if constexpr (kBf16) return __float2bfloat16_rn(v);
  else return v;
}

__device__ __noinline__ void poll_trap(unsigned long long waited, int step, int row) {
  printf("lstm_seq_fwd mma route: block %d thread %d polled %llu ns for batch row %d of "
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
lstm_seq_fwd_kernel_mma(const float* __restrict__ xp, const float* __restrict__ w,
                        const float* __restrict__ h0, const float* __restrict__ c0,
                        float* __restrict__ out, float* __restrict__ gates,
                        float* __restrict__ cseq, float* __restrict__ fin,
                        unsigned long long* xch, int T, int B, int H, int groups, int tiles) {
  using C = Tile<kBf16, kU>;
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = H + C::kPad;                   // staged row, in elements
  const int RP = 16 * tiles;                        // rows per pass
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw);    // [kN][stride]: row 4u + gate
  Elem* hs = wsm + (size_t)C::kN * stride;          // [RP][stride]
  float* red = reinterpret_cast<float*>(hs + (size_t)RP * stride);   // [kShares][RP][kRedStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int gate = tid & 3;                         // the gate of every pair of this thread
  const int P = gridDim.x / groups;                 // blocks per group
  const int j0 = (blockIdx.x % P) * kU;             // units [j0, j0 + kU)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;              // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int npass = (rows + RP - 1) / RP;
  const int ppp = tiles * kU / 4;                   // slots per pass: RP * 4U / kThreads
  const int G4 = 4 * H;
  const int wrow = kBf16 ? H / 2 : H;               // exchange words per batch row

  // Resident weights: wsm[(4u + gate) * stride + k] = W_hh[gate * H + j0 + u, k].
  for (int idx = tid; idx < C::kN * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H;
    wsm[(size_t)n * stride + k] = operand<kBf16>(w[(size_t)((n & 3) * H + j0 + (n >> 2)) * H + k]);
  }

  // This thread's pairs: slot s of pass ps = s / ppp is pair m * kThreads +
  // tid (m = s % ppp) of the pass: cell m * kThreads / 4 + tid / 4 (row-major
  // over the pass's rows and the block's units), gate tid % 4.
  int cell_of[kSlots];                              // b * kU + u, or -1
  float carry[kSlots];                              // the cell's c
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    cell_of[s] = -1;
    carry[s] = 0.0f;
    const int ps = s / ppp, m = s - ps * ppp;
    if (ps >= npass) continue;
    const int cell = m * (kThreads / 4) + (tid >> 2);
    const int r = cell / kU, u = cell % kU;
    if (r >= min(RP, rows - ps * RP)) continue;
    const int b = b0 + ps * RP + r;
    cell_of[s] = b * kU + u;
    carry[s] = c0[(size_t)b * H + j0 + u];
  }
  const int wn = warp % C::kWarpsN, wk = warp / C::kWarpsN;
  const int per = H / C::kKStep / C::kWarpsK;       // k slices of this warp's share
  const uint32_t w_addr = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t h_addr = (uint32_t)__cvta_generic_to_shared(hs);

  for (int t = 0; t < T; ++t) {
    for (int ps = 0; ps < npass; ++ps) {
      const int pr0 = ps * RP;
      const int rp = min(RP, rows - pr0);
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
      // x_proj of the pass's pairs, where a thread runs several: loaded now,
      // so that it lands during the products. With one pair per pass each
      // cell reads its own as it runs (loaded here, or by cp.async one step
      // ahead, it measured slower at B = 16).
      const bool early_xp = ppp > 1;
      float xv[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        xv[s] = 0.0f;
        if (!early_xp || s < ps * ppp || s >= (ps + 1) * ppp || cell_of[s] < 0) continue;
        const int b = cell_of[s] / kU, u = cell_of[s] % kU;
        xv[s] = xp[((size_t)t * B + b) * G4 + gate * H + j0 + u];
      }

      if constexpr (C::kTensorCores) {
        // Products: this warp's n8 tiles over its k share, every m16 tile of
        // the pass.
        const int mtiles = (rp + 15) / 16;
        float acc[kMaxTiles][C::kNTW][4];
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
        // kGroup k slices at a time: their fragments loaded together, their
        // products in kGroup x kNTW independent chains.
#pragma unroll 1
        for (int s0 = wk * per; s0 < (wk + 1) * per; s0 += C::kGroup) {
          uint32_t bw[C::kGroup][C::kNTW][2];
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
            for (int nt = 0; nt < C::kNTW; ++nt) {
              const int n0 = (wn * C::kNTW + nt) * 8;
              ldsm_x2(bw[u][nt], w_addr + (uint32_t)(((n0 + (lane & 7)) * stride +
                                                      (s0 + u) * C::kKStep +
                                                      ((lane >> 3) & 1) * (C::kKStep / 2)) *
                                                     sizeof(Elem)));
            }
          uint32_t b_big[C::kGroup][C::kNTW][2], b_small[C::kGroup][C::kNTW][2];
          if constexpr (!kBf16) {
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
              for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  split_tf32(__uint_as_float(bw[u][nt][j]), b_big[u][nt][j], b_small[u][nt][j]);
          }
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt) {
            if (mt >= mtiles) break;
            uint32_t a[C::kGroup][4];
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u)
              ldsm_x4(a[u], h_addr + (uint32_t)(((mt * 16 + (lane & 15)) * stride +
                                                 (s0 + u) * C::kKStep +
                                                 (lane >> 4) * (C::kKStep / 2)) * sizeof(Elem)));
            if constexpr (kBf16) {
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt) mma_bf16(acc[mt][nt], a[u], bw[u][nt]);
            } else {
              uint32_t a_big[C::kGroup][4], a_small[C::kGroup][4];
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  split_tf32(__uint_as_float(a[u][j]), a_big[u][j], a_small[u][j]);
              // small*big, big*small, big*big into a fresh partial per k
              // slice, one round over the group's chains at a time.
              float part[C::kGroup][C::kNTW][4];
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
                  for (int j = 0; j < 4; ++j) part[u][nt][j] = 0.0f;
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt)
                  mma_tf32(part[u][nt], a_small[u], b_big[u][nt]);
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt)
                  mma_tf32(part[u][nt], a_big[u], b_small[u][nt]);
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt)
                  mma_tf32(part[u][nt], a_big[u], b_big[u][nt]);
#pragma unroll
              for (int u = 0; u < C::kGroup; ++u)       // round-to-nearest adds, in k order
#pragma unroll
                for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[u][nt][j];
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
        // + 32 i in order, fused multiply-adds into 4 gates x 4 rows, then
        // the warp reduce-scatter of those 16 sums; so the route's float32
        // results are the direct route's, bit for bit. A warp item is 2
        // units x 4 rows (12 shared loads per 32 multiply-adds, where one
        // unit takes 8 per 16), k unrolled so that loads overlap.
        const int nbg = (rp + 3) / 4;
        for (int item = warp; item < kU / 2 * nbg; item += kWarps) {
          const int bg = item % nbg, u2 = 2 * (item / nbg);     // units u2, u2 + 1
          const float* wu = wsm + (size_t)4 * u2 * stride;      // their 8 gate rows
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
            float wv[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) wv[r] = wu[(size_t)r * stride + k];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float hv = hr[n][k];
#pragma unroll
              for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int gi = 0; gi < 4; ++gi)
                  sums[v][gi * 4 + n] = fmaf(wv[v * 4 + gi], hv, sums[v][gi * 4 + n]);
            }
          }
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            reduce_scatter(sums[v], lane);          // lane 4 gate + n: row n's gate
            if (lane < 16)
              red[(size_t)(bg * 4 + lane % 4) * C::kRedStride + 4 * (u2 + v) + lane / 4] =
                  sums[v][0];
          }
        }
      }
      __syncthreads();                              // every k share of the pass is written

      // Cells of the pass: each in 4 lanes, one per gate.
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < ps * ppp || s >= (ps + 1) * ppp) continue;   // the same for every thread
        const int cell = cell_of[s];
        const bool valid = cell >= 0;
        const int b = valid ? cell / kU : b0, u = valid ? cell % kU : 0;
        float pre = 0.0f;
        if (valid) {
          const float* rs = red + (size_t)(b - b0 - pr0) * C::kRedStride + 4 * u + gate;
#pragma unroll
          for (int k = 0; k < C::kShares; ++k) pre += rs[(size_t)k * RP * C::kRedStride];
          pre += early_xp ? xv[s] : xp[((size_t)t * B + b) * G4 + gate * H + j0 + u];
        }
        const float act = gate == 2 ? tanhf(pre) : sigmoid_f(pre);
        const int base = lane & ~3;
        const float ig = __shfl_sync(0xffffffffu, act, base);
        const float fg = __shfl_sync(0xffffffffu, act, base + 1);
        const float gg = __shfl_sync(0xffffffffu, act, base + 2);
        const float og = __shfl_sync(0xffffffffu, act, base + 3);
        // fg * c + ig * gg as the direct route's kernel compiles it (one
        // fused multiply-add), so that float32 c is the direct route's.
        const float c = fmaf(ig, gg, fg * carry[s]);
        const float h = og * tanhf(c);
        carry[s] = c;
        float h_next = 0.0f;                        // bf16: h of unit u + 1, same row
        if constexpr (kBf16) h_next = __shfl_down_sync(0xffffffffu, h, 4);
        if (!valid) continue;
        const int j = j0 + u;
        if (gate == 0) {
          unsigned long long* word = xch + ((size_t)(t & 1) * B + b) * wrow;
          if constexpr (kBf16) {
            if ((u & 1) == 0) st_word(word + j / 2, __uint_as_float(pack_bf16(h, h_next)), t + 1);
          } else {
            st_word(word + j, h, t + 1);
          }
        }
        const size_t row = (size_t)t * B + b;       // off the critical path
        gates[row * G4 + (size_t)gate * H + j] = act;
        if (gate == 0) {
          out[row * H + j] = h;
          cseq[row * H + j] = c;
          if (t == T - 1) {
            fin[(size_t)b * H + j] = h;
            fin[(size_t)B * H + (size_t)b * H + j] = c;
          }
        }
      }
    }
  }
}

template <int kBf16, int kU>
cudaError_t launch(const float* xp, const float* w, const float* h0, const float* c0, float* out,
                   float* gates, float* cseq, float* fin, unsigned long long* xch, int T, int B,
                   int H, int groups, int tiles, cudaStream_t stream) {
  auto kernel = lstm_seq_fwd_kernel_mma<kBf16, kU>;
  const size_t smem = smem_bytes<kBf16, kU>(H, tiles);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &w, &h0, &c0, &out, &gates, &cseq, &fin, &xch,
                  &T,  &B, &H,  &groups, &tiles};
  const dim3 grid(groups * (H / kU)), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
}

// Whether the route serves H, B with U units per block, `groups` batch
// groups and `tiles` m16 tiles per pass: 128 <= H <= 512, H % 128 == 0 (a
// warp's k share is whole k slices), every group holds rows, and a thread
// runs at most kSlots pairs. (Shared memory and SMs are the caller's check.)
bool serves(int H, int B, int U, int groups, int tiles, int bf16) {
  if (H < 128 || H > kMaxHidden || H % 128 || B < 1 || groups < 1 || tiles < 1 ||
      tiles > kMaxTiles || !(U == 4 || U == 8 || U == 16 || (U == 32 && bf16)))
    return false;
  const Plan p = plan_of(B, U, groups, tiles);
  return (B + p.rows - 1) / p.rows == groups && p.slots <= kSlots;
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
lstm_seq_fwd_stream_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                           const float* __restrict__ h0, const float* __restrict__ c0,
                           float* __restrict__ out, float* __restrict__ gates,
                           float* __restrict__ cseq, float* __restrict__ fin, int t, int T,
                           int B, int H, int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kStreamWarps + (threadIdx.x >> 5), b0 = blockIdx.y * sr::kRows;
  const size_t BH = (size_t)B * H, G = 4 * (size_t)H;
  const float* hp = t > 0 ? out + (t - 1) * BH : h0;
  float acc[4][sr::kRows], s[4];
  sr::lane_sums<4>([=](int b, int k) { return hp[(size_t)b * H + k]; },
                   [=](int g, int k) { return __ldg(w + ((size_t)g * H + j) * H + k); }, 0, H,
                   B, b0, j < H, bf16, xs, acc);
  sr::warp_sums<4>(acc, s, lane);
  const int b = b0 + lane;
  if (j >= H || lane >= sr::kRows || b >= B) return;
  const size_t grow = ((size_t)t * B + b) * G + j, hrow = (size_t)b * H + j;
  const float ig = sigmoid_f(xp[grow] + s[0]);
  const float fg = sigmoid_f(xp[grow + H] + s[1]);
  const float gg = tanhf(xp[grow + 2 * H] + s[2]);
  const float og = sigmoid_f(xp[grow + 3 * H] + s[3]);
  const float cp = t > 0 ? cseq[(t - 1) * BH + hrow] : c0[hrow];
  const float c = fg * cp + ig * gg;
  const float h = og * tanhf(c);
  gates[grow] = ig;
  gates[grow + H] = fg;
  gates[grow + 2 * H] = gg;
  gates[grow + 3 * H] = og;
  cseq[t * BH + hrow] = c;
  out[t * BH + hrow] = h;
  if (t == T - 1) {
    fin[hrow] = h;
    fin[BH + hrow] = c;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t lstm_seq_fwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// xp [T, B, 4H], w [4H, H] (W_hh), h0 and c0 [B, H]; outputs
// out and cseq [T, B, H], gates [T, B, 4H] and fin [2, B, H] = (hT, cT). All
// float32, contiguous, on card `device`. bf16 != 0 rounds h and
// W_hh to bf16 as product operands. Launches on `stream`; returns the
// cudaError_t of the launch.
int lstm_seq_fwd(const void* xp, const void* w, const void* h0, const void* c0, void* out,
                 void* gates, void* cseq, void* fin, int T, int B, int H, int U, int bf16,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(H, U) * sizeof(float);
  err = cudaFuncSetAttribute(lstm_seq_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* pxp = static_cast<const float*>(xp);
  const float* pw = static_cast<const float*>(w);
  const float* ph0 = static_cast<const float*>(h0);
  const float* pc0 = static_cast<const float*>(c0);
  float* pout = static_cast<float*>(out);
  float* pgates = static_cast<float*>(gates);
  float* pcseq = static_cast<float*>(cseq);
  float* pfin = static_cast<float*>(fin);
  void* args[] = {&pxp, &pw, &ph0, &pc0, &pout, &pgates, &pcseq, &pfin,
                  &T,   &B,  &H,   &U,   &bf16};
  const dim3 grid((H + U - 1) / U), block(threads_for(U));
  err = cudaLaunchCooperativeKernel((const void*)lstm_seq_fwd_kernel, grid, block, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one mma-route block: hidden size H, U units per
// block, `tiles` m16 tiles per pass.
size_t lstm_seq_fwd_mma_smem_bytes(int H, int U, int tiles, int bf16) {
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

// The mma route: the arguments of lstm_seq_fwd, then `xch`, the exchange of
// this launch alone (zeroed 8-byte words: 2 * B * H in float32, 2 * B * H / 2
// in bf16), with U units per block (4, 8, 16; 32 in bf16), `groups` batch
// groups (groups * H / U blocks, all resident at once) and `tiles` m16 row
// tiles per pass. Returns the cudaError_t of the launch.
int lstm_seq_fwd_mma(const void* xp, const void* w, const void* h0, const void* c0, void* out,
                     void* gates, void* cseq, void* fin, void* xch, int T, int B, int H, int U,
                     int groups, int tiles, int bf16, int device, void* stream) {
  if (!mma_route::serves(H, B, U, groups, tiles, bf16) || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(xp), static_cast<const float*>(w),
                       static_cast<const float*>(h0), static_cast<const float*>(c0)};
  float* o[] = {static_cast<float*>(out), static_cast<float*>(gates), static_cast<float*>(cseq),
                static_cast<float*>(fin)};
  unsigned long long* words = static_cast<unsigned long long*>(xch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2VT_FWD_MMA(BF, UU)                                                                    \
  mma_route::launch<BF, UU>(in[0], in[1], in[2], in[3], o[0], o[1], o[2], o[3], words, T, B, H, \
                            groups, tiles, st)
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: err = S2VT_FWD_MMA(0, 4); break;
    case 9: err = S2VT_FWD_MMA(1, 4); break;
    case 16: err = S2VT_FWD_MMA(0, 8); break;
    case 17: err = S2VT_FWD_MMA(1, 8); break;
    case 32: err = S2VT_FWD_MMA(0, 16); break;
    case 33: err = S2VT_FWD_MMA(1, 16); break;
    case 65: err = S2VT_FWD_MMA(1, 32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2VT_FWD_MMA
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stream route: the arguments of lstm_seq_fwd without U, for any H and
// B; T launches on `stream`, one per step. Returns the cudaError_t of the
// first call that fails.
int lstm_seq_fwd_stream(const void* xp, const void* w, const void* h0, const void* c0, void* out,
                        void* gates, void* cseq, void* fin, int T, int B, int H, int bf16,
                        int device, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stream_route::smem_bytes(H);
  if ((err = stream_route::allow_smem(lstm_seq_fwd_stream_kernel, smem)) != cudaSuccess)
    return (int)err;
  for (int t = 0; t < T; ++t) {
    lstm_seq_fwd_stream_kernel<<<stream_route::grid(B, H, kStreamWarps), 32 * kStreamWarps,
                                 smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xp), static_cast<const float*>(w),
        static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<float*>(out),
        static_cast<float*>(gates), static_cast<float*>(cseq), static_cast<float*>(fin), t, T, B,
        H, bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
