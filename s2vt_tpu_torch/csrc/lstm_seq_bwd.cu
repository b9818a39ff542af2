// Per-layer LSTM sequence backward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_rnn.py::_bwd_kernel (launched by _run_backward).
// The reverse sweep of lstm_seq_fwd.cu. With iterations it = 0..T and the
// cell step t = T-1-it:
//
//   dh   = dhT                        (it = 0)
//        = dxp[t + 1] @ W_hh          (it > 0; dh0 when t = -1)
//   dxp[t], dc = cell_bwd(gates[t], c[t], c_prev[t], dh + dout[t], dc)   (t >= 0)
//
// cell_bwd is _cell_bwd of the TPU kernel: float32 math on the stored
// post-activation gates, c and c_prev, with a float32 dc carry (dcT at the
// start, dc0 at the end). Everything read and written is float32; with
// bf16 != 0 the gate gradients and W_hh are rounded to bf16 as operands of
// the product, and dxp is stored unrounded, as the TPU kernel does.
//
// Three routes, chosen by the caller before the launch
// (ops/fused_rnn.py::lstm_seq_bwd_route): "cluster" (below, after the
// direct kernel) for the widths and batches it serves -- H = 512, the MSVD
// width, among them --, "direct" for every other shape whose weights fit its
// blocks' shared memory, and "stream" (last, on stream.cuh: per iteration the
// recurrent products in slices, then the cells, W_hh^T read from global
// memory) for the widths beyond.
//
// "direct" route.
// Design:
//  - One persistent cooperative launch; one grid-wide barrier between
//    iterations (T of them). Block b owns U hidden units j in [U*b, U*b + U)
//    and keeps the columns j of W_hh (4H x U values, float32) resident in
//    shared memory for the whole launch, so it forms dh[:, j] and runs the
//    cell backward for its units by itself. U is 4 or 8, the fewer that keeps
//    one block per SM (lstm_seq_bwd_units_per_block): 4 up to H = 528 on 132
//    SMs, 8 up to 1056 (16 would need more than the 227 KB of shared memory
//    a block can have for any H that 8 does not serve).
//  - The exchange between blocks is the output itself: iteration it + 1
//    reads the dxp row that iteration it wrote, so no ping-pong buffer is
//    needed. Rows are read with __ldcg (L2, not the incoherent L1) straight
//    into registers: each value is used by one thread only, so nothing is
//    staged in shared memory.
//  - Per pass of up to 16 batch rows, thread (row group of 16/U rows,
//    k-slice) reads 16-byte chunks of dxp[t + 1] for its rows and
//    accumulates a (16/U)-row x U-unit register tile against the weight
//    columns (laid out so a warp's float4 reads are contiguous). A warp reduce-scatter leaves the 16
//    sums with lanes 0-15; four warps' partials are summed through shared
//    memory by the thread that runs the cell for that (row, unit).
//  - The dc carry lives in the dc0 output: only the owning thread reads and
//    writes it, and after t = 0 it holds dc0. The cell inputs are loaded
//    before the products so that their loads overlap them.
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, T = 159
// (training), float32:
//  - bytes: gates and dxp ([T, B, 4H] each, 21 MB each), c, c_prev and dout
//    ([T, B, H], 5.2 MB each), W_hh 4 MB: ~62 MB -> ~18 us at 3.35 TB/s;
//  - operations: 2*T*B*4H*H = 5.3 GFLOP -> ~80 us at the 67 TFLOP/s float32
//    peak. The operations set the bound (in bf16, at the tensor-core peak,
//    the bytes).
//  - In practice neither: the floor is the chain of T + 1 dependent
//    iterations, each ending in a grid-wide barrier and starting with a
//    re-read of [B, 4H] gate gradients from L2 in every block.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>

#include "common.cuh"
#include "exchange.cuh"
#include "mma.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowTile = 16;                       // batch rows per pass
constexpr int kThreads = 512;
constexpr int kVals = 16;                          // partial sums per thread: rows x units
constexpr int kUnitChoices[] = {4, 8};            // the instantiated units per block

size_t smem_floats(int H, int U) {
  return (size_t)4 * H * U + (kThreads / 32) * kVals;   // weight columns + partials
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cseq,
                    const float* __restrict__ cprev, const float* __restrict__ w,
                    const float* __restrict__ dout, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, float* dxp, float* dh0, float* dc0, int T,
                    int B, int H, int bf16) {
  constexpr int kRows = kVals / kUnits;            // batch rows per thread
  constexpr int kGroups = kRowTile / kRows;        // row groups per pass
  constexpr int kSlices = kThreads / kGroups;      // k-slices per row group
  constexpr int kWarpsPerGroup = kSlices / 32;
  static_assert(kRows * kUnits == kVals && kUnits % 4 == 0, "float4 weight reads");
  static_assert(kSlices % 32 == 0, "a warp lies inside one row group");
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int nchunk = H;                          // 16-byte chunks (4 floats) per gate row
  float* wsm = smem;                             // [4][nchunk][kUnits]
  float* red = wsm + (size_t)G * kUnits;         // [kThreads / 32][kVals]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kUnits;

  // Resident weight columns: wsm[(q*nchunk + ch)*kUnits + u] = W_hh[ch*4 + q, j0 + u],
  // so that for one q a warp reading consecutive chunks reads consecutive float4s.
  for (int idx = tid; idx < G * kUnits; idx += kThreads) {
    const int u = idx % kUnits;
    const int r = idx / kUnits;                  // gate row g' = ch*4 + q
    const int ch = r / 4, q = r % 4;
    const int j = j0 + u;
    const float v = j < H ? w[(size_t)r * H + j] : 0.0f;
    wsm[((size_t)q * nchunk + ch) * kUnits + u] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const int grp = tid / kSlices, slice = tid % kSlices;
  // The cell this thread runs in each pass (threads below kGroups * kVals):
  // partial index cv = n * kUnits + u of row group cgrp.
  const int cgrp = tid / kVals, cv = tid % kVals;
  const int cn = cv / kUnits, cu = cv % kUnits;
  const int cj = j0 + cu;

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                    // cell step; -1 in the last iteration

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      // Cell inputs first: their loads overlap the products.
      const int cb = b0 + cgrp * kRows + cn;
      const bool cell = tid < kGroups * kVals && cb < B && cj < H;
      const size_t crow = (size_t)cb * H + cj;
      float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, cc = 0.f, cp = 0.f, dh = 0.f, carry = 0.f;
      if (cell && t >= 0) {
        const size_t grow = ((size_t)t * B + cb) * G + cj;
        gi = gates[grow];
        gf = gates[grow + H];
        gg = gates[grow + 2 * H];
        go = gates[grow + 3 * H];
        const size_t trow = (size_t)t * B * H + crow;
        cc = cseq[trow];
        cp = cprev[trow];
        dh = dout[trow];
        carry = it == 0 ? dcT[crow] : dc0[crow];
      }

      float acc[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      if (it > 0) {
        // Rows b0 + grp*kRows + n of dxp[t + 1], as 16-byte chunks.
        const int rb0 = b0 + grp * kRows;
        const float4* p = reinterpret_cast<const float4*>(dxp) + ((size_t)(t + 1) * B + rb0) * nchunk;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int ch = slice; ch < nchunk; ch += kSlices) {
          float4 r[kRows];
#pragma unroll
          for (int n = 0; n < kRows; ++n) r[n] = rb0 + n < B ? __ldcg(p + (size_t)n * nchunk + ch) : zero;
          if (bf16) {
#pragma unroll
            for (int n = 0; n < kRows; ++n) {
              r[n].x = round_bf16(r[n].x);
              r[n].y = round_bf16(r[n].y);
              r[n].z = round_bf16(r[n].z);
              r[n].w = round_bf16(r[n].w);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4* wq = reinterpret_cast<const float4*>(
                wsm + ((size_t)q * nchunk + ch) * kUnits);
#pragma unroll
            for (int u4 = 0; u4 < kUnits / 4; ++u4) {
              const float4 w4 = wq[u4];
#pragma unroll
              for (int n = 0; n < kRows; ++n) {
                const float a = q == 0 ? r[n].x : (q == 1 ? r[n].y : (q == 2 ? r[n].z : r[n].w));
                const int i = n * kUnits + 4 * u4;
                acc[i + 0] = fmaf(a, w4.x, acc[i + 0]);
                acc[i + 1] = fmaf(a, w4.y, acc[i + 1]);
                acc[i + 2] = fmaf(a, w4.z, acc[i + 2]);
                acc[i + 3] = fmaf(a, w4.w, acc[i + 3]);
              }
            }
          }
        }
      }
      reduce_scatter(acc, lane);
      __syncthreads();   // the previous pass's cells have read `red`
      if (lane < kVals) red[warp * kVals + lane] = acc[0];
      __syncthreads();

      if (cell) {
        float dprev = 0.f;   // dh from the step after t
        if (it == 0) {
          dprev = dhT[crow];
        } else {
#pragma unroll
          for (int k = 0; k < kWarpsPerGroup; ++k) dprev += red[(cgrp * kWarpsPerGroup + k) * kVals + cv];
        }
        if (t < 0) {
          dh0[crow] = dprev;
        } else {
          dh += dprev;
          const float tc = tanhf(cc);
          const float dcv = carry + dh * go * (1.0f - tc * tc);
          const size_t grow = ((size_t)t * B + cb) * G + cj;
          dxp[grow] = dcv * gg * gi * (1.0f - gi);
          dxp[grow + H] = dcv * cp * gf * (1.0f - gf);
          dxp[grow + 2 * H] = dcv * gi * (1.0f - gg * gg);
          dxp[grow + 3 * H] = dh * tc * go * (1.0f - go);
          dc0[crow] = dcv * gf;
        }
      }
    }
    if (it < T) grid.sync();
  }
}

template <int kUnits>
cudaError_t launch(const float* gates, const float* cseq, const float* cprev, const float* w,
                   const float* dout, const float* dhT, const float* dcT, float* dxp, float* dh0,
                   float* dc0, int T, int B, int H, int bf16, cudaStream_t stream) {
  const size_t smem = smem_floats(H, kUnits) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_bwd_kernel<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &cseq, &cprev, &w,  &dout, &dhT, &dcT,
                  &dxp,   &dh0,  &dc0,   &T,  &B,    &H,   &bf16};
  const dim3 grid((H + kUnits - 1) / kUnits), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)lstm_seq_bwd_kernel<kUnits>, grid, block, args,
                                     smem, stream);
}

// ---------------------------------------------------------------------------
// "cluster" route. On an H100 the direct route's iteration (4.1 us at B = 16,
// 17.8 at B = 96, float32) goes to the re-read of the whole [B, 4H] exchange
// by every block (an 8x smaller read cuts B = 96 to 10.0 us), the serial
// 16-row passes on the CUDA cores and the grid barrier
// (tools/lstm_bwd_variants.py). This route:
//
//  - Splits the exchange over gate slices and reduces inside thread-block
//    clusters. The grid is P = H / (8 Q) clusters of Q = kQ = 8 blocks (64
//    blocks at H = 512: the H100 holds only 15 co-resident clusters of 8
//    blocks at one block per SM, so each block runs the cells of 8 hidden
//    units, not 4; 16 blocks per cluster measured slower, 4 cannot hold the
//    slice of H = 512). Block q of cluster p owns the gate rows of the unit
//    slice U_q = [q H/Q, (q+1) H/Q) -- 4H/Q rows, in runs of H/Q values per
//    gate -- and forms the partial dh[:, J_p] over them for the cluster's
//    8Q units J_p = {q' H/Q + 8p + i : q' < Q, i < 8}, with W_hh[slice rows,
//    J_p] resident in registers (H/8 values per thread). It pushes each
//    unit's partial into the shared memory of the block that owns the unit
//    (distributed shared memory, 16-byte stores); block (p, q) owns J_p n
//    U_q = {q H/Q + 8p + i}, sums the Q partials of its units in rank order
//    from its own shared memory, runs their cells and writes their 4 gate
//    columns of dxp[t]. (Owners that read the partials from the other
//    blocks after the barrier instead took about 0.5 us more per iteration
//    at B = 16.) A block reads [B, 4H/Q] of the exchange per iteration, 1/Q
//    of what the direct route reads.
//  - Runs every batch row in one pass on the tensor cores. The slice is
//    staged in m16 row tiles, two slots in shared memory. Each warp owns 4
//    n8 column tiles (32 units) and a 1/kWarpsK share of the slice's k
//    range, so that a fragment of the slice, loaded once by ldmatrix, feeds
//    4 independent mma.sync chains; the k shares meet in shared memory (in
//    a fixed order) before the push. bf16: m16n8k16 on bf16 operands.
//    float32: 3xTF32 on m16n8k8 (split_trunc below), each k slice's three
//    products into a fresh partial joined by a round-to-nearest add, since
//    the tensor cores truncate as they accumulate (as conv3x3_bn_relu.cu
//    and argmax_linear.cu do).
//  - Has no grid-wide barrier and no flag. Beside dxp, a cell writes its
//    gate gradients into an exchange buffer xch [2][B][4H] (by step parity)
//    as 8-byte {value, step + 1} words (as NCCL's "LL" protocol does: the tag
//    and the value land together, so no fence is needed), and a block polls
//    the words of its slice until every tag is the step's (a poll that waits
//    kSpinLimitNs of wall time, read from %globaltimer, traps with a
//    message). A flag, set after a fence, would put a fence and one more L2
//    round trip on the critical path of every iteration: the measured flag
//    design took 5.67 us per iteration at B = 16 (PERF.md).
//    The pushed partials are double buffered by step parity, so one
//    hardware cluster barrier (barrier.cluster arrive.release /
//    wait.acquire) per iteration orders them. Each thread stages the next
//    step's cell inputs for its own cells by cp.async, so they arrive during
//    the next poll and take no registers.
//  - Launches cooperatively with cluster dimensions, so that every block
//    is resident at once or the launch fails; the caller checks
//    cudaOccupancyMaxActiveClusters before it chooses the route.
//
// Bounds (chip_smoke.py recomputes them): the direct route's bytes; the
// operations of dgates @ W_hh at the bf16 peak in bf16 and, in float32, as
// three TF32 passes at the TF32 peak.

namespace cluster_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;                        // hidden units whose cells a block runs
constexpr int kNT = 4;                           // n8 column tiles per warp
constexpr int kMaxBatch = 256;
constexpr int kMaxCells = kMaxBatch * kUnits / kThreads;   // cells per thread
constexpr int kMaxHidden = 512;                  // a warp's k range is H / 8
constexpr int kMaxSlice = 256;                   // gate rows of a block's slice, 4H / Q
constexpr int kRowThreads = kThreads / 16;       // threads that stage one row of a tile
constexpr int kMaxPairs = kMaxSlice / 2 / kRowThreads;   // 2-word loads per thread and tile
constexpr int kInputs = 7;                       // cell inputs: gates i f g o, c, c_prev, dout
constexpr size_t kMinSmem = 120 * 1024;          // more than half an SM's: one block per SM
constexpr int kQ = 8;                            // blocks per cluster

template <int kBf16>
struct Tile {
  static constexpr int kN = kUnits * kQ;                      // dh columns of a cluster
  static constexpr int kWarpsN = kN / (8 * kNT);
  static constexpr int kWarpsK = kWarps / kWarpsN;            // k shares
  static constexpr int kKStep = kBf16 ? 16 : 8;               // k per mma.sync
  static constexpr int kMaxSlices = kMaxHidden / 8 / kKStep;  // k slices per warp
  static constexpr int kGroup = kBf16 ? 4 : 2;                // k slices in flight together
  // Staged row stride in floats: float32 fragments come by ldmatrix (8 rows
  // of 16 bytes: a stride of 16 mod 128 bytes puts them on distinct banks),
  // bf16 ones by 8-byte loads (half-warps of 4 rows: 32 mod 128 bytes).
  static constexpr int kPad = kBf16 ? 8 : 4;
  static constexpr int kRedStride = kN + 8;                   // k-share scratch row
  static_assert(kWarpsN * kWarpsK == kWarps, "warps tile the columns and the k range");
  static_assert(kMaxSlices % kGroup == 0, "k slices come in groups");
};

template <int kBf16>
size_t smem_bytes(int H, int B) {
  using C = Tile<kBf16>;
  const size_t tiles = (size_t)2 * 16 * (4 * H / kQ + C::kPad);
  const size_t red = (size_t)2 * C::kWarpsK * 16 * C::kRedStride;
  const size_t recv = (size_t)2 * kQ * ((B + 15) / 16 * 16) * kUnits;
  const size_t cells = (size_t)kInputs * ((B + 31) / 32) * kThreads;
  const size_t bytes = (tiles + red + recv + cells) * sizeof(float);
  return bytes > kMinSmem ? bytes : kMinSmem;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __noinline__ void poll_trap(unsigned long long waited, int step, int row) {
  printf("lstm_seq_bwd cluster route: block %d thread %d polled %llu ns for row %d of "
         "step %d's gate slice; trapping\n", blockIdx.x, threadIdx.x, waited, row, step);
  __trap();
}

template <int kBf16>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_bwd_kernel_cluster(const float* __restrict__ gates, const float* __restrict__ cseq,
                            const float* __restrict__ cprev, const float* __restrict__ w,
                            const float* __restrict__ dout, const float* __restrict__ dhT,
                            const float* __restrict__ dcT, float* __restrict__ dxp,
                            float* __restrict__ dh0, float* __restrict__ dc0,
                            unsigned long long* xch, int T, int B, int H) {
  using C = Tile<kBf16>;
  extern __shared__ __align__(16) float smem_f[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();          // gate slice
  const int p = blockIdx.x / kQ;                    // cluster: the units J_p
  const int G = 4 * H;
  const int span = H / kQ;                          // units of the slice, per gate
  const int K = 4 * span;                           // gate rows of the slice
  const int stride = K + C::kPad;
  const int MT = (B + 15) / 16;
  const int rows = MT * 16;
  const int MC = (B + 31) / 32;                     // cells per thread
  float* tiles = smem_f;                            // [2][16][stride]
  float* red = tiles + 2 * 16 * stride;             // [2][kWarpsK][16][kRedStride]
  float* recv = red + 2 * C::kWarpsK * 16 * C::kRedStride;   // [2][kQ][rows][kUnits]
  float* cin = recv + 2 * kQ * rows * kUnits;       // [kInputs][MC][kThreads]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wn = warp % C::kWarpsN, wk = warp / C::kWarpsN;
  const int kw = K / C::kWarpsK;                    // this warp's k range [wk * kw, + kw)
  const int nslices = kw / C::kKStep;

  // Gate row of slice index k; hidden unit of cluster column n.
  auto row_of = [&](int k) { return (k / span) * H + span * q + k % span; };
  auto unit_of = [&](int n) { return span * (n / kUnits) + kUnits * p + n % kUnits; };

  // Resident W_hh fragments (the .col B operand): float32 bits, split into
  // TF32 halves at each use, or bf16 pairs.
  uint32_t wf[C::kMaxSlices][kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int j = unit_of((wn * kNT + nt) * 8 + g);
#pragma unroll
    for (int s = 0; s < C::kMaxSlices; ++s) {
      wf[s][nt][0] = wf[s][nt][1] = 0u;
      if (s >= nslices) continue;
      const int k0 = wk * kw + s * C::kKStep;
      if constexpr (kBf16) {
        wf[s][nt][0] = pack_bf16(w[(size_t)row_of(k0 + 2 * tig) * H + j],
                                 w[(size_t)row_of(k0 + 2 * tig + 1) * H + j]);
        wf[s][nt][1] = pack_bf16(w[(size_t)row_of(k0 + 2 * tig + 8) * H + j],
                                 w[(size_t)row_of(k0 + 2 * tig + 9) * H + j]);
      } else {
        wf[s][nt][0] = __float_as_uint(w[(size_t)row_of(k0 + tig) * H + j]);
        wf[s][nt][1] = __float_as_uint(w[(size_t)row_of(k0 + tig + 4) * H + j]);
      }
    }
  }

  // Staging of the slice: thread tid stages row tid / 16 of a tile, words
  // 2 s and 2 s + 1 of it for s = tid % 16 + 16 x, from exchange column
  // xcol[x] (-1 past the slice).
  const int srow = tid / kRowThreads;
  int xcol[kMaxPairs];
#pragma unroll
  for (int x = 0; x < kMaxPairs; ++x) {
    const int k = 2 * (tid % kRowThreads + kRowThreads * x);
    xcol[x] = k < K ? (k / span) * H + span * q + k % span : -1;
  }
  unsigned long long v[kMaxPairs][2];
  auto first_load = [&](int step, int mt) {        // first loads of tile mt's words
    const int b = mt * 16 + srow;
    if (b >= B) return;
    const unsigned long long* base = xch + ((size_t)(step & 1) * B + b) * G;
#pragma unroll
    for (int x = 0; x < kMaxPairs; ++x)
      if (xcol[x] >= 0) ld_words(v[x], base + xcol[x]);
  };
  auto land = [&](int step, int mt, int slot) {   // poll until tagged, then into the slot
    const int b = mt * 16 + srow;
    float* dst = tiles + (slot * 16 + srow) * stride;
    if (b < B) {
      const unsigned tag = step + 1;
      const unsigned long long* base = xch + ((size_t)(step & 1) * B + b) * G;
      unsigned long long start = 0;
      for (;;) {
        bool stale = false;
#pragma unroll
        for (int x = 0; x < kMaxPairs; ++x) stale |= xcol[x] >= 0 && !tagged(v[x], tag);
        if (!stale) break;
        const unsigned long long now = global_ns();
        if (start == 0) start = now;
        else if (now - start > kSpinLimitNs) poll_trap(now - start, step, b);
#pragma unroll
        for (int x = 0; x < kMaxPairs; ++x)       // every stale word again, together
          if (xcol[x] >= 0 && !tagged(v[x], tag)) ld_words(v[x], base + xcol[x]);
      }
    }
#pragma unroll
    for (int x = 0; x < kMaxPairs; ++x) {
      if (xcol[x] < 0) continue;
      const int k = 2 * (tid % kRowThreads + kRowThreads * x);
      *reinterpret_cast<float2*>(dst + k) =
          b < B ? make_float2(__uint_as_float((unsigned)v[x][0]), __uint_as_float((unsigned)v[x][1]))
                : make_float2(0.0f, 0.0f);
    }
  };

  // This thread's cells: c = tid + kThreads * m (m < MC) -> batch row c / 8
  // and unit i = c % 8 of the block's units span * q + 8 p + i. Their inputs
  // come by this thread's own cp.async into cin[input][m][tid].
  const int unit0 = span * q + kUnits * p;
  const uint32_t cin_base = (uint32_t)__cvta_generic_to_shared(cin);
  float carry[kMaxCells];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int m = 0; m < kMaxCells; ++m) {
      const int c = tid + kThreads * m, b = c / kUnits;
      if (m >= MC || b >= B) break;
      const int j = unit0 + c % kUnits;
      const size_t grow = ((size_t)t * B + b) * G + j, trow = ((size_t)t * B + b) * H + j;
      const float* from[kInputs] = {gates + grow, gates + grow + H, gates + grow + 2 * H,
                                    gates + grow + 3 * H, cseq + trow, cprev + trow,
                                    dout + trow};
#pragma unroll
      for (int k = 0; k < kInputs; ++k)
        cp_async4(cin_base + (uint32_t)(((k * MC + m) * kThreads + tid) * 4), from[k]);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int m = 0; m < kMaxCells; ++m) {
    const int c = tid + kThreads * m, b = c / kUnits;
    carry[m] = m < MC && b < B ? dcT[(size_t)b * H + unit0 + c % kUnits] : 0.0f;
  }
  prefetch(T - 1);

  cluster_barrier();   // every block of the cluster runs before any pushes into it

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                       // cell step; -1 in the last iteration
    float* recvp = recv + (it & 1) * kQ * rows * kUnits;
    if (it > 0) {
      const int step = t + 1;                       // the step whose gate slice is read
      // The k shares of m tile mt, summed in share order, pushed to the
      // blocks that own their units, 4 columns per 16-byte store: column n
      // goes to rank n / 8.
      auto push = [&](int mt) {
        const float* rs = red + (mt & 1) * C::kWarpsK * 16 * C::kRedStride;
        for (int idx = tid; idx < 16 * C::kN / 4; idx += kThreads) {
          const int r = idx / (C::kN / 4), n = idx % (C::kN / 4) * 4, b = mt * 16 + r;
          if (b >= B) continue;
          float4 s = *reinterpret_cast<const float4*>(rs + r * C::kRedStride + n);
#pragma unroll
          for (int k = 1; k < C::kWarpsK; ++k) {
            const float4 o = *reinterpret_cast<const float4*>(rs + (k * 16 + r) * C::kRedStride + n);
            s.x += o.x;
            s.y += o.y;
            s.z += o.z;
            s.w += o.w;
          }
          float* to = cluster.map_shared_rank(recvp, n / kUnits);
          *reinterpret_cast<float4*>(to + (q * rows + b) * kUnits + n % kUnits) = s;
        }
      };
      first_load(step, 0);
      land(step, 0, 0);
#pragma unroll 1
      for (int mt = 0; mt < MT; ++mt) {
        __syncthreads();       // tile mt is in its slot; tile mt - 1's products and k shares are done
        if (mt > 0) push(mt - 1);

        const int slot = mt & 1;
        const float* As = tiles + slot * 16 * stride;
        const uint32_t as_addr = (uint32_t)__cvta_generic_to_shared(As);
        float acc[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
        for (int s0 = 0; s0 < C::kMaxSlices; s0 += C::kGroup) {
          if (s0 >= nslices) break;
          // kGroup k slices: one fragment of the slice each feeds kNT
          // independent mma.sync chains.
          uint32_t a[C::kGroup][4], a_small[C::kGroup][4];
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u) {
            const int k0 = wk * kw + (s0 + u) * C::kKStep;
            if (s0 + u >= nslices) continue;
            if constexpr (kBf16) {
              const float* hr = As + g * stride + k0 + 2 * tig;
              const float2 v0 = *reinterpret_cast<const float2*>(hr);
              const float2 v1 = *reinterpret_cast<const float2*>(hr + 8 * stride);
              const float2 v2 = *reinterpret_cast<const float2*>(hr + 8);
              const float2 v3 = *reinterpret_cast<const float2*>(hr + 8 * stride + 8);
              a[u][0] = pack_bf16(v0.x, v0.y);
              a[u][1] = pack_bf16(v1.x, v1.y);
              a[u][2] = pack_bf16(v2.x, v2.y);
              a[u][3] = pack_bf16(v3.x, v3.y);
            } else {
              uint32_t r[4];
              ldsm_x4(r, as_addr + (uint32_t)(((lane & 15) * stride + k0 + (lane >> 4) * 4) * 4));
#pragma unroll
              for (int j = 0; j < 4; ++j) split_trunc(__uint_as_float(r[j]), a[u][j], a_small[u][j]);
            }
          }
          float part[C::kGroup][kNT][4];
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) part[u][nt][j] = 0.0f;
          // float32: small*big, then big*small, then big*big into each fresh
          // partial, one round over the group's chains at a time.
#pragma unroll
          for (int pass = 0; pass < (kBf16 ? 1 : 3); ++pass)
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u) {
              if (s0 + u >= nslices) continue;
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                if constexpr (kBf16) {
                  mma_bf16(part[u][nt], a[u], wf[s0 + u][nt]);
                } else {
                  uint32_t big[2], small[2];
                  split_trunc(__uint_as_float(wf[s0 + u][nt][0]), big[0], small[0]);
                  split_trunc(__uint_as_float(wf[s0 + u][nt][1]), big[1], small[1]);
                  if (pass == 0) mma_tf32(part[u][nt], a_small[u], big);
                  else if (pass == 1) mma_tf32(part[u][nt], a[u], small);
                  else mma_tf32(part[u][nt], a[u], big);
                }
              }
            }
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u)       // round-to-nearest adds, in k order
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[nt][j] += part[u][nt][j];
        }
        // This warp's k share of the tile: rows g and g + 8, columns
        // 2 tig + {0, 1} of each of its n8 tiles.
        float* rs = red + ((mt & 1) * C::kWarpsK + wk) * 16 * C::kRedStride;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float* o = rs + g * C::kRedStride + (wn * kNT + nt) * 8 + 2 * tig;
          *reinterpret_cast<float2*>(o) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(o + 8 * C::kRedStride) = make_float2(acc[nt][2], acc[nt][3]);
        }
        if (mt + 1 < MT) {     // loaded after, not during, the products: fewer live registers
          first_load(step, mt + 1);
          land(step, mt + 1, (mt + 1) & 1);
        }
      }
      __syncthreads();                              // the last tile's k shares are written
      push(MT - 1);
      cluster_barrier();                            // every partial of the cluster has arrived
    }

    cp_async_wait<0>();                             // this thread's cell inputs for step t
#pragma unroll
    for (int m = 0; m < kMaxCells; ++m) {
      const int c = tid + kThreads * m, b = c / kUnits, i = c % kUnits;
      if (m >= MC || b >= B) break;
      const int j = unit0 + i;
      float dprev = 0.0f;                           // dh from the step after t
      if (it == 0) {
        dprev = dhT[(size_t)b * H + j];
      } else {
#pragma unroll
        for (int r = 0; r < kQ; ++r) dprev += recvp[(r * rows + b) * kUnits + i];   // rank order
      }
      if (t < 0) {
        dh0[(size_t)b * H + j] = dprev;
        continue;
      }
      const float* ci = cin + m * kThreads + tid;
      const float gi = ci[0], gf = ci[MC * kThreads], gg = ci[2 * MC * kThreads],
                  go = ci[3 * MC * kThreads], cc = ci[4 * MC * kThreads],
                  cp = ci[5 * MC * kThreads], dh = dprev + ci[6 * MC * kThreads];
      const float tc = tanhf(cc);
      const float dcv = carry[m] + dh * go * (1.0f - tc * tc);
      const float d[4] = {dcv * gg * gi * (1.0f - gi), dcv * cp * gf * (1.0f - gf),
                          dcv * gi * (1.0f - gg * gg), dh * tc * go * (1.0f - go)};
      const size_t grow = ((size_t)t * B + b) * G + j;
      unsigned long long* xrow = xch + ((size_t)(t & 1) * B + b) * G + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) st_word(xrow + (size_t)k * H, d[k], (unsigned)t + 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) dxp[grow + (size_t)k * H] = d[k];   // off the critical path
      carry[m] = dcv * gf;
      if (t == 0) dc0[(size_t)b * H + j] = carry[m];
    }
    if (t > 0) prefetch(t - 1);                     // lands during the next poll
  }
  cluster_barrier();   // no block leaves while another may still push into it
}

template <int kBf16>
cudaError_t launch(const float* gates, const float* cseq, const float* cprev, const float* w,
                   const float* dout, const float* dhT, const float* dcT, float* dxp, float* dh0,
                   float* dc0, unsigned long long* xch, int T, int B, int H,
                   cudaStream_t stream) {
  auto kernel = lstm_seq_bwd_kernel_cluster<kBf16>;
  const size_t smem = smem_bytes<kBf16>(H, B);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / kUnits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQ;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, gates, cseq, cprev, w, dout, dhT, dcT, dxp, dh0, dc0,
                            xch, T, B, H);
}

// The clusters of kQ blocks (one per SM) that the card holds at once.
cudaError_t active_clusters(int* clusters) {
  auto kernel = lstm_seq_bwd_kernel_cluster<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMinSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kQ);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMinSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQ;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// Whether the route serves hidden size H and batch B: a warp's k range,
// H / 8 gate rows, is whole k16 slices (H % 128 == 0), and a block's slice,
// 4H / kQ gate rows, fits the staging threads' words.
bool serves(int H, int B) {
  return B >= 1 && B <= kMaxBatch && H >= 128 && H <= kMaxHidden && H % 128 == 0 &&
         H % (kUnits * kQ) == 0 && 4 * H / kQ <= kMaxSlice;
}

}  // namespace cluster_route

// ---------------------------------------------------------------------------
// The "stream" route (stream.cuh): per iteration, the recurrent products in
// kChunk slices of the reduction (a block of kStreamWarps warps takes four
// units per warp and one slice, W_hh^T read from global memory), then the
// cells, one thread per (row, unit); for the widths whose weights do not
// fit the resident routes.
// ---------------------------------------------------------------------------

constexpr int kStreamWarps = 16;
constexpr int kCellThreads = 256;

// part[slice][b][j] = sum over the slice's r of dg[b][r] * W_hh[r][j]: the
// share of slice blockIdx.y of dgates[t + 1] @ W_hh. wt is W_hh^T [H, 4H].
__global__ void __launch_bounds__(32 * kStreamWarps)
lstm_seq_bwd_stream_products(const float* __restrict__ dg, const float* __restrict__ wt,
                             float* __restrict__ part, int B, int H, int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x * kStreamWarps + (threadIdx.x >> 5)) * 4, b0 = blockIdx.z * sr::kRows;
  const int G = 4 * H, r0 = blockIdx.y * sr::kChunk, r1 = min(G, r0 + sr::kChunk);
  float acc[4][sr::kRows], s[4];
  sr::lane_sums<4>(
      [=](int b, int r) { return dg[(size_t)b * G + r]; },
      [=](int u, int r) { return j0 + u < H ? __ldg(wt + (size_t)(j0 + u) * G + r) : 0.0f; },
      r0, r1, B, b0, j0 < H, bf16, xs, acc);
  sr::warp_sums<4>(acc, s, lane);
  const int b = b0 + lane;
  if (lane >= sr::kRows || b >= B) return;
  float* p = part + ((size_t)blockIdx.y * B + b) * H;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (j0 + u < H) p[j0 + u] = s[u];
}

// Iteration t = T-1 .. -1, a thread per (row, unit): dh from the step after
// (dhT at t = T - 1, else the `slices` partial sums, added in order), then
// the cell; at t = -1 only dh0.
__global__ void __launch_bounds__(kCellThreads)
lstm_seq_bwd_stream_cell(const float* __restrict__ gates, const float* __restrict__ cseq,
                         const float* __restrict__ cprev, const float* __restrict__ dout,
                         const float* __restrict__ dhT, const float* __restrict__ dcT,
                         const float* __restrict__ part, float* __restrict__ dxp,
                         float* __restrict__ dh0, float* __restrict__ dc0, int slices, int t,
                         int T, int B, int H) {
  const size_t BH = (size_t)B * H, G = 4 * (size_t)H;
  const size_t hrow = (size_t)blockIdx.x * kCellThreads + threadIdx.x;
  if (hrow >= BH) return;
  const size_t b = hrow / H, j = hrow - b * H;
  float dprev = 0.0f;   // dh from the step after t
  if (t == T - 1) {
    dprev = dhT[hrow];
  } else {
    for (int q = 0; q < slices; ++q) dprev += part[q * BH + hrow];
  }
  if (t < 0) {
    dh0[hrow] = dprev;
    return;
  }
  const float dh = dout[t * BH + hrow] + dprev;
  const float carry = t == T - 1 ? dcT[hrow] : dc0[hrow];   // dc0 holds the carry
  const size_t grow = ((size_t)t * B + b) * G + j;
  const float gi = gates[grow], gf = gates[grow + H], gg = gates[grow + 2 * H],
              go = gates[grow + 3 * H];
  const float cc = cseq[t * BH + hrow], cp = cprev[t * BH + hrow];
  const float tc = tanhf(cc);
  const float dcv = carry + dh * go * (1.0f - tc * tc);
  dxp[grow] = dcv * gg * gi * (1.0f - gi);
  dxp[grow + H] = dcv * cp * gf * (1.0f - gf);
  dxp[grow + 2 * H] = dcv * gi * (1.0f - gg * gg);
  dxp[grow + 3 * H] = dh * tc * go * (1.0f - go);
  dc0[hrow] = dcv * gf;
}

}  // namespace

extern "C" {

// Hidden units each block owns for hidden size H on a card with `sms` SMs:
// the fewest instantiated count that keeps one block per SM, or 0 if none does.
int lstm_seq_bwd_units_per_block(int H, int sms) {
  for (int U : kUnitChoices)
    if ((H + U - 1) / U <= sms) return U;
  return 0;
}

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t lstm_seq_bwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// gates [T, B, 4H] (post-activation), cseq and cprev [T, B, H], w [4H, H]
// (W_hh), dout [T, B, H], dhT and dcT [B, H]; outputs dxp [T, B, 4H], dh0 and
// dc0 [B, H]. All float32, contiguous, on card `device`; U units per block,
// one of lstm_seq_bwd_units_per_block's answers. bf16 != 0 rounds the gate
// gradients and W_hh to bf16 as product operands. Launches on `stream`;
// returns the cudaError_t of the launch.
int lstm_seq_bwd(const void* gates, const void* cseq, const void* cprev, const void* w,
                 const void* dout, const void* dhT, const void* dcT, void* dxp, void* dh0,
                 void* dc0, int T, int B, int H, int U, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(cseq),
                       static_cast<const float*>(cprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT),
                       static_cast<const float*>(dcT)};
  float* pdxp = static_cast<float*>(dxp);
  float* pdh0 = static_cast<float*>(dh0);
  float* pdc0 = static_cast<float*>(dc0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (U) {
    case 4:
      err = launch<4>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], pdxp, pdh0, pdc0, T, B, H,
                      bf16, st);
      break;
    case 8:
      err = launch<8>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], pdxp, pdh0, pdc0, T, B, H,
                      bf16, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether the cluster route serves hidden size H and batch B, given that the
// card holds its H / 64 clusters at once (lstm_seq_bwd_cluster_active).
int lstm_seq_bwd_cluster_serves(int H, int B) { return cluster_route::serves(H, B); }

// Dynamic shared memory of one cluster-route block.
size_t lstm_seq_bwd_cluster_smem_bytes(int H, int B, int bf16) {
  return bf16 ? cluster_route::smem_bytes<1>(H, B) : cluster_route::smem_bytes<0>(H, B);
}

// Into *clusters: how many clusters of the cluster route's blocks card
// `device` holds at once, one block per SM. Returns the cudaError_t.
int lstm_seq_bwd_cluster_active(int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_route::active_clusters(clusters);
}

// The cluster route: the arguments of lstm_seq_bwd, then `xch`, the
// exchange of this launch alone (2 * B * 4H zeroed 8-byte words: the gate
// gradients by step parity), without U; lstm_seq_bwd_cluster_serves(H, B)
// must hold.
int lstm_seq_bwd_cluster(const void* gates, const void* cseq, const void* cprev, const void* w,
                         const void* dout, const void* dhT, const void* dcT, void* dxp, void* dh0,
                         void* dc0, void* xch, int T, int B, int H, int bf16, int device,
                         void* stream) {
  if (!cluster_route::serves(H, B) || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(cseq),
                       static_cast<const float*>(cprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT),
                       static_cast<const float*>(dcT)};
  float* out[] = {static_cast<float*>(dxp), static_cast<float*>(dh0), static_cast<float*>(dc0)};
  unsigned long long* words = static_cast<unsigned long long*>(xch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? cluster_route::launch<1>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
                                        out[1], out[2], words, T, B, H, st)
             : cluster_route::launch<0>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
                                        out[1], out[2], words, T, B, H, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Float32 scratch the stream route needs at batch B and hidden size H:
// W_hh^T, then the partial sums of the reduction's slices.
size_t lstm_seq_bwd_stream_scratch_floats(int B, int H) {
  return (size_t)4 * H * H + (size_t)stream_route::splits(4 * H) * B * H;
}

// The stream route: the arguments of lstm_seq_bwd without U, then `scratch`
// (lstm_seq_bwd_stream_scratch_floats(B, H) floats), for any H and B; a
// transpose, then per iteration the products (but at t = T - 1) and the
// cells, on `stream`. Returns the cudaError_t of the first call that fails.
int lstm_seq_bwd_stream(const void* gates, const void* cseq, const void* cprev, const void* w,
                        const void* dout, const void* dhT, const void* dcT, void* dxp, void* dh0,
                        void* dc0, void* scratch, int T, int B, int H, int bf16, int device,
                        void* stream) {
  namespace sr = stream_route;
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = 4 * H, slices = sr::splits(G);
  float* wt = static_cast<float*>(scratch);
  float* part = wt + (size_t)G * H;
  float* pdxp = static_cast<float*>(dxp);
  if ((err = sr::transpose(static_cast<const float*>(w), wt, G, H, st)) != cudaSuccess)
    return (int)err;
  const size_t smem = sr::smem_bytes(G);
  if ((err = sr::allow_smem(lstm_seq_bwd_stream_products, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((H + 4 * kStreamWarps - 1) / (4 * kStreamWarps), slices,
                  (B + sr::kRows - 1) / sr::kRows);
  const unsigned cells = (unsigned)(((size_t)B * H + kCellThreads - 1) / kCellThreads);
  for (int t = T - 1; t >= -1; --t) {
    if (t < T - 1) {
      lstm_seq_bwd_stream_products<<<grid, 32 * kStreamWarps, smem, st>>>(
          pdxp + (size_t)(t + 1) * B * G, wt, part, B, H, bf16);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    lstm_seq_bwd_stream_cell<<<cells, kCellThreads, 0, st>>>(
        static_cast<const float*>(gates), static_cast<const float*>(cseq),
        static_cast<const float*>(cprev), static_cast<const float*>(dout),
        static_cast<const float*>(dhT), static_cast<const float*>(dcT), part, pdxp,
        static_cast<float*>(dh0), static_cast<float*>(dc0), slices, t, T, B, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
