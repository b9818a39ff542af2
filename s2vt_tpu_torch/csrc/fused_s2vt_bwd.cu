// Fused dual-LSTM S2VT backward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_s2vt.py::_bwd_kernel (launched by _run_bwd).
// The reverse sweep of fused_s2vt_fwd.cu keeps its one-step skew. With
// iterations it = 0..T and the previous iteration's gate gradients
// dg1' = dxp1[T - it + 1], dg2' = dxp2[T - it] (zero where out of range):
//
//   dh1 = dg1' @ W1hh + dg2' @ W2v          dh2 = dg2' @ W2hh
//   layer 2, step t2 = T-1-it (it <  T): dxp2[t2] = cell_bwd(g2, c2, dh2 + dout2[t2])
//   layer 1, step t1 = T-it   (it >= 1): dxp1[t1] = cell_bwd(g1, c1, dh1)
//
// cell_bwd is _cell_bwd of the TPU kernel: float32 math on the stored
// post-activation gates, c and c_prev (zero at t = 0), with a float32 dc carry
// per layer. dxp1/dxp2 come out in time order and in the I/O type.
//
// Two routes, chosen by the caller before the launch
// (ops/fused_s2vt.py::fused_s2vt_bwd_route): "mma" (below, after the direct
// kernel: thread-block clusters that split the k range of the products, the
// gate gradients exchanged as step-tagged words, bf16 on the tensor cores)
// for the bf16 widths and batches where it was measured faster, and "direct"
// for every other shape, every float32 one included.
//
// "direct" route.
// Design:
//  - One persistent cooperative launch; one grid-wide barrier per iteration
//    (T + 1 of them). Block b owns hidden units j in [4b, 4b + 4) and keeps
//    the columns j of W1hh, W2v and W2hh (12*4*H values, as float32) resident
//    in shared memory for the whole launch, so it forms dh1[:, j] and
//    dh2[:, j] and runs both cell backwards for its units by itself.
//  - The exchange between blocks is the output itself: the gate gradients of
//    iteration it are dxp1[t1] and dxp2[t2], stored in the I/O type, which is
//    exactly the value the TPU kernel rounds them to before its products (bf16
//    in bf16 mode, float32 otherwise). Iteration it + 1 reads those rows and
//    writes other rows, so no ping-pong buffer is needed and the bf16
//    exchange moves half the bytes. Rows are read with __ldcg (L2, not the
//    incoherent L1) straight into registers: each value is used by one
//    thread only, so nothing is staged in shared memory.
//  - Per pass of up to 16 batch rows, thread (row group of 4 rows, k-slice)
//    reads 16-byte chunks of dg1' and dg2' for its 4 rows and accumulates a
//    4-row x 4-unit x 2-layer register tile against the weight columns
//    (laid out so a warp's float4 reads are contiguous). A warp
//    reduce-scatter (31 shuffles) leaves lane l with partial l of the tile;
//    four warps' partials are summed through shared memory by the thread that
//    runs the cell for that (layer, row, unit).
//  - The dc carries live in a float32 scratch [2][B][H] that only the owning
//    thread touches; the cell inputs are loaded before the products.
//
// Bounds on an H100 SXM at the MSVD width (H = 512, T = 159), B = 16:
//  - bytes: g1, g2, dxp1, dxp2 ([T, B, 4H] each), c1, c2, dout2 ([T, B, H]
//    float32) and the three [4H, H] weights: ~58 MB in bf16, ~106 MB in
//    float32 -> 17-32 us at 3.35 TB/s.
//  - operations: 2*T*B*12*H^2 = 16 GFLOP -> 16 us at the bf16 tensor-core
//    peak, 240 us at the float32 peak. f32 is bound by operations, bf16 by
//    bytes.
//  - In practice neither: as in the forward, the floor is the chain of T + 1
//    dependent grid-wide barriers, each followed by a re-read of [B, 8H]
//    gate gradients from L2 in every block. The CUDA-core tile keeps the
//    shared-memory weight reads at one float4 per four rows, so an
//    iteration's products take ~2 us at B = 16.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "exchange.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;                          // hidden units per block
constexpr int kRows = 4;                           // batch rows per thread
constexpr int kRowTile = 16;                       // batch rows per pass
constexpr int kThreads = 512;
constexpr int kGroups = kRowTile / kRows;          // row groups per pass
constexpr int kSlices = kThreads / kGroups;        // k-slices per row group
constexpr int kWarpsPerGroup = kSlices / 32;
constexpr int kVals = 2 * kRows * kUnits;          // partial sums per thread
static_assert(kVals == 32, "one partial per lane after the reduce-scatter");
static_assert(kSlices % 32 == 0, "a warp lies inside one row group");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Values of the I/O type in one 16-byte chunk.
template <typename T>
__host__ __device__ constexpr int chunk_vals() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

// Value q of a 16-byte chunk, widened to float32 (exact for bf16).
template <typename T>
__device__ __forceinline__ float chunk_val(const uint4& r, int q) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, q));
  } else {
    const uint32_t w = word(r, q >> 1);
    return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

size_t smem_floats(int H) {
  return (size_t)3 * 4 * H * kUnits + kThreads;   // weight columns + partials
}

template <typename TIO>
__global__ void __launch_bounds__(kThreads, 1)
s2vt_fused_bwd_kernel(const TIO* __restrict__ g1, const float* __restrict__ c1,
                      const TIO* __restrict__ g2, const float* __restrict__ c2,
                      const float* __restrict__ dout2, const TIO* __restrict__ w1hh,
                      const TIO* __restrict__ w2v, const TIO* __restrict__ w2hh, TIO* dxp1,
                      TIO* dxp2, float* dc, int T, int B, int H) {
  constexpr int V = chunk_vals<TIO>();
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int nchunk = G / V;                      // 16-byte chunks per gate row
  float* wsm = smem;                             // [3][V][nchunk][kUnits]
  float* red = wsm + (size_t)3 * G * kUnits;     // [kThreads / 32][32]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kUnits;

  // Resident weight columns: wsm[((m*V + q)*nchunk + ch)*kUnits + u] =
  // W_m[ch*V + q, j0 + u], so that for one (m, q) a warp reading consecutive
  // chunks reads consecutive float4s.
  for (int idx = tid; idx < 3 * G * kUnits; idx += kThreads) {
    const int u = idx % kUnits;
    int r = idx / kUnits;
    const int ch = r % nchunk;
    r /= nchunk;
    const int q = r % V, m = r / V;
    const int j = j0 + u;
    const TIO* W = m == 0 ? w1hh : (m == 1 ? w2v : w2hh);
    wsm[idx] = j < H ? to_f(W[(size_t)(ch * V + q) * H + j]) : 0.0f;
  }
  __syncthreads();

  const int grp = tid / kSlices, slice = tid % kSlices;
  // The cell this thread runs in each pass (threads below kGroups * 32):
  // partial index cv = (layer * kRows + n) * kUnits + u of row group cgrp.
  const int cgrp = tid / 32, cv = tid % 32;
  const int clayer = cv / (kRows * kUnits), cn = (cv / kUnits) % kRows, cu = cv % kUnits;
  const int cj = j0 + cu;

  for (int it = 0; it <= T; ++it) {
    const int t1 = T - it, t2 = T - 1 - it;
    const bool has1 = t1 + 1 < T, has2 = t2 + 1 < T;   // dg1', dg2' exist
    const int step = clayer == 0 ? t1 : t2;
    const TIO* gseq = clayer == 0 ? g1 : g2;
    const float* cseq = clayer == 0 ? c1 : c2;
    TIO* dseq = clayer == 0 ? dxp1 : dxp2;

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      // Cell inputs first: their loads overlap the products.
      const int cb = b0 + cgrp * kRows + cn;
      const bool cell = tid < kGroups * 32 && cb < B && cj < H && step >= 0 && step < T;
      float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, cc = 0.f, cp = 0.f, dout = 0.f, carry = 0.f;
      if (cell) {
        const size_t grow = ((size_t)step * B + cb) * G + cj;
        gi = to_f(gseq[grow]);
        gf = to_f(gseq[grow + H]);
        gg = to_f(gseq[grow + 2 * H]);
        go = to_f(gseq[grow + 3 * H]);
        const size_t crow = (size_t)cb * H + cj;
        cc = cseq[(size_t)step * B * H + crow];
        cp = step > 0 ? cseq[(size_t)(step - 1) * B * H + crow] : 0.f;
        if (clayer == 1) dout = dout2[(size_t)step * B * H + crow];
        carry = dc[(size_t)clayer * B * H + crow];
      }

      float acc[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      if (has1 || has2) {
        // Rows b0 + grp*kRows + n of dg1' and dg2', as 16-byte chunks.
        const int rb0 = b0 + grp * kRows;
        const size_t rstride = (size_t)nchunk;
        const uint4* p1 = reinterpret_cast<const uint4*>(dxp1) + ((size_t)(t1 + 1) * B + rb0) * rstride;
        const uint4* p2 = reinterpret_cast<const uint4*>(dxp2) + ((size_t)(t2 + 1) * B + rb0) * rstride;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int ch = slice; ch < nchunk; ch += kSlices) {
          uint4 r1[kRows], r2[kRows];
#pragma unroll
          for (int n = 0; n < kRows; ++n) {
            const bool rok = rb0 + n < B;
            r1[n] = has1 && rok ? __ldcg(p1 + n * rstride + ch) : zero;
            r2[n] = has2 && rok ? __ldcg(p2 + n * rstride + ch) : zero;
          }
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const float* wq = wsm + ((size_t)q * nchunk + ch) * kUnits;
            const size_t mstride = (size_t)V * nchunk * kUnits;
            const float4 wa = *reinterpret_cast<const float4*>(wq);                // W1hh
            const float4 wb = *reinterpret_cast<const float4*>(wq + mstride);      // W2v
            const float4 wc = *reinterpret_cast<const float4*>(wq + 2 * mstride);  // W2hh
#pragma unroll
            for (int n = 0; n < kRows; ++n) {
              const float a = chunk_val<TIO>(r1[n], q), b = chunk_val<TIO>(r2[n], q);
              const int d1 = n * kUnits, d2 = (kRows + n) * kUnits;   // dh1, dh2 partials
              acc[d1 + 0] = fmaf(b, wb.x, fmaf(a, wa.x, acc[d1 + 0]));
              acc[d1 + 1] = fmaf(b, wb.y, fmaf(a, wa.y, acc[d1 + 1]));
              acc[d1 + 2] = fmaf(b, wb.z, fmaf(a, wa.z, acc[d1 + 2]));
              acc[d1 + 3] = fmaf(b, wb.w, fmaf(a, wa.w, acc[d1 + 3]));
              acc[d2 + 0] = fmaf(b, wc.x, acc[d2 + 0]);
              acc[d2 + 1] = fmaf(b, wc.y, acc[d2 + 1]);
              acc[d2 + 2] = fmaf(b, wc.z, acc[d2 + 2]);
              acc[d2 + 3] = fmaf(b, wc.w, acc[d2 + 3]);
            }
          }
        }
      }
      reduce_scatter(acc, lane);
      __syncthreads();   // the previous pass's cells have read `red`
      red[warp * 32 + lane] = acc[0];
      __syncthreads();

      if (cell) {
        float dh = dout;
#pragma unroll
        for (int k = 0; k < kWarpsPerGroup; ++k) dh += red[(cgrp * kWarpsPerGroup + k) * 32 + cv];
        const float tc = tanhf(cc);
        const float dcv = carry + dh * go * (1.0f - tc * tc);
        const float di = dcv * gg * gi * (1.0f - gi);
        const float df = dcv * cp * gf * (1.0f - gf);
        const float dg = dcv * gi * (1.0f - gg * gg);
        const float dov = dh * tc * go * (1.0f - go);
        const size_t grow = ((size_t)step * B + cb) * G + cj;
        dseq[grow] = from_f<TIO>(di);
        dseq[grow + H] = from_f<TIO>(df);
        dseq[grow + 2 * H] = from_f<TIO>(dg);
        dseq[grow + 3 * H] = from_f<TIO>(dov);
        dc[(size_t)clayer * B * H + (size_t)cb * H + cj] = dcv * gf;
      }
    }
    grid.sync();
  }
}

template <typename TIO>
cudaError_t launch(const void* g1, const void* c1, const void* g2, const void* c2,
                   const void* dout2, const void* w1hh, const void* w2v, const void* w2hh,
                   void* dxp1, void* dxp2, void* dc, int T, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_floats(H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(s2vt_fused_bwd_kernel<TIO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TIO* pg1 = static_cast<const TIO*>(g1);
  const float* pc1 = static_cast<const float*>(c1);
  const TIO* pg2 = static_cast<const TIO*>(g2);
  const float* pc2 = static_cast<const float*>(c2);
  const float* pdout2 = static_cast<const float*>(dout2);
  const TIO* pw1hh = static_cast<const TIO*>(w1hh);
  const TIO* pw2v = static_cast<const TIO*>(w2v);
  const TIO* pw2hh = static_cast<const TIO*>(w2hh);
  TIO* pdxp1 = static_cast<TIO*>(dxp1);
  TIO* pdxp2 = static_cast<TIO*>(dxp2);
  float* pdc = static_cast<float*>(dc);
  void* args[] = {&pg1, &pc1, &pg2,   &pc2,   &pdout2, &pw1hh, &pw2v, &pw2hh,
                  &pdxp1, &pdxp2, &pdc, &T, &B, &H};
  const dim3 grid((H + kUnits - 1) / kUnits), block(kThreads);
  err = cudaLaunchCooperativeKernel((const void*)s2vt_fused_bwd_kernel<TIO>, grid, block, args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma" route, bf16 only. Replaces the same TPU kernel
// (pallas_s2vt.py::_bwd_kernel) for the shapes
// ops/fused_s2vt.py::fused_s2vt_bwd_route sends here. On an H100 the direct
// route's iteration goes to the grid barrier and to every block's re-read of
// the whole [B, 8H] operand [dg1' | dg2'] from L2 (128 blocks x 128 KiB per
// iteration at B = 16 in bf16), then to the products and the operands'
// widening on the CUDA cores in serial 16-row passes. This route cuts the
// bytes each block reads:
//
//  - Splits the batch into groups and the k range of the products over the
//    blocks of a thread-block cluster. The grid is G groups of P = H / U
//    blocks (G P <= the card's SMs), in clusters of C consecutive blocks
//    (C in 2, 4). Block p of group q runs the cells of units [p U, p U + U)
//    of both layers for the group's batch rows [q R, q R + R), R =
//    ceil(B / G). Rank c of a cluster forms, for all C U units of its
//    cluster, the partial products over its share of k ([c Kh, c Kh + Kh)
//    of the 4H values of dg1', Kh = 4H / C, and the same share of dg2'),
//    and pushes each unit's partial into the shared memory of the block
//    that owns the unit (distributed shared memory, 16-byte stores); one
//    hardware cluster barrier per pass (barrier.cluster arrive.release /
//    wait.acquire) orders the pushes, and the partials are double-buffered
//    by pass parity. A block so reads R x 8H / C operand values per
//    iteration: the card reads (H / U) B 8H / C, U C / 4 times fewer values
//    than the direct route. ops/fused_s2vt.py::fused_bwd_plan picks C, G
//    and the rows per pass from the card's SMs, shared memory and
//    co-resident clusters; U = 8 is the one layout instantiated. An H100
//    holds only 30 clusters of 4 blocks, so the route runs clusters of 4 (64
//    blocks) up to B = 32, then clusters of 2 in two groups, 16 rows per
//    pass.
//  - Keeps the block's weights for its cluster's units and its k share
//    resident in shared memory in bf16 for the whole launch: 12 H U values.
//  - Has no grid-wide barrier and no flag. A cell writes its four gate
//    gradients into an exchange buffer xch [2][B][4H] (by iteration parity)
//    as 8-byte {value, iteration + 1} words (exchange.cuh), each carrying
//    the bf16 values of two neighbouring units. The word goes out before the
//    stores of dxp1 and dxp2, which are off the chain. Iteration 0 writes its
//    layer-1 words as zeros, tagged 1, since layer 1 idles there and every
//    word a reader polls for must carry its tag; no iteration reads
//    iteration T's words. Before iteration it >= 1 a block polls the words
//    of its k share for its pass's rows, 16 bytes per load, 16 loads per
//    thread in flight, until every tag is it, and stages the values in
//    shared memory; a poll that waits kSpinLimitNs of wall time traps with a
//    message. The launch is cooperative with cluster dimensions, so every
//    block is resident at once or the launch fails.
//  - The products on the tensor cores, m16n8k16 on bf16 operands with
//    float32 accumulation. A warp takes 16 units' dh1 and dh2 column tiles
//    over a share of the block's k16 slices, two slices' fragments loaded
//    together, with three accumulators per tile (W1hh over dg1', W2v over
//    dg2', W2hh over dg2': six independent mma.sync chains per warp; dh1 is
//    the first two added); the warps' shares meet in shared memory (over the
//    staged rows) in a fixed order before the push, and a cell adds its dout
//    and the C ranks' partials in rank order.
//  - Runs each cell in one lane, in the direct kernel's expressions: the
//    cell's inputs (g, c, c_prev, dout2) are copied into shared memory by
//    cp.async before the poll, so that they land while the block waits and
//    hold no registers (loaded into registers there, they cost more than
//    they saved); its float32 dc carry stays in one shared-memory word per
//    (cell slot, thread) for the whole launch. The slot loops stay rolled:
//    unrolled over 4 slots the kernel took 4.0K machine instructions and an
//    iteration at B = 16 6.2 us, rolled 2.7K and 5.1 us.
//
// float32 stays on the direct route at every batch: a float32 form of this
// route (U = 4 in clusters of 2, its products on the CUDA cores in the direct
// route's order) was slower than the direct route above B = 4, where training
// runs (PERF.md).
//
// Bounds (chip_smoke.py recomputes them): the direct route's. In practice
// the chain of T + 1 dependent iterations: each poll waits for the slowest
// block of the group, then the products, the pushes, the cluster barrier and
// the cells run before any word of the next iteration can be written
// (tools/fused_bwd_variants.py times each piece; PERF.md has the numbers).

namespace mma_route {

using Elem = __nv_bfloat16;
constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                        // cells per thread per pass
constexpr int kMaxRows = 48;                     // batch rows per pass
constexpr int kMaxTiles = kMaxRows / 16;         // m16 row tiles per pass
constexpr int kMaxHidden = 512;                  // the widest layout the route is checked at
constexpr int kLoads = 16;                       // 16-byte exchange loads per thread in flight
constexpr int kMaxCluster = 4;                   // blocks per cluster, sources of a cell's sums
constexpr int kInputs = 7;                       // a cell's inputs: i, f, g, o, c, c_prev, dout2
constexpr int kPad = 8;                          // staged row pad, elements (16 bytes)
constexpr int kVals = 4;                         // operand values per 16-byte exchange load
constexpr int kWordVals = 2;                     // operand values per exchange word
// One block per SM: at least this much dynamic shared memory per block.
constexpr size_t kMinSmem = (size_t)120 * 1024;

// Warps: warps_n column groups of 16 units (of the cluster's C U) x the rest
// k shares.
__host__ __device__ __forceinline__ int warps_n(int CU) { return CU >= 32 ? CU / 16 : 1; }

__host__ __device__ __forceinline__ int cells_per_pass(int U, int rp) {
  return (2 * rp * U + kThreads - 1) / kThreads;
}

// Dynamic shared memory, in this order: the resident weights; the staged
// operand rows of a pass (the warps' k shares of the sums laid over them
// once the products are done); the pushed partials [2 parities][C ranks][rp]
// [2 layers][U]; the dc carries, one word per (cell slot, thread) for the
// `passes` passes; the inputs of a pass's cells, [kInputs][cell slot]
// [thread] words. At least kMinSmem.
__host__ __device__ size_t smem_bytes(int H, int U, int C, int rp, int passes) {
  const size_t es = sizeof(Elem);
  const size_t Kh = (size_t)4 * H / C, CU = (size_t)C * U;
  const size_t w = CU * (2 * Kh + kPad) * es + CU * (Kh + kPad) * es;
  size_t staged = (size_t)rp * (2 * Kh + kPad) * es;
  const size_t shares = (size_t)4 * (kWarps / warps_n((int)CU)) * rp * (2 * CU + 4);
  if (shares > staged) staged = shares;
  const size_t rcv = (size_t)4 * 2 * C * rp * U * 2;
  const size_t carry = (size_t)4 * passes * cells_per_pass(U, rp) * kThreads;
  const size_t inputs = (size_t)4 * kInputs * cells_per_pass(U, rp) * kThreads;
  const size_t total = w + staged + rcv + carry + inputs;
  return total > kMinSmem ? total : kMinSmem;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The direct kernel's cell backward: the four gate gradients of (layer, row,
// unit) into d; returns the carry dc * f for the step before.
__device__ __forceinline__ float cell_bwd(float gi, float gf, float gg, float go, float cc,
                                          float cp, float dh, float carry, float (&d)[4]) {
  const float tc = tanhf(cc);
  const float dcv = carry + dh * go * (1.0f - tc * tc);
  d[0] = dcv * gg * gi * (1.0f - gi);
  d[1] = dcv * cp * gf * (1.0f - gf);
  d[2] = dcv * gi * (1.0f - gg * gg);
  d[3] = dh * tc * go * (1.0f - go);
  return dcv * gf;
}

template <int kU>
__global__ void __launch_bounds__(kThreads, 1)
s2vt_fused_bwd_kernel_mma(const Elem* __restrict__ g1, const float* __restrict__ c1,
                          const Elem* __restrict__ g2, const float* __restrict__ c2,
                          const float* __restrict__ dout2, const Elem* __restrict__ w1hh,
                          const Elem* __restrict__ w2v, const Elem* __restrict__ w2hh,
                          Elem* __restrict__ dxp1, Elem* __restrict__ dxp2,
                          unsigned long long* xch, int T, int B, int H, int groups, int RP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int G4 = 4 * H;
  const int Kh = G4 / C;                            // this rank's k share of each half
  const int CU = C * kU;                            // the cluster's units
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = gridDim.x / groups;                 // blocks per group
  const int p = blockIdx.x % P;
  const int j0 = p * kU;                            // owned units [j0, j0 + kU)
  const int cj0 = (p - c) * kU;                     // the cluster's units [cj0, cj0 + CU)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;              // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int npass = (rows + RP - 1) / RP;
  const int spp = cells_per_pass(kU, RP);
  const int wrow = G4 * 2 / kWordVals;              // exchange words per batch row
  const int sstride = 2 * Kh + kPad;                // staged row, in elements
  const int wa = 2 * Kh + kPad, wb = Kh + kPad;     // resident weight rows, in elements

  // Shared memory (smem_bytes): weights, staged rows, pushed partials, carries.
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw);
  Elem* os = wsm + (size_t)CU * (wa + wb);          // [RP][2 Kh + pad]: dg1' share | dg2' share
  size_t staged = (size_t)RP * sstride * sizeof(Elem);
  const size_t shares = (size_t)4 * (kWarps / warps_n(CU)) * RP * (2 * CU + 4);
  if (shares > staged) staged = shares;
  float* rcv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(os) + staged);
  float* csm = rcv + (size_t)2 * C * RP * kU * 2;   // [npass][spp][kThreads]
  float* cin = csm + (size_t)npass * spp * kThreads;   // [kInputs][spp][kThreads]
  const int istride = spp * kThreads;               // between two inputs of a cell

  // The pass's exchange loads: load idx reads 16 bytes at load column col =
  // idx & (Lp - 1) of row idx >> lgL (L columns, Lp = L rounded up to a
  // power of two; columns past L idle), so that the addresses take shifts
  // and masks.
  const int lph = Kh / kVals;                       // 16-byte loads per half row
  const int lgL = 32 - __clz(2 * lph - 1), Lp = 1 << lgL;

  // Resident weights: WA [CU][2 Kh + pad] (dh1 columns: W1hh over the dg1'
  // share, then W2v over the dg2' share), then WB [CU][Kh + pad] (dh2
  // columns: W2hh over the dg2' share).
  for (int idx = tid; idx < 3 * Kh * CU; idx += kThreads) {
    const int n = idx % CU, kr = idx / CU;          // n fastest: coalesced reads
    const int seg = kr / Kh, kk = kr - seg * Kh;
    const Elem* W = seg == 0 ? w1hh : (seg == 1 ? w2v : w2hh);
    const Elem v = W[(size_t)(c * Kh + kk) * H + cj0 + n];
    if (seg < 2) wsm[(size_t)n * wa + seg * Kh + kk] = v;
    else wsm[(size_t)CU * wa + (size_t)n * wb + kk] = v;
  }
  for (int i = tid; i < npass * spp * kThreads; i += kThreads) csm[i] = 0.0f;
  const uint32_t w_addr = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t o_addr = (uint32_t)__cvta_generic_to_shared(os);
  cluster_barrier();   // every block of the cluster runs before any pushes into it

  for (int it = 0; it <= T; ++it) {
    const int t1 = T - it, t2 = T - 1 - it;       // layer 1 and layer 2 steps
    for (int ps = 0; ps < npass; ++ps) {
      const int pr0 = ps * RP;
      const int rp = min(RP, rows - pr0);
      const int par = (it * npass + ps) & 1;        // parity of the pushed partials
      // The inputs of the pass's cells, copied into cin by cp.async before
      // the poll, so that they land while the block waits for the
      // iteration's words and hold no registers. Cell e = s kThreads + tid of
      // the pass: unit e % U, layer (e / U) % 2, row e / 2U. A gate goes as
      // the 4 bytes of its unit pair. (The slot loops stay rolled: a smaller
      // loop body ran faster.)
#pragma unroll 1
      for (int s = 0; s < spp; ++s) {
        const int e = s * kThreads + tid, u = e % kU, layer = (e / kU) & 1, r = e / (2 * kU);
        const int step = layer == 0 ? t1 : t2;
        if (r >= rp || step < 0 || step >= T) continue;
        const int b = b0 + pr0 + r, j = j0 + u;
        const Elem* g = (layer == 0 ? g1 : g2) + ((size_t)step * B + b) * G4 + (j & ~1);
        const float* cs = (layer == 0 ? c1 : c2) + (size_t)b * H + j;
        const uint32_t ci = (uint32_t)__cvta_generic_to_shared(cin + (size_t)s * kThreads + tid);
        const uint32_t is = (uint32_t)istride * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(ci + q * is, g + (size_t)q * H);
        cp_async4(ci + 4 * is, cs + (size_t)step * B * H);
        if (step > 0) cp_async4(ci + 5 * is, cs + (size_t)(step - 1) * B * H);
        if (layer == 1) cp_async4(ci + 6 * is, dout2 + (size_t)step * B * H + (size_t)b * H + j);
      }
      cp_async_commit();
      if (it > 0) {
        // The rank's k share of [dg1' | dg2'] for rows [b0 + pr0, + rp): the
        // words iteration it - 1 wrote, tagged it, into os.
        const unsigned tag = it;
        const unsigned long long* base = xch + ((size_t)((it - 1) & 1) * B + b0 + pr0) * wrow;
        const int total = rp << lgL;
        for (int i0 = 0; i0 < total; i0 += kThreads * kLoads) {
          unsigned long long v[kLoads][2];
          uint32_t wo[kLoads], so[kLoads];          // word and staged offsets, ~0u: idle
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            const int idx = i0 + i * kThreads + tid, col = idx & (Lp - 1), r = idx >> lgL;
            wo[i] = so[i] = ~0u;
            if (idx >= total || col >= 2 * lph) continue;
            const int half = col >= lph, kk = (col - half * lph) * kVals;
            wo[i] = (uint32_t)(r * wrow + (half * G4 + c * Kh + kk) / kWordVals);
            so[i] = (uint32_t)(r * sstride + half * Kh + kk);
            ld_words(v[i], base + wo[i]);
          }
          unsigned long long start = 0;
          for (;;) {
            bool stale = false;
#pragma unroll
            for (int i = 0; i < kLoads; ++i) stale |= wo[i] != ~0u && !tagged(v[i], tag);
            if (!stale) break;
            poll_round(start, "s2vt_fused_bwd mma route", it - 1, b0 + pr0);
#pragma unroll
            for (int i = 0; i < kLoads; ++i)       // every stale word again, together
              if (wo[i] != ~0u && !tagged(v[i], tag)) ld_words(v[i], base + wo[i]);
          }
#pragma unroll
          for (int i = 0; i < kLoads; ++i)
            if (so[i] != ~0u)
              *reinterpret_cast<uint2*>(os + so[i]) = make_uint2((unsigned)v[i][0], (unsigned)v[i][1]);
        }
      }
      __syncthreads();                              // os holds the pass's rows

      if (it > 0) {
        // Products: this warp's 16 units (2 n8 tiles of dh1, 2 of dh2; 1
        // and 1 where the cluster has 8 units) over its share of the k16
        // slices of each half, every m16 tile of the pass.
        const int wN = warps_n(CU), wK = kWarps / wN;
        const int wn = warp % wN, wk = warp / wN;
        const int ntk = CU >= 16 ? 2 : 1;           // n8 tiles per layer
        const int per = Kh / 16 / wK;               // k16 slices of the share, per half
        const int mtiles = (rp + 15) / 16;
        // Three accumulators per tile: W1hh over dg1', W2v over dg2', W2hh
        // over dg2' (dh1 is the first two, added last), so that a warp keeps
        // 6 independent mma.sync chains in flight.
        float acc[3][kMaxTiles][2][4];
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[m][mt][nt][j] = 0.0f;
        const int s_end = (wk + 1) * per;
#pragma unroll 1
        for (int s0 = wk * per; s0 < s_end; s0 += 2) {   // two k16 slices' fragments at once
          uint32_t bw[2][3][2][2];                  // [slice][W1hh, W2v, W2hh][n8 tile]
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if (s0 + v >= s_end) break;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              if (nt >= ntk) break;
              const int n = wn * 16 + nt * 8 + (lane & 7);
              const int kb = (s0 + v) * 16 + ((lane >> 3) & 1) * 8;
              ldsm_x2(bw[v][0][nt], w_addr + (uint32_t)(((size_t)n * wa + kb) * sizeof(Elem)));
              ldsm_x2(bw[v][1][nt], w_addr + (uint32_t)(((size_t)n * wa + Kh + kb) * sizeof(Elem)));
              ldsm_x2(bw[v][2][nt],
                      w_addr + (uint32_t)(((size_t)CU * wa + (size_t)n * wb + kb) * sizeof(Elem)));
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt) {
            if (mt >= mtiles) break;
            uint32_t a[2][2][4];                    // [slice][dg1', dg2']
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if (s0 + v >= s_end) break;
              const uint32_t arow = o_addr + (uint32_t)(((mt * 16 + (lane & 15)) * sstride +
                                                          (s0 + v) * 16 + (lane >> 4) * 8) *
                                                         sizeof(Elem));
              ldsm_x4(a[v][0], arow);
              ldsm_x4(a[v][1], arow + (uint32_t)(Kh * sizeof(Elem)));
            }
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if (s0 + v >= s_end) break;
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                if (nt >= ntk) break;
                mma_bf16(acc[0][mt][nt], a[v][0], bw[v][0][nt]);
                mma_bf16(acc[1][mt][nt], a[v][1], bw[v][1][nt]);
                mma_bf16(acc[2][mt][nt], a[v][1], bw[v][2][nt]);
              }
            }
          }
        }
        __syncthreads();                            // every warp is done with os
        // This warp's k share, over os: red[wk][row][col], dh1 columns at
        // unit, dh2 at CU + unit; rows g and g + 8 of each m16 tile.
        float* red = reinterpret_cast<float*>(os);
        const int rs = 2 * CU + 4, g = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt) {
          if (mt >= mtiles) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (nt >= ntk) break;
            const int col = wn * 16 + nt * 8 + 2 * tig;
            float* o = red + ((size_t)wk * RP + mt * 16 + g) * rs + col;
            const float* x = acc[0][mt][nt];
            const float* y = acc[1][mt][nt];
            const float* z = acc[2][mt][nt];
            *reinterpret_cast<float2*>(o) = make_float2(x[0] + y[0], x[1] + y[1]);
            *reinterpret_cast<float2*>(o + 8 * rs) = make_float2(x[2] + y[2], x[3] + y[3]);
            *reinterpret_cast<float2*>(o + CU) = make_float2(z[0], z[1]);
            *reinterpret_cast<float2*>(o + 8 * rs + CU) = make_float2(z[2], z[3]);
          }
        }
        __syncthreads();
        // The shares summed in order, pushed to the owner of each unit, 4
        // units per 16-byte store: rcv[par][c][row][layer][unit % U] of rank
        // unit / U.
        const int lgq = 31 - __clz(CU / 2);         // float4s of a row: 2 CU / 4
        for (int idx = tid; idx < rp << lgq; idx += kThreads) {
          const int r = idx >> lgq, col = (idx & (CU / 2 - 1)) * 4;
          float4 sum = *reinterpret_cast<const float4*>(red + (size_t)r * rs + col);
          for (int k = 1; k < wK; ++k) {
            const float4 o = *reinterpret_cast<const float4*>(red + ((size_t)k * RP + r) * rs + col);
            sum.x += o.x;
            sum.y += o.y;
            sum.z += o.z;
            sum.w += o.w;
          }
          const int layer = col >= CU, unit = col - layer * CU;
          float* to = cluster.map_shared_rank(rcv, unit / kU);
          *reinterpret_cast<float4*>(to + ((((size_t)par * C + c) * RP + r) * 2 + layer) * kU +
                                     unit % kU) = sum;
        }
      }
      cluster_barrier();                            // every partial of the pass has arrived

      // Cells of the pass: one lane each.
      cp_async_wait<0>();                           // this thread's cell inputs have landed
#pragma unroll 1
      for (int s = 0; s < spp; ++s) {               // the same count for every thread
        const int e = s * kThreads + tid, u = e % kU, layer = (e / kU) & 1, r = e / (2 * kU);
        const int step = layer == 0 ? t1 : t2;
        const bool row_ok = r < rp;
        const bool valid = row_ok && step >= 0 && step < T;
        const int b = b0 + pr0 + (row_ok ? r : 0), j = j0 + u;
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (valid) {
          // dout (0 for layer 1), then the ranks' sums in order.
          const float* ci = cin + (size_t)s * kThreads + tid;
          float dh = layer == 1 ? ci[(size_t)6 * istride] : 0.0f;
          const float* rv = rcv + (((size_t)par * C * RP + r) * 2 + layer) * kU + u;
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k)
            if (k < C) dh += it > 0 ? rv[(size_t)k * RP * kU * 2] : 0.0f;
          float gt[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = __float_as_uint(ci[(size_t)q * istride]);
            gt[q] = __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
          }
          const float cp = step > 0 ? ci[(size_t)5 * istride] : 0.0f;
          float* carry = csm + (size_t)(ps * spp + s) * kThreads + tid;
          *carry = cell_bwd(gt[0], gt[1], gt[2], gt[3], ci[(size_t)4 * istride], cp, dh, *carry, d);
        }
        // The words first (no iteration reads iteration T's); layer 1's are
        // zeros at iteration 0. Lanes u, u + 1 (u even) pair their values,
        // the even lane writing gates 0 and 1, the odd lane 2 and 3.
        unsigned long long* xrow = xch + ((size_t)(it & 1) * B + b) * wrow;
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = __shfl_xor_sync(0xffffffffu, d[k], 1);
        if (row_ok && it < T) {
          const int odd = u & 1;
#pragma unroll
          for (int q = 0; q < 2; ++q) {             // gate k = q (even lane) or 2 + q (odd lane)
            const float lo = odd ? o[2 + q] : d[q], hi = odd ? d[2 + q] : o[q];
            st_word(xrow + (layer * G4 + (2 * odd + q) * H + j - odd) / 2,
                    __uint_as_float(pack_bf16(lo, hi)), it + 1);
          }
        }
        if (!valid) continue;
        Elem* dst = (layer == 0 ? dxp1 : dxp2) + ((size_t)step * B + b) * G4 + j;   // off the chain
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[(size_t)k * H] = from_f<Elem>(d[k]);
      }
    }
  }
}

template <int kU>
cudaError_t launch(const void* g1, const void* c1, const void* g2, const void* c2,
                   const void* dout2, const void* w1hh, const void* w2v, const void* w2hh,
                   void* dxp1, void* dxp2, unsigned long long* xch, int T, int B, int H, int C,
                   int groups, int RP, cudaStream_t stream) {
  auto kernel = s2vt_fused_bwd_kernel_mma<kU>;
  const int R = (B + groups - 1) / groups, passes = (R + RP - 1) / RP;
  const size_t smem = smem_bytes(H, kU, C, RP, passes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * (H / kU));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const Elem*>(g1),
                            static_cast<const float*>(c1), static_cast<const Elem*>(g2),
                            static_cast<const float*>(c2), static_cast<const float*>(dout2),
                            static_cast<const Elem*>(w1hh), static_cast<const Elem*>(w2v),
                            static_cast<const Elem*>(w2hh), static_cast<Elem*>(dxp1),
                            static_cast<Elem*>(dxp2), xch, T, B, H, groups, RP);
}

// The clusters of C blocks (one per SM) that the card holds at once.
cudaError_t active_clusters(int C, int* clusters) {
  auto kernel = s2vt_fused_bwd_kernel_mma<8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMinSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMinSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// Whether the kernel's layout serves H, B with U units per block, clusters
// of C blocks, `groups` batch groups and RP rows per pass: 128 <= H <= 512,
// H % 128 == 0 (whole k16 slices per warp share), U = 4 or 8, C = 2 or 4
// dividing the blocks of a group, every group holds rows, RP a multiple of
// 16 up to 48, and a thread runs at most kSlots cells per pass. (Shared
// memory, SMs and co-resident clusters are the caller's check.)
bool serves(int H, int B, int U, int C, int groups, int RP) {
  if (H < 128 || H > kMaxHidden || H % 128 || B < 1 || groups < 1 || RP < 1 || RP > kMaxRows ||
      RP % 16 || !(U == 4 || U == 8) || !(C == 2 || C == 4) || (H / U) % C)
    return false;
  const int R = (B + groups - 1) / groups;
  return (B + R - 1) / R == groups && cells_per_pass(U, RP) <= kSlots;
}

}  // namespace mma_route

}  // namespace

extern "C" {

// Hidden units each block owns (the grid is ceil(H / units) blocks).
int s2vt_fused_bwd_units_per_block() { return kUnits; }

// Dynamic shared memory one block needs for hidden size H.
size_t s2vt_fused_bwd_smem_bytes(int H) { return smem_floats(H) * sizeof(float); }

// g1, g2 [T, B, 4H] (post-activation gates) and w1hh, w2v, w2hh [4H, H] in the
// I/O type (float32, or bf16 when bf16 != 0); c1, c2, dout2 [T, B, H] float32;
// outputs dxp1, dxp2 [T, B, 4H] in the I/O type; dc [2, B, H] float32 scratch,
// zero-filled by the caller. All contiguous on card `device`; 4H * sizeof(I/O
// type) must be a multiple of 16 bytes. Launches on `stream`; returns the
// cudaError_t of the launch.
int s2vt_fused_bwd(const void* g1, const void* c1, const void* g2, const void* c2,
                   const void* dout2, const void* w1hh, const void* w2v, const void* w2hh,
                   void* dxp1, void* dxp2, void* dc, int T, int B, int H, int bf16, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh, dxp1, dxp2, dc, T,
                                      B, H, st);
  return (int)launch<float>(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh, dxp1, dxp2, dc, T, B, H, st);
}

// Dynamic shared memory of one mma-route block: hidden size H, U units per
// block, clusters of C blocks, RP rows per pass, `passes` passes per
// iteration.
size_t s2vt_fused_bwd_mma_smem_bytes(int H, int U, int C, int rp, int passes) {
  return mma_route::smem_bytes(H, U, C, rp, passes);
}

// Exchange words of one batch row of the mma route (8H bf16 values of dg1'
// and dg2', two per word): its buffer holds 2 * B of them.
size_t s2vt_fused_bwd_mma_xch_words(int H) { return (size_t)8 * H / mma_route::kWordVals; }

// Into *clusters: how many clusters of C mma-route blocks (one per SM) card
// `device` holds at once. Returns the cudaError_t of the query.
int s2vt_fused_bwd_mma_active_clusters(int C, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)mma_route::active_clusters(C, clusters);
}

// The mma route, bf16 only: the arguments of s2vt_fused_bwd without dc and
// bf16 (every tensor of the I/O type in bf16), then `xch`, the exchange of
// this launch alone (2 * B * s2vt_fused_bwd_mma_xch_words zeroed 8-byte
// words), U units per block (8: the one layout instantiated), clusters of C
// blocks (2, 4), `groups` batch groups (groups * H / U blocks, all resident
// at once) and RP rows per pass. Returns the cudaError_t of the launch.
int s2vt_fused_bwd_mma(const void* g1, const void* c1, const void* g2, const void* c2,
                       const void* dout2, const void* w1hh, const void* w2v, const void* w2hh,
                       void* dxp1, void* dxp2, void* xch, int T, int B, int H, int U, int C,
                       int groups, int rp, int device, void* stream) {
  if (!mma_route::serves(H, B, U, C, groups, rp) || T < 1) return (int)cudaErrorInvalidValue;
  if (U != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = mma_route::launch<8>(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh, dxp1, dxp2,
                             static_cast<unsigned long long*>(xch), T, B, H, C, groups, rp,
                             static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
