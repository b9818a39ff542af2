// Per-layer GRU sequence backward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_gru.py::_bwd_kernel (launched by _run_backward).
// The reverse sweep of gru_seq_fwd.cu. With iterations it = 0..T and the
// step t = T-1-it:
//
//   dprev = dhT                                        (it = 0)
//         = carry + [dr_pre | dz_pre | dghn][t + 1] @ W_hh   (it > 0; dh0 at t = -1)
//   dh     = dprev + dout[t]
//   dz     = dh * (h_{t-1} - n) ;  dn_pre = dh * (1 - z) * (1 - n^2)
//   dghn   = dn_pre * r ;  dr_pre = dn_pre * gh_n * r * (1 - r) ;  dz_pre = dz * z * (1 - z)
//   carry  = dh * z
//
// on the stored post-activation r, z, n, gh_n and h_{t-1}. dxp[t] is
// [dr_pre | dz_pre | dn_pre] (what x_proj's W_ih and b_ih take); the
// recurrent product takes [dr_pre | dz_pre | dghn], whose n-column is
// dn_pre * r, and dghn[t] is stored too (dW_hh and db_hh are reductions of it
// outside the kernel, as in JAX). Everything read and written is float32;
// with bf16 != 0 the recurrent gate gradients and W_hh are rounded to bf16
// as operands of the product, and nothing is stored rounded, as the TPU
// kernel does.
//
// Three routes, chosen by the caller before the launch
// (ops/fused_gru.py::gru_seq_bwd_route): "mma" (below, after the direct
// kernel: batch groups, bf16 on the tensor cores, dh exchanged as
// step-tagged words from which each block recomputes the gate gradients)
// for the widths and batches where it was measured faster, "direct" for
// every other shape whose weights fit its blocks' shared memory, and
// "stream" (last, on stream.cuh: per iteration the recurrent products in
// slices, then the cells, W_hh^T read from global memory) for the widths
// beyond.
//
// "direct" route.
// Design (that of lstm_seq_bwd.cu with a two-part operand):
//  - One persistent cooperative launch; one grid-wide barrier between
//    iterations (T of them). Block b owns U hidden units j in [U*b, U*b + U)
//    and keeps the columns j of W_hh (3H x U values, float32) resident in
//    shared memory for the whole launch, so it forms the recurrent dh[:, j]
//    and runs the gate backward for its units by itself. U is 4 or 8, the
//    fewer that keeps one block per SM (gru_seq_bwd_units_per_block): 4 up
//    to H = 528 on 132 SMs, 8 up to 1056.
//  - The exchange between blocks is the outputs themselves: iteration it + 1
//    reads the operand row of step t + 1 from the dxp output (its r and z
//    columns) and the dghn output (its n column), written one iteration
//    earlier, so no exchange buffer is needed. Operand k in [0, 3H) is
//    dxp[.., k] for k < 2H and dghn[.., k - 2H] above. Rows are read with
//    __ldcg (L2, not the incoherent L1) straight into registers, as 16-byte
//    chunks when H % 4 == 0 (every chunk then lies inside one of the two
//    outputs and is aligned), as single floats otherwise.
//  - Per pass of up to 16 batch rows, thread (row group of 16/U rows,
//    k-slice) accumulates a (16/U)-row x U-unit register tile against the
//    weight columns (laid out so a warp's float4 reads are contiguous). A
//    warp reduce-scatter leaves the 16 sums with lanes 0-15; four warps'
//    partials are summed through shared memory by the thread that runs the
//    gate backward for that (row, unit).
//  - The carry dh * z lives in the dh0 output: only the owning thread reads
//    and writes it, and after t = 0 it holds dh0. The gate inputs are loaded
//    before the products so that their loads overlap them.
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, T = 159
// (training), float32:
//  - bytes: gates and dxp ([T, B, 3H] each, 15.6 MB each), gh_n, h_{t-1},
//    dout and dghn ([T, B, H], 5.2 MB each), W_hh 3 MB: ~55 MB -> ~16 us at
//    3.35 TB/s;
//  - operations: 2*T*B*3H*H = 4.0 GFLOP -> ~60 us at the 67 TFLOP/s float32
//    peak. The operations set the bound (in bf16, at the tensor-core peak,
//    the bytes).
//  - In practice neither: the floor is the chain of T + 1 dependent
//    iterations, each ending in a grid-wide barrier and starting with a
//    re-read of [B, 3H] gate gradients from L2 in every block.
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

constexpr int kRowTile = 16;                       // batch rows per pass
constexpr int kThreads = 512;
constexpr int kVals = 16;                          // partial sums per thread: rows x units
constexpr int kUnitChoices[] = {4, 8};            // the instantiated units per block

// 16-byte chunks of a [3H] operand row.
__host__ __device__ inline int chunks_for(int H) { return (3 * H + 3) / 4; }

size_t smem_floats(int H, int U) {
  return (size_t)4 * chunks_for(H) * U + (kThreads / 32) * kVals;   // weight columns + partials
}

// Operand values k0 .. k0 + 3 of one row: dxp row x (its first 2H values),
// then dghn row n (H values), then zeros up to the chunk's end.
__device__ __forceinline__ float4 load_chunk(const float* x, const float* n, int k0, int H,
                                             bool vec) {
  if (vec) {   // H % 4 == 0: the chunk lies inside one of the two rows, aligned
    return k0 < 2 * H ? __ldcg(reinterpret_cast<const float4*>(x + k0))
                      : __ldcg(reinterpret_cast<const float4*>(n + k0 - 2 * H));
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + q;
    v[q] = k < 2 * H ? __ldcg(x + k) : (k < 3 * H ? __ldcg(n + k - 2 * H) : 0.f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ ghn,
                   const float* __restrict__ hprev, const float* __restrict__ w,
                   const float* __restrict__ dout, const float* __restrict__ dhT, float* dxp,
                   float* dghn, float* dh0, int T, int B, int H, int bf16) {
  constexpr int kRows = kVals / kUnits;            // batch rows per thread
  constexpr int kGroups = kRowTile / kRows;        // row groups per pass
  constexpr int kSlices = kThreads / kGroups;      // k-slices per row group
  constexpr int kWarpsPerGroup = kSlices / 32;
  static_assert(kRows * kUnits == kVals && kUnits % 4 == 0, "float4 weight reads");
  static_assert(kSlices % 32 == 0, "a warp lies inside one row group");
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int nchunk = chunks_for(H);
  const bool vec = (H & 3) == 0;
  float* wsm = smem;                             // [4][nchunk][kUnits]
  float* red = wsm + (size_t)4 * nchunk * kUnits;  // [kThreads / 32][kVals]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kUnits;

  // Resident weight columns: wsm[(q*nchunk + ch)*kUnits + u] = W_hh[ch*4 + q, j0 + u]
  // (zero past row 3H), so that for one q a warp reading consecutive chunks
  // reads consecutive float4s.
  for (int idx = tid; idx < 4 * nchunk * kUnits; idx += kThreads) {
    const int u = idx % kUnits;
    const int r = idx / kUnits;                  // operand row g' = ch*4 + q
    const int ch = r / 4, q = r % 4;
    const int j = j0 + u;
    const float v = j < H && r < G ? w[(size_t)r * H + j] : 0.0f;
    wsm[((size_t)q * nchunk + ch) * kUnits + u] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const int grp = tid / kSlices, slice = tid % kSlices;
  // The gate backward this thread runs in each pass (threads below
  // kGroups * kVals): partial index cv = m * kUnits + u of row group cgrp.
  const int cgrp = tid / kVals, cv = tid % kVals;
  const int cm = cv / kUnits, cu = cv % kUnits;
  const int cj = j0 + cu;

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                    // step; -1 in the last iteration

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      // Gate inputs first: their loads overlap the products.
      const int cb = b0 + cgrp * kRows + cm;
      const bool cell = tid < kGroups * kVals && cb < B && cj < H;
      const size_t crow = (size_t)cb * H + cj;
      float rg = 0.f, zg = 0.f, ng = 0.f, gn = 0.f, hp = 0.f, dh = 0.f, carry = 0.f;
      if (cell && t >= 0) {
        const size_t grow = ((size_t)t * B + cb) * G + cj;
        rg = gates[grow];
        zg = gates[grow + H];
        ng = gates[grow + 2 * H];
        const size_t trow = (size_t)t * B * H + crow;
        gn = ghn[trow];
        hp = hprev[trow];
        dh = dout[trow];
      }
      if (cell && it > 0) carry = dh0[crow];

      float acc[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      if (it > 0) {
        // Rows b0 + grp*kRows + n of step t + 1's operand, as 16-byte chunks.
        const int rb0 = b0 + grp * kRows;
        const float* xr = dxp + ((size_t)(t + 1) * B + rb0) * G;
        const float* nr = dghn + ((size_t)(t + 1) * B + rb0) * H;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int ch = slice; ch < nchunk; ch += kSlices) {
          float4 r[kRows];
#pragma unroll
          for (int n = 0; n < kRows; ++n)
            r[n] = rb0 + n < B ? load_chunk(xr + (size_t)n * G, nr + (size_t)n * H, 4 * ch, H, vec)
                               : zero;
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
      __syncthreads();   // the previous pass's gate threads have read `red`
      if (lane < kVals) red[warp * kVals + lane] = acc[0];
      __syncthreads();

      if (cell) {
        float dprev;   // dh from the step after t
        if (it == 0) {
          dprev = dhT[crow];
        } else {
          float rec = 0.f;
#pragma unroll
          for (int k = 0; k < kWarpsPerGroup; ++k) rec += red[(cgrp * kWarpsPerGroup + k) * kVals + cv];
          dprev = carry + rec;
        }
        if (t < 0) {
          dh0[crow] = dprev;
        } else {
          dh += dprev;
          const float dz = dh * (hp - ng);
          const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
          const size_t grow = ((size_t)t * B + cb) * G + cj;
          dxp[grow] = dn_pre * gn * rg * (1.0f - rg);
          dxp[grow + H] = dz * zg * (1.0f - zg);
          dxp[grow + 2 * H] = dn_pre;
          dghn[(size_t)t * B * H + crow] = dn_pre * rg;
          dh0[crow] = dh * zg;
        }
      }
    }
    if (it < T) grid.sync();
  }
}

template <int kUnits>
cudaError_t launch(const float* gates, const float* ghn, const float* hprev, const float* w,
                   const float* dout, const float* dhT, float* dxp, float* dghn, float* dh0,
                   int T, int B, int H, int bf16, cudaStream_t stream) {
  const size_t smem = smem_floats(H, kUnits) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_seq_bwd_kernel<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &ghn, &hprev, &w, &dout, &dhT, &dxp,
                  &dghn,  &dh0, &T,     &B, &H,    &bf16};
  const dim3 grid((H + kUnits - 1) / kUnits), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)gru_seq_bwd_kernel<kUnits>, grid, block, args,
                                     smem, stream);
}

// ---------------------------------------------------------------------------
// "mma" route. Replaces the same TPU kernel (pallas_gru.py::_bwd_kernel) for
// the shapes ops/fused_gru.py::gru_seq_bwd_route sends here. On an H100 the
// direct route's iteration goes to the grid barrier, every block's re-read of
// all [B, 3H] gate gradients of step t + 1 from L2 in serial 16-row passes,
// and the products on the CUDA cores, in bf16 as in float32. This route is
// gru_seq_fwd.cu's mma route turned around:
//
//  - Splits the batch into groups. The grid is G groups of P = H / U blocks
//    (G P <= the card's SMs); block p of group q runs the cells of units
//    [p U, p U + U) for the group's batch rows [q R, q R + R), R = ceil(B/G),
//    and reads only its group's rows of the exchange. ops/fused_gru.py::
//    gru_bwd_mma_plan picks U (4, 8, 16; 32 in bf16: the one measured
//    fastest for the batch and mode), G and the m16 row tiles per pass from
//    the card's SMs and shared memory.
//  - Keeps the block's columns of W_hh, 3H x U values, resident in shared
//    memory in the operand type for the whole launch, and stages its group's
//    operand rows [dr_pre | dz_pre | dghn] of step t + 1 (16 rows per tile,
//    3H values each) beside them, as many tiles per pass as fit.
//  - Has no grid-wide barrier and no flag. The chain carries dh: a cell
//    writes its dh into an exchange buffer xch [2][B][H] (by iteration
//    parity) as an 8-byte {value, iteration + 1} word (exchange.cuh), before
//    the stores of dxp, dghn and dh0, which are off the chain. The block's
//    threads poll the words of its group's rows, 16 bytes per load, until
//    every tag is the iteration's, and recompute the operand rows from them
//    with the owners' expressions (cell_grads) on the rows' gate inputs of
//    step t + 1 (r, z, n, gh_n, h_{t-1}), loaded with the words, 4 16-byte
//    loads per thread in flight (8, with their inputs, spilled in float32).
//    So float32 operands are the owners' bit for bit, and a row costs H
//    words where the operand itself would cost 3H (3H / 2 in bf16; measured
//    1.2-2x slower at every checked shape, PERF.md). A poll that waits
//    kSpinLimitNs of wall time traps with a message. The launch is
//    cooperative, so every block is resident at once or the launch fails.
//  - bf16: the products on the tensor cores, m16n8k16 on bf16 operands with
//    float32 accumulation; each of the 8 warps takes every n8 column tile
//    (U padded to 8) over an eighth of the 3H/16 k slices, so that its
//    chains are short and independent; operands by ldmatrix, two k slices
//    at a time; the shares meet in shared memory and the cells add them in
//    a fixed order.
//  - float32: the products on the CUDA cores, each sum formed in the direct
//    route's order at U = 4 (its units per block up to H = 4 x SMs: 528 on
//    an H100): per 4 rows x 4 units, lane l of "slice warp" w in 0..3 sums
//    the 4-k chunks ch = 32 w + l + 128 m in order by fused multiply-adds
//    into slot n * 4 + u of 16, the warp reduce-scatter leaves each slot's
//    sum, and the cell adds the four slice warps' sums to 0 in order, then
//    to its carry; so the route's float32 results are the direct route's,
//    bit for bit. A warp item is 4 rows x 8 units (two slot vectors) of one
//    slice warp; operand and weight chunks are 16-byte shared loads.
//  - Runs each cell in one lane: dprev = carry + the sum (dhT at the first
//    iteration), dh = dout + dprev, then the gate backward in the direct
//    route's expressions as the direct kernel compiles them (cell_grads:
//    1 - n^2 as fma(-n, n, 1), nothing else fused; the variant tool's
//    dn_unfused is not bit-equal). The lane keeps its cell's float32 carry
//    dh * z in a register for the whole launch, and loads its inputs (r, z,
//    n, gh_n, h_{t-1}, dout) before the poll, so that they land while the
//    block waits.
//
// Bounds (chip_smoke.py recomputes them): the direct route's bytes and, in
// float32, its operations at the float32 peak (60 us at B = 16, T = 159); in
// bf16 the operations of the recurrent product at the bf16 peak, so the
// bytes. In practice the chain of T + 1 dependent iterations: each poll waits
// for the slowest block of the group, then the staging, the products and the
// cells run before any word of the next iteration can be written
// (tools/gru_bwd_variants.py times each piece; PERF.md has the numbers).

namespace mma_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                        // cells per thread per iteration
constexpr int kMaxTiles = 4;                     // m16 row tiles staged per pass
constexpr int kMaxHidden = 512;                  // float32: at most 3 chunks per slice
constexpr int kDhLoads = 4;                      // 16-byte dh loads per thread in flight
constexpr int kInputs = 6;                       // a cell's inputs: r, z, n, gh_n, h_{t-1}, dout
constexpr int kSlices = 128;                     // the direct route's k slices per row group
constexpr int kSliceWarps = kSlices / 32;        // ... and its warps per row group

template <int kBf16, int kU>
struct Tile {
  using Elem = typename std::conditional<kBf16 != 0, __nv_bfloat16, float>::type;
  static constexpr int kN = kBf16 ? (kU + 7) / 8 * 8 : kU;    // weight columns (bf16: n8 tiles)
  static constexpr int kNT = kN / 8;                           // n8 tiles (bf16), all per warp
  static constexpr int kShares = kBf16 ? kWarps : kSliceWarps;    // partial sums per cell
  static constexpr int kKStep = 16;                            // k per mma.sync (bf16)
  static constexpr int kPad = kBf16 ? 8 : 4;                   // 16 bytes per staged row
  static constexpr int kRedStride = kN + 4;                    // partial-sum row, in floats
  static constexpr int kUQ = kU >= 8 ? 2 : 1;                  // float32: unit quads per item
  static constexpr int kGroup = 2;                             // k slices in flight per warp
  static_assert(kU % 4 == 0, "float32 items are 4 units wide");
};

template <int kBf16, int kU>
size_t smem_bytes(int H, int tiles) {
  using C = Tile<kBf16, kU>;
  const size_t stride = 3 * H + C::kPad;
  return ((size_t)(kBf16 ? C::kN * stride : 3 * H * kU) + 16 * tiles * stride) *
             sizeof(typename C::Elem) +
         (size_t)4 * C::kShares * 16 * tiles * C::kRedStride;
}

// Cells per thread per pass: the pass's 16 tiles U cells over the threads.
__host__ __device__ __forceinline__ int cells_per_pass(int U, int tiles) {
  return (16 * tiles * U + kThreads - 1) / kThreads;
}

// The gate backward of one cell, in the direct kernel's expressions as it
// compiles them: only 1 - n^2 is fused, as fma(-n, n, 1). o = {dr_pre,
// dz_pre, dghn} (the product's operand); returns dn_pre.
__device__ __forceinline__ float cell_grads(float dh, float r, float z, float n, float gn,
                                            float hp, float (&o)[3]) {
  const float dz = dh * (hp - n);
  const float dn = dh * (1.0f - z) * fmaf(-n, n, 1.0f);
  o[0] = dn * gn * r * (1.0f - r);
  o[1] = dz * z * (1.0f - z);
  o[2] = dn * r;
  return dn;
}

// Polls the n 16-byte loads idx = i0 + i kThreads + tid (i < kN) of `base`
// until each holds two words tagged `tag`.
template <int kN>
__device__ __forceinline__ void poll_words(unsigned long long (&v)[kN][2],
                                           const unsigned long long* base, int i0, int total,
                                           unsigned tag, int it, int row0) {
  unsigned long long start = 0;
  for (;;) {
    bool stale = false;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      stale |= i0 + i * kThreads + (int)threadIdx.x < total && !tagged(v[i], tag);
    if (!stale) break;
    poll_round(start, "gru_seq_bwd mma route", it, row0);
#pragma unroll
    for (int i = 0; i < kN; ++i) {                // every stale word again, together
      const int idx = i0 + i * kThreads + threadIdx.x;
      if (idx < total && !tagged(v[i], tag)) ld_words(v[i], base + 2 * (size_t)idx);
    }
  }
}

template <int kBf16, int kU>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_bwd_kernel_mma(const float* __restrict__ gates, const float* __restrict__ ghn,
                       const float* __restrict__ hprev, const float* __restrict__ w,
                       const float* __restrict__ dout, const float* __restrict__ dhT,
                       float* __restrict__ dxp, float* __restrict__ dghn,
                       float* __restrict__ dh0, unsigned long long* xch, int T, int B, int H,
                       int groups, int tiles) {
  using C = Tile<kBf16, kU>;
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = 3 * H;                              // operand width
  const int nchunk = K / 4;                         // float32: 4-k chunks of a row
  const int stride = K + C::kPad;                   // staged row, in elements
  const int RP = 16 * tiles;                        // rows per pass
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw);    // bf16 [kN][stride]; f32 [kU/4][4][nchunk] x4
  Elem* hs = wsm + (size_t)(kBf16 ? C::kN * stride : K * kU);   // [RP][stride]
  float* red = reinterpret_cast<float*>(hs + (size_t)RP * stride);   // [kShares][RP][kRedStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = gridDim.x / groups;                 // blocks per group
  const int j0 = (blockIdx.x % P) * kU;             // units [j0, j0 + kU)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;              // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int npass = (rows + RP - 1) / RP;
  const int ppp = cells_per_pass(kU, tiles);        // slots per pass

  // Resident weights, W_hh[k, j0 + u]: bf16 wsm[u * stride + k] (zero columns
  // past kU); float32 as float4s of 4 units, wsm4[(u/4 * 4 + k%4) * nchunk +
  // k/4], so that the lanes of a warp, at consecutive chunks, read
  // consecutive float4s.
  for (int idx = tid; idx < C::kN * K; idx += kThreads) {
    const int k = idx / C::kN, u = idx - k * C::kN;
    const float v = u < kU ? w[(size_t)k * H + j0 + u] : 0.0f;
    if constexpr (kBf16) {
      wsm[(size_t)u * stride + k] = __float2bfloat16_rn(v);
    } else {
      wsm[((size_t)((u >> 2) * 4 + (k & 3)) * nchunk + (k >> 2)) * 4 + (u & 3)] = v;
    }
  }

  // This thread's cells: slot s of pass ps = s / ppp is cell m * kThreads +
  // tid (m = s % ppp) of the pass, row-major over the pass's rows and the
  // block's units; each keeps its float32 carry dh * z.
  int cell_of[kSlots];                              // b * kU + u, or -1
  float carry[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    cell_of[s] = -1;
    carry[s] = 0.0f;
    const int ps = s / ppp, m = s - ps * ppp;
    if (ps >= npass) continue;
    const int cell = m * kThreads + tid;
    const int r = cell / kU, u = cell % kU;
    if (r >= min(RP, rows - ps * RP)) continue;
    cell_of[s] = (b0 + ps * RP + r) * kU + u;
  }
  const uint32_t w_addr = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t h_addr = (uint32_t)__cvta_generic_to_shared(hs);

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                       // step; -1 in the last iteration
    for (int ps = 0; ps < npass; ++ps) {
      const int pr0 = ps * RP;
      const int rp = min(RP, rows - pr0);
      // The inputs of the pass's cells, loaded before the poll so that they
      // land while the block waits for the iteration's words.
      float in[kSlots][kInputs];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int q = 0; q < kInputs; ++q) in[s][q] = 0.0f;
        if (t < 0 || s < ps * ppp || s >= (ps + 1) * ppp || cell_of[s] < 0) continue;
        const int b = cell_of[s] / kU, j = j0 + cell_of[s] % kU;
        const float* g = gates + ((size_t)t * B + b) * K + j;
        const size_t row = ((size_t)t * B + b) * H + j;
        in[s][0] = g[0];
        in[s][1] = g[H];
        in[s][2] = g[2 * H];
        in[s][3] = ghn[row];
        in[s][4] = hprev[row];
        in[s][5] = dout[row];
      }
      if (it > 0) {
        // Step t + 1's operand rows [b0 + pr0, + rp) into hs. A 16-byte load
        // holds the dh words of units j, j + 1 of one row (a row's words are
        // contiguous in xch, so the pass's loads are too); the operand is
        // recomputed from them and the gate inputs of step t + 1, loaded
        // with them.
        const unsigned tag = it;                    // written by iteration it - 1
        const unsigned long long* base = xch + ((size_t)((it - 1) & 1) * B + b0 + pr0) * H;
        const int v2row = H / 2;                    // 16-byte loads per row
        const int total = rp * v2row;
        for (int i0 = 0; i0 < total; i0 += kThreads * kDhLoads) {
          unsigned long long v[kDhLoads][2];
          float2 gi[kDhLoads][5];
#pragma unroll
          for (int i = 0; i < kDhLoads; ++i) {
            const int idx = i0 + i * kThreads + tid;
            if (idx >= total) continue;
            const int r = idx / v2row, j = 2 * (idx - r * v2row);
            const size_t row = (size_t)(t + 1) * B + b0 + pr0 + r;
            const float* g = gates + row * K + j;
            gi[i][0] = *reinterpret_cast<const float2*>(g);
            gi[i][1] = *reinterpret_cast<const float2*>(g + H);
            gi[i][2] = *reinterpret_cast<const float2*>(g + 2 * H);
            gi[i][3] = *reinterpret_cast<const float2*>(ghn + row * H + j);
            gi[i][4] = *reinterpret_cast<const float2*>(hprev + row * H + j);
            ld_words(v[i], base + 2 * (size_t)idx);
          }
          poll_words(v, base, i0, total, tag, it - 1, b0 + pr0);
#pragma unroll
          for (int i = 0; i < kDhLoads; ++i) {
            const int idx = i0 + i * kThreads + tid;
            if (idx >= total) continue;
            const int r = idx / v2row, j = 2 * (idx - r * v2row);
            float o0[3], o1[3];
            cell_grads(__uint_as_float((unsigned)v[i][0]), gi[i][0].x, gi[i][1].x, gi[i][2].x,
                       gi[i][3].x, gi[i][4].x, o0);
            cell_grads(__uint_as_float((unsigned)v[i][1]), gi[i][0].y, gi[i][1].y, gi[i][2].y,
                       gi[i][3].y, gi[i][4].y, o1);
            Elem* hr = hs + (size_t)r * stride + j;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              if constexpr (kBf16) {
                *reinterpret_cast<__nv_bfloat162*>(hr + q * H) = __floats2bfloat162_rn(o0[q], o1[q]);
              } else {
                *reinterpret_cast<float2*>(hr + q * H) = make_float2(o0[q], o1[q]);
              }
            }
          }
        }
      }
      __syncthreads();                              // hs holds the pass's rows
      if (it > 0) {
        if constexpr (kBf16) {
          // Products: every n8 tile over this warp's eighth of the k range
          // (independent chains), every m16 tile of the pass, two k slices'
          // fragments loaded together.
          const int per = K / C::kKStep / kWarps;   // k slices of this warp's share
          const int mtiles = (rp + 15) / 16;
          const int s_end = (warp + 1) * per;
          float acc[kMaxTiles][C::kNT][4];
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt)
#pragma unroll
            for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
#pragma unroll 1
          for (int s0 = warp * per; s0 < s_end; s0 += C::kGroup) {
            uint32_t bw[C::kGroup][C::kNT][2];
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u) {
              if (s0 + u >= s_end) break;           // an odd share's last slice
#pragma unroll
              for (int nt = 0; nt < C::kNT; ++nt)
                ldsm_x2(bw[u][nt], w_addr + (uint32_t)(((nt * 8 + (lane & 7)) * stride +
                                                        (s0 + u) * C::kKStep +
                                                        ((lane >> 3) & 1) * (C::kKStep / 2)) *
                                                       sizeof(Elem)));
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
                for (int nt = 0; nt < C::kNT; ++nt) mma_bf16(acc[mt][nt], a[u], bw[u][nt]);
              }
            }
          }
          // This warp's k share: rows g and g + 8 of each m16 tile, columns
          // 2 tig + {0, 1} of each n8 tile.
          const int g = lane >> 2, tig = lane & 3;
          float* rw = red + (size_t)warp * RP * C::kRedStride;
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt) {
            if (mt >= mtiles) break;
#pragma unroll
            for (int nt = 0; nt < C::kNT; ++nt) {
              float* o = rw + (mt * 16 + g) * C::kRedStride + nt * 8 + 2 * tig;
              *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
              *reinterpret_cast<float2*>(o + 8 * C::kRedStride) =
                  make_float2(acc[mt][nt][2], acc[mt][nt][3]);
            }
          }
        } else {
          // float32 on the CUDA cores, each sum formed as the direct route
          // forms it at U = 4: an item is 4 rows x 4 units (kUQ such quads)
          // of one slice warp vw; lane l takes the chunks ch = 32 vw + l + 128
          // m in order, fused multiply-adds into slot n * 4 + u of 16 per
          // quad, then the warp reduce-scatter of those 16 sums.
          const float4* h4 = reinterpret_cast<const float4*>(hs);
          const float4* w4 = reinterpret_cast<const float4*>(wsm);
          constexpr int kUnitItems = kU / 4 / C::kUQ;      // items across the block's units
          const int nrq = (rp + 3) / 4;
          for (int item = warp; item < nrq * kUnitItems * kSliceWarps; item += kWarps) {
            const int vw = item % kSliceWarps, rest = item / kSliceWarps;
            const int uq0 = rest % kUnitItems * C::kUQ, rq = rest / kUnitItems;
            int hr[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) hr[n] = min(rq * 4 + n, rp - 1) * (stride / 4);
            float acc[C::kUQ][16];
#pragma unroll
            for (int v = 0; v < C::kUQ; ++v)
#pragma unroll
              for (int i = 0; i < 16; ++i) acc[v][i] = 0.0f;
            for (int ch = vw * 32 + lane; ch < nchunk; ch += kSlices) {
              float4 a[4];
#pragma unroll
              for (int n = 0; n < 4; ++n) a[n] = h4[hr[n] + ch];
#pragma unroll
              for (int v = 0; v < C::kUQ; ++v)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float4 wq = w4[(size_t)((uq0 + v) * 4 + q) * nchunk + ch];
#pragma unroll
                  for (int n = 0; n < 4; ++n) {
                    const float av =
                        q == 0 ? a[n].x : (q == 1 ? a[n].y : (q == 2 ? a[n].z : a[n].w));
                    acc[v][n * 4 + 0] = fmaf(av, wq.x, acc[v][n * 4 + 0]);
                    acc[v][n * 4 + 1] = fmaf(av, wq.y, acc[v][n * 4 + 1]);
                    acc[v][n * 4 + 2] = fmaf(av, wq.z, acc[v][n * 4 + 2]);
                    acc[v][n * 4 + 3] = fmaf(av, wq.w, acc[v][n * 4 + 3]);
                  }
                }
            }
            const int r = rq * 4 + (lane >> 2);
#pragma unroll
            for (int v = 0; v < C::kUQ; ++v) {
              reduce_scatter(acc[v], lane);         // lane n * 4 + u: row n, unit u
              if (lane < 16 && r < rp)
                red[((size_t)vw * RP + r) * C::kRedStride + (uq0 + v) * 4 + (lane & 3)] =
                    acc[v][0];
            }
          }
        }
        __syncthreads();                            // every partial sum of the pass is written
      }

      // Cells of the pass: one lane each.
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < ps * ppp || s >= (ps + 1) * ppp) continue;   // the same for every thread
        const int cell = cell_of[s];
        const bool valid = cell >= 0;
        const int b = valid ? cell / kU : b0, u = valid ? cell % kU : 0;
        const int j = j0 + u;
        float o[3] = {0.0f, 0.0f, 0.0f}, dn = 0.0f, dh = 0.0f;
        if (valid) {
          float dprev;                              // dh from the step after t
          if (it == 0) {
            dprev = dhT[(size_t)b * H + j];
          } else {
            // The partial sums in a fixed order; float32 as the direct
            // route adds its four warps' sums: to 0, then to the carry.
            const float* rs = red + (size_t)(b - b0 - pr0) * C::kRedStride + u;
            float rec = kBf16 ? rs[0] : 0.0f;
#pragma unroll
            for (int k = kBf16 ? 1 : 0; k < C::kShares; ++k) rec += rs[(size_t)k * RP * C::kRedStride];
            dprev = __fadd_rn(carry[s], rec);
          }
          if (t < 0) {
            dh0[(size_t)b * H + j] = dprev;
          } else {
            dh = __fadd_rn(in[s][5], dprev);
            dn = cell_grads(dh, in[s][0], in[s][1], in[s][2], in[s][3], in[s][4], o);
            carry[s] = __fmul_rn(dh, in[s][1]);
          }
        }
        if (t < 0) continue;                        // the same for every thread
        if (!valid) continue;
        st_word(xch + ((size_t)(it & 1) * B + b) * H + j, dh, it + 1);
        const size_t row = (size_t)t * B + b;       // off the critical path
        float* gr = dxp + row * K + j;
        gr[0] = o[0];
        gr[H] = o[1];
        gr[2 * H] = dn;
        dghn[row * H + j] = o[2];
      }
    }
  }
}

template <int kBf16, int kU>
cudaError_t launch(const float* gates, const float* ghn, const float* hprev, const float* w,
                   const float* dout, const float* dhT, float* dxp, float* dghn, float* dh0,
                   unsigned long long* xch, int T, int B, int H, int groups, int tiles,
                   cudaStream_t stream) {
  auto kernel = gru_seq_bwd_kernel_mma<kBf16, kU>;
  const size_t smem = smem_bytes<kBf16, kU>(H, tiles);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &ghn, &hprev, &w, &dout, &dhT, &dxp, &dghn, &dh0,
                  &xch,   &T,   &B,     &H, &groups, &tiles};
  const dim3 grid(groups * (H / kU)), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
}

// Whether the route serves H, B with U units per block, `groups` batch
// groups and `tiles` m16 tiles per pass: 128 <= H <= 512, H % 128 == 0 (a
// warp's bf16 k share is whole k slices, a float32 slice at most 3 chunks),
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
// The "stream" route (stream.cuh): per iteration, the recurrent products in
// kChunk slices of the reduction (a block of kStreamWarps warps takes four
// units per warp and one slice, W_hh^T read from global memory), then the
// cells, one thread per (row, unit); for the widths whose weights do not
// fit the resident routes.
// ---------------------------------------------------------------------------

constexpr int kStreamWarps = 16;
constexpr int kCellThreads = 256;

// part[slice][b][j] = the share of slice blockIdx.y of [dr_pre | dz_pre |
// dghn][t + 1] @ W_hh (dg: dxp[t + 1], its first 2H columns; dn: dghn[t + 1]).
// wt is W_hh^T [H, 3H].
__global__ void __launch_bounds__(32 * kStreamWarps)
gru_seq_bwd_stream_products(const float* __restrict__ dg, const float* __restrict__ dn,
                            const float* __restrict__ wt, float* __restrict__ part, int B, int H,
                            int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x * kStreamWarps + (threadIdx.x >> 5)) * 4, b0 = blockIdx.z * sr::kRows;
  const int G = 3 * H, H2 = 2 * H, r0 = blockIdx.y * sr::kChunk, r1 = min(G, r0 + sr::kChunk);
  float acc[4][sr::kRows], s[4];
  sr::lane_sums<4>(
      [=](int b, int r) {
        return r < H2 ? dg[(size_t)b * G + r] : dn[(size_t)b * H + r - H2];
      },
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
// (dhT at t = T - 1, else the carry dh * z, which lives in dh0, plus the
// `slices` partial sums, added in order), then the cell; at t = -1 only
// dh0.
__global__ void __launch_bounds__(kCellThreads)
gru_seq_bwd_stream_cell(const float* __restrict__ gates, const float* __restrict__ ghn,
                        const float* __restrict__ hprev, const float* __restrict__ dout,
                        const float* __restrict__ dhT, const float* __restrict__ part,
                        float* __restrict__ dxp, float* __restrict__ dghn,
                        float* __restrict__ dh0, int slices, int t, int T, int B, int H) {
  const size_t BH = (size_t)B * H, G = 3 * (size_t)H;
  const size_t hrow = (size_t)blockIdx.x * kCellThreads + threadIdx.x;
  if (hrow >= BH) return;
  const size_t b = hrow / H, j = hrow - b * H;
  float dprev;   // dh from the step after t
  if (t == T - 1) {
    dprev = dhT[hrow];
  } else {
    float rec = 0.0f;
    for (int q = 0; q < slices; ++q) rec += part[q * BH + hrow];
    dprev = dh0[hrow] + rec;
  }
  if (t < 0) {
    dh0[hrow] = dprev;
    return;
  }
  const float dh = dout[t * BH + hrow] + dprev;
  const size_t grow = ((size_t)t * B + b) * G + j;
  const float rg = gates[grow], zg = gates[grow + H], ng = gates[grow + 2 * H];
  const float gn = ghn[t * BH + hrow], hp = hprev[t * BH + hrow];
  const float dz = dh * (hp - ng);
  const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
  dxp[grow] = dn_pre * gn * rg * (1.0f - rg);
  dxp[grow + H] = dz * zg * (1.0f - zg);
  dxp[grow + 2 * H] = dn_pre;
  dghn[t * BH + hrow] = dn_pre * rg;
  dh0[hrow] = dh * zg;
}

}  // namespace

extern "C" {

// Hidden units each block owns for hidden size H on a card with `sms` SMs:
// the fewest instantiated count that keeps one block per SM, or 0 if none does.
int gru_seq_bwd_units_per_block(int H, int sms) {
  for (int U : kUnitChoices)
    if ((H + U - 1) / U <= sms) return U;
  return 0;
}

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t gru_seq_bwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// gates [T, B, 3H] (post-activation r, z, n), ghn, hprev and dout [T, B, H],
// w [3H, H] (W_hh), dhT [B, H]; outputs dxp [T, B, 3H], dghn [T, B, H] and
// dh0 [B, H]. All float32, contiguous, on card `device`; U units per block,
// one of gru_seq_bwd_units_per_block's answers. bf16 != 0 rounds the
// recurrent gate gradients and W_hh to bf16 as product operands. Launches on
// `stream`; returns the cudaError_t of the launch.
int gru_seq_bwd(const void* gates, const void* ghn, const void* hprev, const void* w,
                const void* dout, const void* dhT, void* dxp, void* dghn, void* dh0, int T,
                int B, int H, int U, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(ghn),
                       static_cast<const float*>(hprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT)};
  float* pdxp = static_cast<float*>(dxp);
  float* pdghn = static_cast<float*>(dghn);
  float* pdh0 = static_cast<float*>(dh0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (U) {
    case 4:
      err = launch<4>(in[0], in[1], in[2], in[3], in[4], in[5], pdxp, pdghn, pdh0, T, B, H, bf16,
                      st);
      break;
    case 8:
      err = launch<8>(in[0], in[1], in[2], in[3], in[4], in[5], pdxp, pdghn, pdh0, T, B, H, bf16,
                      st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one mma-route block: hidden size H, U units per
// block, `tiles` m16 tiles per pass.
size_t gru_seq_bwd_mma_smem_bytes(int H, int U, int tiles, int bf16) {
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

// The mma route: the arguments of gru_seq_bwd, then `xch`, the exchange of
// this launch alone (2 * B * H zeroed 8-byte words: dh by iteration
// parity), with U units per block (4, 8, 16; 32 in bf16), `groups` batch
// groups (groups * H / U blocks, all resident at once) and `tiles` m16 row
// tiles per pass. Returns the cudaError_t of the launch.
int gru_seq_bwd_mma(const void* gates, const void* ghn, const void* hprev, const void* w,
                    const void* dout, const void* dhT, void* dxp, void* dghn, void* dh0,
                    void* xch, int T, int B, int H, int U, int groups, int tiles, int bf16,
                    int device, void* stream) {
  if (!mma_route::serves(H, B, U, groups, tiles, bf16) || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(ghn),
                       static_cast<const float*>(hprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT)};
  float* o[] = {static_cast<float*>(dxp), static_cast<float*>(dghn), static_cast<float*>(dh0)};
  unsigned long long* words = static_cast<unsigned long long*>(xch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2VT_GRU_BWD_MMA(BF, UU)                                                            \
  mma_route::launch<BF, UU>(in[0], in[1], in[2], in[3], in[4], in[5], o[0], o[1], o[2], words, \
                            T, B, H, groups, tiles, st)
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: err = S2VT_GRU_BWD_MMA(0, 4); break;
    case 9: err = S2VT_GRU_BWD_MMA(1, 4); break;
    case 16: err = S2VT_GRU_BWD_MMA(0, 8); break;
    case 17: err = S2VT_GRU_BWD_MMA(1, 8); break;
    case 32: err = S2VT_GRU_BWD_MMA(0, 16); break;
    case 33: err = S2VT_GRU_BWD_MMA(1, 16); break;
    case 65: err = S2VT_GRU_BWD_MMA(1, 32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2VT_GRU_BWD_MMA
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Float32 scratch the stream route needs at batch B and hidden size H:
// W_hh^T, then the partial sums of the reduction's slices.
size_t gru_seq_bwd_stream_scratch_floats(int B, int H) {
  return (size_t)3 * H * H + (size_t)stream_route::splits(3 * H) * B * H;
}

// The stream route: the arguments of gru_seq_bwd without U, then `scratch`
// (gru_seq_bwd_stream_scratch_floats(B, H) floats), for any H and B; a
// transpose, then per iteration the products (but at t = T - 1) and the
// cells, on `stream`. Returns the cudaError_t of the first call that fails.
int gru_seq_bwd_stream(const void* gates, const void* ghn, const void* hprev, const void* w,
                       const void* dout, const void* dhT, void* dxp, void* dghn, void* dh0,
                       void* scratch, int T, int B, int H, int bf16, int device, void* stream) {
  namespace sr = stream_route;
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = 3 * H, slices = sr::splits(G);
  float* wt = static_cast<float*>(scratch);
  float* part = wt + (size_t)G * H;
  float* pdxp = static_cast<float*>(dxp);
  float* pdghn = static_cast<float*>(dghn);
  if ((err = sr::transpose(static_cast<const float*>(w), wt, G, H, st)) != cudaSuccess)
    return (int)err;
  const size_t smem = sr::smem_bytes(G);
  if ((err = sr::allow_smem(gru_seq_bwd_stream_products, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((H + 4 * kStreamWarps - 1) / (4 * kStreamWarps), slices,
                  (B + sr::kRows - 1) / sr::kRows);
  const unsigned cells = (unsigned)(((size_t)B * H + kCellThreads - 1) / kCellThreads);
  for (int t = T - 1; t >= -1; --t) {
    if (t < T - 1) {
      gru_seq_bwd_stream_products<<<grid, 32 * kStreamWarps, smem, st>>>(
          pdxp + (size_t)(t + 1) * B * G, pdghn + (size_t)(t + 1) * B * H, wt, part, B, H, bf16);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    gru_seq_bwd_stream_cell<<<cells, kCellThreads, 0, st>>>(
        static_cast<const float*>(gates), static_cast<const float*>(ghn),
        static_cast<const float*>(hprev), static_cast<const float*>(dout),
        static_cast<const float*>(dhT), part, pdxp, pdghn, static_cast<float*>(dh0), slices, t,
        T, B, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
