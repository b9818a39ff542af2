// Fused dual-LSTM S2VT forward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_s2vt.py::_fwd_kernel (launched by _run_fwd).
// Both S2VT LSTM chains run in one launch, skewed by one step:
//
//   iteration t (0..T):  z = [h1_{t-1} | h2_{t-2}]
//     layer 1, step t   (t <  T): gates1 = x1_t     + z[:, :H] @ W1hh^T
//     layer 2, step t-1 (t >= 1): gates2 = x2_{t-1} + z[:, :H] @ W2v^T
//                                                   + z[:, H:] @ W2hh^T
//
// and emits, in time order, the post-activation gates (i, f, g, o) and c of
// both layers, their final (h, c), and layer-2 (h, c) at word step snap_idx.
// The zero block of the TPU kernel's W_all (layer-1 gates do not read h2) is
// never stored or multiplied.
//
// Two routes, chosen by the caller before the launch
// (ops/fused_s2vt.py::fused_s2vt_fwd_route): "mma" (below, after the direct
// kernel: batch groups, bf16 on the tensor cores, h of both chains exchanged
// as step-tagged words) for the widths and batches where it was measured
// faster, and "direct" for every other shape.
//
// "direct" route.
// Design:
//  - One persistent cooperative launch; one grid-wide barrier per iteration
//    (T + 1 of them). The grid is ceil(H / U) blocks, one per SM.
//  - Block b owns hidden units j in [b*U, b*U + U). For those units it keeps
//    the four gate rows of W1hh, W2v and W2hh (12*U rows of H values) resident
//    in shared memory, as float32, for the whole launch, so each LSTM cell
//    runs inside its own block and no gate value crosses blocks.
//  - c of the owned units is read back from the c output written by the same
//    block one step earlier. The h vectors of both layers go through a
//    float32 ping-pong buffer [2][B][2H] in global memory (L2) so every block
//    can read the whole of h_{t-1}; loads use __ldcg (L2, not the incoherent
//    L1).
//  - Per batch tile of up to 16 rows: h tile -> shared memory (rounded to
//    bf16 first in bf16 mode), then each thread forms a 4-gate x 4-row
//    register tile of partial dot products over one of 8 k-slices, the
//    partials are summed through shared memory, and one thread per
//    (layer, row, unit) runs the cell.
//  - Matmul operands are float32 or bf16 values, products and sums float32
//    on the CUDA cores (no tensor cores in this version); state and cell math
//    are float32; gates are stored in the I/O type (bf16 in bf16 mode).
//
// Bounds on an H100 SXM at the MSVD width (H = 512, T = 159), B = 16:
//  - bf16: HBM traffic ~58 MB (x streams 21 MB, gate outputs 21 MB, c outputs
//    10 MB, weights 6 MB) -> ~17 us at 3.35 TB/s; ~16 GFLOP -> ~16 us at the
//    989 TFLOP/s bf16 tensor-core peak. The bytes set the bound.
//  - f32: ~106 MB -> ~32 us; the same 16 GFLOP at the 67 TFLOP/s float32
//    peak -> ~240 us. The operations set the bound.
//  - In practice neither: the floor is the T + 1 = 160 dependent grid-wide
//    barriers, each of which also re-reads h (B * 2H floats) from L2 in
//    every block. The design keeps everything else off that chain: weights
//    never leave shared memory, c never leaves the block, and the x reads and
//    gate writes of a step are independent of other blocks.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "exchange.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchTile = 16;  // batch rows per shared-memory h tile
constexpr int kRowBlock = 4;    // batch rows per thread (register tile)
constexpr int kSlices = 8;      // k-slices per dot product
constexpr int kPad = 2;         // h tile row padding (bank spread)
constexpr int kMaxThreads = 512;

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

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

size_t smem_floats(int H, int U) {
  const size_t w = (size_t)12 * U * H;                        // [3][U][4][H]
  const size_t h = (size_t)kBatchTile * (2 * H + kPad);       // [16][2H + pad]
  const size_t items = (size_t)3 * U * (kBatchTile / kRowBlock);
  const size_t red = items * 4 * kRowBlock * kSlices;         // partial sums
  return w + h + red;
}

int threads_for(int U) {
  const int t = 3 * U * (kBatchTile / kRowBlock) * kSlices;  // one task each
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename TIO>
__global__ void __launch_bounds__(kMaxThreads)
s2vt_fused_fwd_kernel(const TIO* __restrict__ x1, const TIO* __restrict__ x2,
                      const TIO* __restrict__ w1hh, const TIO* __restrict__ w2v,
                      const TIO* __restrict__ w2hh, TIO* g1, float* c1, TIO* g2,
                      float* c2, float* fin, float* hbuf, int T, int B, int H,
                      int U, int snap) {
  extern __shared__ float smem[];
  float* wsm = smem;                                   // [3][U][4][H]
  float* hsm = wsm + (size_t)12 * U * H;               // [16][2H + pad]
  float* red = hsm + (size_t)kBatchTile * (2 * H + kPad);
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j0 = blockIdx.x * U;
  const int G = 4 * H;
  const int RS = 2 * H + kPad;
  constexpr bool kBf16 = sizeof(TIO) == 2;

  // Resident weights: row (seg, u, g) = W_seg[g*H + j0 + u, :].
  for (int idx = tid; idx < 12 * U * H; idx += nthr) {
    const int k = idx % H, r = idx / H;
    const int g = r % 4, su = r / 4;
    const int u = su % U, seg = su / U;
    const int j = j0 + u;
    const TIO* W = seg == 0 ? w1hh : (seg == 1 ? w2v : w2hh);
    wsm[idx] = j < H ? to_f(W[(size_t)(g * H + j) * H + k]) : 0.0f;
  }

  for (int t = 0; t <= T; ++t) {
    const float* hin = hbuf + (size_t)(t & 1) * B * 2 * H;
    float* hout = hbuf + (size_t)((t + 1) & 1) * B * 2 * H;
    const int s = t - 1;  // layer-2 (word) step of this iteration

    for (int b0 = 0; b0 < B; b0 += kBatchTile) {
      const int bt = min(kBatchTile, B - b0);
      const int nbg = (bt + kRowBlock - 1) / kRowBlock;
      const int items = 3 * U * nbg;

      __syncthreads();  // weights loaded / previous tile's readers done
      // The tile's rows are contiguous in hbuf. Four float4 loads per thread
      // are put in flight before any is stored: each is an L2 round trip.
      const float4* src = reinterpret_cast<const float4*>(hin + (size_t)b0 * 2 * H);
      const int n4 = bt * 2 * H / 4;  // 2H % 4 == 0 (H even, checked by the wrapper)
      for (int i0 = tid; i0 < n4; i0 += 4 * nthr) {
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i0 + q * nthr < n4) v[q] = __ldcg(src + i0 + q * nthr);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q * nthr;
          if (i >= n4) break;
          const int e = 4 * i, r = e / (2 * H), k = e % (2 * H);
          float* d = hsm + r * RS + k;
          const float vals[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            d[m] = kBf16 ? __bfloat162float(__float2bfloat16_rn(vals[m])) : vals[m];
        }
      }
      __syncthreads();

      for (int task = tid; task < items * kSlices; task += nthr) {
        const int ks = task % kSlices, item = task / kSlices;
        const int bg = item % nbg, su = item / nbg;  // su = seg*U + u
        const int seg = su / U;
        const float* w = wsm + (size_t)su * 4 * H;
        const float* hr[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n)
          hr[n] = hsm + min(bg * kRowBlock + n, bt - 1) * RS + (seg == 2 ? H : 0);
        float acc[4][kRowBlock];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) acc[g][n] = 0.0f;
        for (int k = ks; k < H; k += kSlices) {
          const float w0 = w[k], w1 = w[H + k], w2 = w[2 * H + k], w3 = w[3 * H + k];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            const float hv = hr[n][k];
            acc[0][n] = fmaf(w0, hv, acc[0][n]);
            acc[1][n] = fmaf(w1, hv, acc[1][n]);
            acc[2][n] = fmaf(w2, hv, acc[2][n]);
            acc[3][n] = fmaf(w3, hv, acc[3][n]);
          }
        }
        float* out = red + (size_t)item * 4 * kRowBlock * kSlices + ks;
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) out[(g * kRowBlock + n) * kSlices] = acc[g][n];
      }
      __syncthreads();

      // Cells: one thread per (layer, row, unit).
      for (int idx = tid; idx < 2 * bt * U; idx += nthr) {
        const int u = idx % U, r = (idx / U) % bt, layer = idx / (U * bt);
        const int j = j0 + u, b = b0 + r;
        const int step = layer == 0 ? t : s;
        if (j >= H || step < 0 || step >= T) continue;
        const int bg = r / kRowBlock, n = r % kRowBlock;
        float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int seg = layer == 0 ? 0 : 1; seg <= (layer == 0 ? 0 : 2); ++seg) {
          const float* p = red + (size_t)((seg * U + u) * nbg + bg) * 4 * kRowBlock * kSlices;
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int ks = 0; ks < kSlices; ++ks) pre[g] += p[(g * kRowBlock + n) * kSlices + ks];
        }
        const size_t grow = ((size_t)step * B + b) * G;
        const TIO* x = layer == 0 ? x1 : x2;
        const float ig = sigmoid_f(to_f(x[grow + j]) + pre[0]);
        const float fg = sigmoid_f(to_f(x[grow + H + j]) + pre[1]);
        const float gg = tanhf(to_f(x[grow + 2 * H + j]) + pre[2]);
        const float og = sigmoid_f(to_f(x[grow + 3 * H + j]) + pre[3]);
        float* cseq = layer == 0 ? c1 : c2;
        const size_t crow = (size_t)b * H + j;
        const float cprev = step > 0 ? __ldcg(cseq + (size_t)(step - 1) * B * H + crow) : 0.0f;
        const float c = fg * cprev + ig * gg;
        const float h = og * tanhf(c);
        TIO* gseq = layer == 0 ? g1 : g2;
        gseq[grow + j] = from_f<TIO>(ig);
        gseq[grow + H + j] = from_f<TIO>(fg);
        gseq[grow + 2 * H + j] = from_f<TIO>(gg);
        gseq[grow + 3 * H + j] = from_f<TIO>(og);
        cseq[(size_t)step * B * H + crow] = c;
        hout[(size_t)b * 2 * H + layer * H + j] = h;
        if (step == T - 1) {
          fin[(size_t)(2 * layer) * B * H + crow] = h;
          fin[(size_t)(2 * layer + 1) * B * H + crow] = c;
        }
        if (layer == 1 && step == snap) {
          fin[(size_t)4 * B * H + crow] = h;
          fin[(size_t)5 * B * H + crow] = c;
        }
      }
    }
    grid.sync();
  }
}

template <typename TIO>
cudaError_t launch(const void* x1, const void* x2, const void* w1hh, const void* w2v,
                   const void* w2hh, void* g1, void* c1, void* g2, void* c2, void* fin,
                   void* hbuf, int T, int B, int H, int U, int snap, cudaStream_t stream) {
  const size_t smem = smem_floats(H, U) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(s2vt_fused_fwd_kernel<TIO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TIO* px1 = static_cast<const TIO*>(x1);
  const TIO* px2 = static_cast<const TIO*>(x2);
  const TIO* pw1hh = static_cast<const TIO*>(w1hh);
  const TIO* pw2v = static_cast<const TIO*>(w2v);
  const TIO* pw2hh = static_cast<const TIO*>(w2hh);
  TIO* pg1 = static_cast<TIO*>(g1);
  float* pc1 = static_cast<float*>(c1);
  TIO* pg2 = static_cast<TIO*>(g2);
  float* pc2 = static_cast<float*>(c2);
  float* pfin = static_cast<float*>(fin);
  float* phbuf = static_cast<float*>(hbuf);
  void* args[] = {&px1, &px2, &pw1hh, &pw2v, &pw2hh, &pg1, &pc1, &pg2, &pc2, &pfin, &phbuf,
                  &T,   &B,   &H,     &U,    &snap};
  const dim3 grid((H + U - 1) / U), block(threads_for(U));
  err = cudaLaunchCooperativeKernel((const void*)s2vt_fused_fwd_kernel<TIO>, grid, block, args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma" route. Replaces the same TPU kernel (pallas_s2vt.py::_fwd_kernel) for
// the shapes ops/fused_s2vt.py::fused_s2vt_fwd_route sends here. On an H100
// the direct route's iteration goes to the grid barrier, every block's serial
// re-read of all of [h1 | h2] in 16-row tiles, the read of c back from global
// memory and the products on the CUDA cores through shared memory, in bf16
// as in float32. This route:
//
//  - Splits the batch into groups. The grid is G groups of P = H / U blocks
//    (G P <= the card's SMs); block p of group q runs the cells of units
//    [p U, p U + U) of both layers for the group's batch rows [q R, q R + R),
//    R = ceil(B / G). Batch rows never meet, so a block polls only its
//    group's rows. ops/fused_s2vt.py::fused_fwd_plan picks U (4 or 8), G and
//    the m16 row tiles per pass from the card's SMs and shared memory: at
//    H = 512 float32 takes U = 4 (its 12U resident weight rows take 99 KB;
//    U = 8 would take 197 KB), one group; bf16 U = 4 at B = 16 and U = 8 in
//    two groups of 48 rows at B = 96.
//  - Keeps the block's 12U weight rows (the four gate rows of each owned unit
//    in W1hh, W2v and W2hh; row seg * 4U + gate * U + u) resident in shared
//    memory in the operand type for the whole launch. The layer-1 columns
//    never multiply h2: the TPU kernel's zero block is neither stored nor
//    multiplied.
//  - bf16: the products on the tensor cores, m16n8k16 on bf16 operands with
//    float32 accumulation. The 12U columns are 1.5U n8 tiles; a warp takes 3
//    of them over a k share (the tiles of W1hh and W2v read the h1 half of
//    the staged rows, those of W2hh the h2 half), two k slices of operands
//    loaded together so that 6 independent mma.sync chains are in flight;
//    the k shares meet in shared memory (over the staged rows, which the
//    products no longer need) and the cells add them in a fixed order.
//  - float32: the products on the CUDA cores, each gate sum formed in the
//    direct route's order: for each weight segment and k slice ks in 0..7,
//    one fused multiply-add chain from 0 over k = ks, ks + 8, ...; the cells
//    add the slices in order, segment W2v before W2hh for layer 2, then
//    x + sum, the activations and c = fma(i, g, f c) as the direct kernel
//    compiles f c + i g; so the two routes' float32 results are equal bit for
//    bit. A lane forms one slice's chains for 8 weight rows x 4 batch rows,
//    32 fused multiply-adds per 12 shared loads. As 3xTF32
//    on the tensor cores (kF32OnCores false; tools/fused_fwd_variants.py,
//    variant tf32x3) the sums would round otherwise, and a float32 beam tie
//    flipped that way on the per-layer forward (PR 11's kernel #3), which
//    chip_smoke.py's float32 decode checks refuse.
//  - Runs each cell in the 4 lanes of its gates: a lane reads its x, adds its
//    gate's sums, applies the activation, and the lanes trade the four gates
//    by shuffles. c1 and c2 stay on the chip for the whole launch, one
//    shared-memory word per (cell slot, thread), so that the c output is
//    never read back: a register array over a thread's up to 32 slots had to
//    be unrolled, and a kernel that large ran several times slower per
//    iteration than the same code with 4 slots. A thread runs
//    its slots of a pass one at a time (loading several slots' sums and x
//    together, or running several stage by stage, gained nothing). The
//    pass's x is copied into shared memory by cp.async before its poll, so
//    that a cell reads it from there (each cell loading its own from global
//    memory, variant no_x_stage, made an iteration 0.58 us slower at B = 16
//    in float32 and 4.53 us at B = 96 in bf16). The stores of the gates, c,
//    the finals and the snapshot are off the chain.
//  - Has no grid-wide barrier and no flag. Iteration t (< T) writes h1_t and
//    h2_{t-1} as 8-byte {value, t + 1} words (exchange.cuh) into an exchange
//    buffer xch [2][B][2H] by the parity of t; in bf16 a word carries the
//    bf16 operands of two neighbouring units, [2][B][H]. Iteration 0 writes
//    its h2 words as zeros, tagged 1, since layer 2 idles there and every
//    word a reader polls for must carry its tag. Before iteration t >= 1 a
//    block polls its group's words, 16 bytes per load, until every tag is
//    t, and stages them in shared memory; a poll that waits kSpinLimitNs of
//    wall time traps with a message. The launch is cooperative, so every
//    block is resident at once or the launch fails.
//
// Bounds (chip_smoke.py recomputes them): the direct route's bytes (58 MB at
// B = 16, T = 159 in bf16: 17 us) and, in float32, its 2 T B 12 H^2
// operations at the float32 peak (16 GFLOP: 240 us at B = 16); in bf16 the
// same operations at the bf16 tensor-core peak (16 us), so the bytes. In
// practice the chain of T + 1 dependent iterations: each poll waits for the
// slowest block of the group, then the products and the cells run before any
// word of the next iteration can be written. Block 0's clock cycles per
// iteration at H = 512, T = 159 (tools/fused_fwd_variants.py, phase_clock):
// B = 16 poll 4503, products 9627, cells 2633 in float32 (the CUDA cores'
// fused multiply-adds take the time: 6 warps of 32 chains x 64 steps, 12
// shared loads per 32 of them); 2656, 1778, 2657 in bf16. At B = 96 the
// float32 route runs 6 passes of 16 rows (its weights leave room for one m16
// tile): poll 25871, products 57330, cells 15631; bf16 (U = 8, two groups
// of 48 rows, one pass): 6742, 7374, 13655, the cells' 12 slots per thread
// in the lead.

namespace mma_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;                       // (cell, gate) pairs per thread per iteration
constexpr int kMaxTiles = 4;                     // m16 row tiles staged per pass
constexpr int kMaxHidden = 512;                  // a lane's exchange loads cover a row
constexpr int kLoads = 16;                       // 16-byte exchange loads per thread in flight
// Float32 products on the CUDA cores in the direct route's order (else as
// 3xTF32 on the tensor cores; tools/fused_fwd_variants.py, variant tf32x3).
constexpr bool kF32OnCores = true;

template <int kBf16, int kU>
struct Tile {
  using Elem = typename std::conditional<kBf16 != 0, __nv_bfloat16, float>::type;
  static constexpr int kN = 12 * kU;                         // resident weight rows
  static constexpr int kNT = kN / 8;                         // n8 tiles, U / 2 per segment
  static constexpr int kNTW = 3;                             // n8 tiles per warp
  static constexpr int kWarpsN = kNT / kNTW;
  static constexpr int kWarpsK = kWarps / kWarpsN;           // k shares
  static constexpr int kKStep = kBf16 ? 16 : 8;              // k per mma.sync
  static constexpr int kPad = 8;                             // row pad: 16 bytes (bf16), 32 (f32)
  static constexpr int kRedStride = kN + 4;                  // k-share row, in floats
  static constexpr int kPerLane = kBf16 ? 8 : 16;            // 16-byte loads per lane and row
  static constexpr int kRowsW = kLoads / kPerLane;           // rows per warp per poll chunk
  static constexpr int kGroup = 2;                           // k slices in flight per warp
  static constexpr bool kTensorCores = kBf16 || !kF32OnCores;  // else float32 FMAs
  static constexpr int kXPiece = kU * (kBf16 ? 2 : 4) >= 16 ? 16 : 8;   // bytes per x copy
  static_assert(kNT % kNTW == 0 && kWarpsN * kWarpsK == kWarps,
                "warps tile the columns and the k range");
};

// Floats between two k slices' partials on the CUDA-core path, [kN][RP + 1]
// each, rounded up to 4 mod 32: the 8 slices x 4 rows a warp stores at once
// fall in distinct banks.
__host__ __device__ __forceinline__ int slice_stride(int n, int rp) {
  const int s = n * (rp + 1);
  return s + ((4 - s) & 31);
}

// Dynamic shared memory: the resident weights, `tiles` m16 tiles of staged
// [h1 | h2] rows, the gate sums (on the tensor cores the k shares, over the
// staged rows; on the CUDA cores the 8 slice partials of each (column, row),
// apart), the c of every cell pair of a thread, one word per (slot, thread)
// for the `passes` passes' tiles * U / 2 slots each, and two buffers of a
// pass's x [2 layers][RP rows][4 gates][U].
template <int kBf16, int kU>
__host__ __device__ size_t smem_bytes(int H, int tiles, int passes) {
  using C = Tile<kBf16, kU>;
  const size_t es = sizeof(typename C::Elem), rp = (size_t)16 * tiles;
  const size_t w = (size_t)C::kN * (H + C::kPad) * es;
  const size_t h = rp * (2 * H + C::kPad) * es;
  const size_t c = (size_t)4 * kThreads * passes * tiles * kU / 2;
  const size_t xs = passes > 0 ? 2 * 8 * rp * kU * es : 0;   // two pass buffers
  if (C::kTensorCores) {
    const size_t red = (size_t)4 * C::kWarpsK * rp * C::kRedStride;
    return w + (h > red ? h : red) + c + xs;
  }
  return w + h + (size_t)4 * 8 * slice_stride(C::kN, (int)rp) + c + xs;
}

template <int kBf16>
__device__ __forceinline__ typename Tile<kBf16, 4>::Elem operand(float v) {
  if constexpr (kBf16) return __float2bfloat16_rn(v);
  else return v;
}

__device__ __noinline__ void poll_trap(unsigned long long waited, int iter, int row) {
  printf("s2vt_fused_fwd mma route: block %d thread %d polled %llu ns for batch row %d of "
         "iteration %d's h; trapping\n", blockIdx.x, threadIdx.x, waited, row, iter);
  __trap();
}

// One more round of a poll that started at `start` (0: not yet): traps once
// it has waited kSpinLimitNs of wall time.
__device__ __forceinline__ void poll_round(unsigned long long& start, int iter, int row) {
  const unsigned long long now = global_ns();
  if (start == 0) start = now;
  else if (now - start > kSpinLimitNs) poll_trap(now - start, iter, row);
}

// The cell of pass slot m (of ppp) of this thread: layer, row of the pass,
// unit. A slot is 64 cells (4 lanes each), all of one layer: the first ppp / 2
// slots are layer 1's, the others layer 2's, each over (row, unit), unit
// fastest.
template <int kU>
__device__ __forceinline__ void cell_of(int m, int tid, int ppp, int& layer, int& r, int& u) {
  layer = m >= ppp / 2;
  const int cell = (m - layer * (ppp / 2)) * (kThreads / 4) + (tid >> 2);
  r = cell / kU;
  u = cell % kU;
}

// `kBytes` (8 or 16) bytes from global `src` to shared `dst`, asynchronously.
template <int kBytes>
__device__ __forceinline__ void cp_async_x(uint32_t dst, const void* src) {
  if constexpr (kBytes == 16) cp_async16(dst, src, true);
  else asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}

// One warp item of the float32 products on the CUDA cores: this lane's
// chains of slice ks for the item's 8 weight rows (gate a / 2, unit a % 2:
// w + ((a / 2) U + a % 2) wstride) and the rows h + 4 j wstride apart, j <
// kJ; each a fused multiply-add chain from 0 over k = ks + 8 i in order (w
// and h start at ks). The partials go to o[((a / 2) U + a % 2) (RP + 1) +
// 4 j].
template <int kJ, int kU>
__device__ __forceinline__ void core_item(const float* w, const float* h, int wstride,
                                          int hstride, int H, float* o, int RP) {
  float acc[8][kJ];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[a][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < H; k += 8) {
    float wv[8], hv[kJ];
#pragma unroll
    for (int a = 0; a < 8; ++a) wv[a] = w[(size_t)((a >> 1) * kU + (a & 1)) * wstride + k];
#pragma unroll
    for (int j = 0; j < kJ; ++j) hv[j] = h[(size_t)(4 * j) * hstride + k];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[a][j] = fmaf(wv[a], hv[j], acc[a][j]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < kJ; ++j) o[(size_t)((a >> 1) * kU + (a & 1)) * (RP + 1) + 4 * j] = acc[a][j];
}

template <int kBf16, int kU>
__global__ void __launch_bounds__(kThreads, 1)
s2vt_fused_fwd_kernel_mma(const typename Tile<kBf16, kU>::Elem* __restrict__ x1,
                          const typename Tile<kBf16, kU>::Elem* __restrict__ x2,
                          const typename Tile<kBf16, kU>::Elem* __restrict__ w1hh,
                          const typename Tile<kBf16, kU>::Elem* __restrict__ w2v,
                          const typename Tile<kBf16, kU>::Elem* __restrict__ w2hh,
                          typename Tile<kBf16, kU>::Elem* __restrict__ g1,
                          float* __restrict__ c1, typename Tile<kBf16, kU>::Elem* __restrict__ g2,
                          float* __restrict__ c2, float* __restrict__ fin,
                          unsigned long long* xch, int T, int B, int H, int snap, int groups,
                          int tiles) {
  using C = Tile<kBf16, kU>;
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wstride = H + C::kPad;                  // resident weight row, in elements
  const int hstride = 2 * H + C::kPad;              // staged [h1 | h2] row, in elements
  const int RP = 16 * tiles;                        // rows per pass
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw);    // [kN][wstride]: row seg*4U + gate*U + u
  Elem* hs = wsm + (size_t)C::kN * wstride;         // [RP][hstride]
  // The gate sums: on the tensor cores [kWarpsK][RP][kRedStride] over hs;
  // on the CUDA cores the slice partials [8][kN][RP + 1] (slices
  // slice_stride apart) after it.
  float* red = reinterpret_cast<float*>(C::kTensorCores ? hs : hs + (size_t)RP * hstride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int gate = tid & 3;                         // the gate of every pair of this thread
  const int P = gridDim.x / groups;                 // blocks per group
  const int j0 = (blockIdx.x % P) * kU;             // units [j0, j0 + kU)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;              // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int npass = (rows + RP - 1) / RP;
  const int ppp = tiles * kU / 2;                   // slots per pass: 2 RP 4U / kThreads
  const int G4 = 4 * H;
  const int wrow = kBf16 ? H : 2 * H;               // exchange words per batch row

  // Resident weights: wsm[(seg*4U + gate*U + u) * wstride + k] = W_seg[gate*H + j0 + u, k].
  for (int idx = tid; idx < C::kN * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H;
    const int seg = n / (4 * kU), gi = (n / kU) & 3, u = n % kU;
    const Elem* W = seg == 0 ? w1hh : (seg == 1 ? w2v : w2hh);
    wsm[(size_t)n * wstride + k] = W[(size_t)(gi * H + j0 + u) * H + k];
  }

  // c of this thread's pair in slot s: csm[s * kThreads + tid], after the
  // gate sums (shared memory, so that the cells need no unrolled register
  // array; see the route's note).
  float* csm = C::kTensorCores
                   ? reinterpret_cast<float*>(smem_raw + smem_bytes<kBf16, kU>(H, tiles, 0))
                   : red + 8 * slice_stride(C::kN, RP);
  for (int i = tid; i < npass * ppp * kThreads; i += kThreads) csm[i] = 0.0f;
  // The passes' x: [2 buffers][2 layers][RP][4 gates][U], after c.
  Elem* xs = reinterpret_cast<Elem*>(csm + (size_t)npass * ppp * kThreads);
  const int xs_pass = 8 * RP * kU;                  // elements of one buffer
  const int wn = warp % C::kWarpsN, wk = warp / C::kWarpsN;
  const int per = H / C::kKStep / C::kWarpsK;       // k slices of this warp's share
  const uint32_t w_addr = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t h_addr = (uint32_t)__cvta_generic_to_shared(hs);

  for (int t = 0; t <= T; ++t) {
    for (int ps = 0; ps < npass; ++ps) {
      const int pr0 = ps * RP;
      const int rp = min(RP, rows - pr0);
      // The x the pass's cells read, copied into shared memory while the poll
      // waits: each (layer, row, gate) is U contiguous elements. Buffers
      // alternate by pass (iteration t's passes counted on from the last),
      // so a copy never lands under another pass's cells.
      Elem* xb = xs + (size_t)((t * npass + ps) & 1) * xs_pass;
      {
        constexpr int kEs = sizeof(Elem), kPer = kU * kEs / C::kXPiece;   // copies per chunk
        const uint32_t xb_addr = (uint32_t)__cvta_generic_to_shared(xb);
        for (int idx = tid; idx < 8 * rp * kPer; idx += kThreads) {
          const int piece = idx % kPer, chunk = idx / kPer;   // chunk = (layer * rp + r) * 4 + gate
          const int gi = chunk & 3, lr = chunk >> 2;
          const int layer = lr / rp, r = lr - layer * rp;
          const int step = t - layer;
          if (step < 0 || step >= T) continue;
          const Elem* src = (layer == 0 ? x1 : x2) + ((size_t)step * B + b0 + pr0 + r) * G4 +
                            gi * H + j0;
          cp_async_x<C::kXPiece>(
              xb_addr + (uint32_t)((((layer * RP + r) * 4 + gi) * kU) * kEs + piece * C::kXPiece),
              reinterpret_cast<const char*>(src) + piece * C::kXPiece);
        }
        cp_async_commit();
      }
      // The previous pass's cells have read the gate sums that lie over hs.
      if constexpr (C::kTensorCores) __syncthreads();
      // z = [h1_{t-1} | h2_{t-2}] of rows [b0 + pr0, + rp) into hs, as
      // product operands: zeros at t = 0, else the words iteration t - 1
      // wrote, tagged t.
      if (t == 0) {
        for (int idx = tid; idx < rp * 2 * H; idx += kThreads) {
          const int r = idx / (2 * H), k = idx - r * 2 * H;
          hs[(size_t)r * hstride + k] = operand<kBf16>(0.0f);
        }
      } else {
        const unsigned tag = t;
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
              *reinterpret_cast<uint2*>(hs + (size_t)r * hstride + (kBf16 ? 4 : 2) * col) = x;
            }
        }
      }
      __syncthreads();                              // hs holds the pass's rows

      if constexpr (C::kTensorCores) {
        // Products: this warp's 3 n8 tiles over its k share, every m16 tile
        // of the pass; the tiles of W1hh and W2v read h1, those of W2hh h2.
        const int mtiles = (rp + 15) / 16;
        const int nt0 = wn * C::kNTW;
        const bool any1 = nt0 < kU, any2 = nt0 + C::kNTW > kU;   // tiles >= U are W2hh's
        float acc[kMaxTiles][C::kNTW][4];
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNTW; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
        uint32_t a1[C::kGroup][4] = {}, a2[C::kGroup][4] = {};
#pragma unroll 1
        for (int s0 = wk * per; s0 < (wk + 1) * per; s0 += C::kGroup) {
          uint32_t bw[C::kGroup][C::kNTW][2];
#pragma unroll
          for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
            for (int nt = 0; nt < C::kNTW; ++nt) {
              const int n0 = (nt0 + nt) * 8;
              ldsm_x2(bw[u][nt], w_addr + (uint32_t)(((n0 + (lane & 7)) * wstride +
                                                      (s0 + u) * C::kKStep +
                                                      ((lane >> 3) & 1) * (C::kKStep / 2)) *
                                                     sizeof(Elem)));
            }
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt) {
            if (mt >= mtiles) break;
            const uint32_t arow = h_addr + (uint32_t)(((mt * 16 + (lane & 15)) * hstride +
                                                        (lane >> 4) * (C::kKStep / 2)) *
                                                       sizeof(Elem));
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u) {
              const uint32_t k_off = (uint32_t)((s0 + u) * C::kKStep * sizeof(Elem));
              if (any1) ldsm_x4(a1[u], arow + k_off);
              if (any2) ldsm_x4(a2[u], arow + k_off + (uint32_t)(H * sizeof(Elem)));
            }
#pragma unroll
            for (int u = 0; u < C::kGroup; ++u)
#pragma unroll
              for (int nt = 0; nt < C::kNTW; ++nt) {
                const bool second = nt0 + nt >= kU;
                uint32_t a[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) a[j] = second ? a2[u][j] : a1[u][j];
                if constexpr (kBf16) {
                  mma_bf16(acc[mt][nt], a, bw[u][nt]);
                } else {
                  // 3xTF32: small*big, big*small, big*big into a fresh
                  // partial per k slice, joined by a round-to-nearest add.
                  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
                  for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(a[j]), ab[j], as[j]);
#pragma unroll
                  for (int j = 0; j < 2; ++j)
                    split_tf32(__uint_as_float(bw[u][nt][j]), bb[j], bs[j]);
                  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                  mma_tf32(part, as, bb);
                  mma_tf32(part, ab, bs);
                  mma_tf32(part, ab, bb);
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[j];
                }
              }
          }
        }
        __syncthreads();                            // every warp is done with hs
        // This warp's k share: rows g and g + 8 of each m16 tile, columns
        // 2 tig + {0, 1} of each of its n8 tiles.
        float* rw = red + (size_t)wk * RP * C::kRedStride;
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt) {
          if (mt >= mtiles) break;
#pragma unroll
          for (int nt = 0; nt < C::kNTW; ++nt) {
            float* o = rw + (mt * 16 + g) * C::kRedStride + (nt0 + nt) * 8 + 2 * tig;
            *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(o + 8 * C::kRedStride) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      } else {
        // float32 on the CUDA cores in the direct route's order. Lane (ks =
        // lane % 8, q = lane / 8) of a warp item (segment, unit pair, block
        // of 16 rows) forms the chains of slice ks for the item's 8 weight
        // rows (4 gates x 2 units) and rows q + 4 j (j < 4), each a fused
        // multiply-add chain from 0 over k = ks + 8 i in order: 32 chains,
        // 12 shared loads per 32 multiply-adds (the weights broadcast over
        // q, the rows of the 4 q in distinct banks). The partials go to
        // red[ks][n][row]; the cells add the slices.
        const int ks = lane & 7, q = lane >> 3;
        const int rblocks = (rp + 15) / 16;
        const int S = slice_stride(C::kN, RP);
        const int items = 3 * (kU / 2) * rblocks;
        for (int item = warp; item < items; item += kWarps) {
          const int rb = item % rblocks, su = item / rblocks;
          const int seg = su / (kU / 2), u0 = 2 * (su % (kU / 2));
          const int n0 = seg * 4 * kU + u0;       // row of (gate g, unit u0 + v): n0 + g U + v
          const float* wb = reinterpret_cast<const float*>(wsm) + (size_t)n0 * wstride + ks;
          const float* hb = reinterpret_cast<const float*>(hs) + (size_t)(rb * 16 + q) * hstride +
                            (seg == 2 ? H : 0) + ks;
          // Rows q + 4 j of the block, j < 4; fewer where the block has
          // only 4 or 8 of the pass's rows.
          float* o = red + (size_t)ks * S + (size_t)n0 * (RP + 1) + rb * 16 + q;
          const int in_block = rp - rb * 16;
          if (in_block > 8) core_item<4, kU>(wb, hb, wstride, hstride, H, o, RP);
          else if (in_block > 4) core_item<2, kU>(wb, hb, wstride, hstride, H, o, RP);
          else core_item<1, kU>(wb, hb, wstride, hstride, H, o, RP);
        }
      }
      cp_async_wait<0>();                           // this thread's x copies have landed
      __syncthreads();                              // every gate sum of the pass is written

      // Cells of the pass: each in 4 lanes, one per gate.
      for (int m = 0; m < ppp; ++m) {
        int layer, r, u;
        cell_of<kU>(m, tid, ppp, layer, r, u);
        const int step = t - layer;                 // layer 1: step t; layer 2: step t - 1
        const bool row_ok = r < rp;
        const bool valid = row_ok && step >= 0 && step < T;
        const int b = b0 + pr0 + (row_ok ? r : 0);
        const int j = j0 + u;
        float* cp = csm + (size_t)(ps * ppp + m) * kThreads + tid;   // the cell's c
        float x = 0.0f, pre = 0.0f;
        if (valid) {
          x = to_f(xb[((layer * RP + r) * 4 + gate) * kU + u]);
          // The gate's sums, layer 1 from W1hh, layer 2 from W2v then W2hh.
          for (int seg = layer; seg <= 2 * layer; ++seg) {
            const int n = seg * 4 * kU + gate * kU + u;
            if constexpr (C::kTensorCores) {
#pragma unroll
              for (int k = 0; k < C::kWarpsK; ++k)
                pre += red[((size_t)k * RP + r) * C::kRedStride + n];
            } else {
              const float* p = red + (size_t)n * (RP + 1) + r;
              const int S = slice_stride(C::kN, RP);
#pragma unroll
              for (int k = 0; k < 8; ++k) pre += p[(size_t)k * S];
            }
          }
        }
        const float z = x + pre;
        const float act = gate == 2 ? tanhf(z) : sigmoid_f(z);
        const int base = lane & ~3;
        const float ig = __shfl_sync(0xffffffffu, act, base);
        const float fg = __shfl_sync(0xffffffffu, act, base + 1);
        const float gg = __shfl_sync(0xffffffffu, act, base + 2);
        const float og = __shfl_sync(0xffffffffu, act, base + 3);
        // f c + i g as the direct route's kernel compiles it (one fused
        // multiply-add), so that float32 c is the direct route's.
        const float c = fmaf(ig, gg, fg * *cp);
        const float h = valid ? og * tanhf(c) : 0.0f;   // layer 2 at t = 0: zero words
        if (valid) *cp = c;
        float h_next = 0.0f;                        // bf16: h of unit u + 1, same row
        if constexpr (kBf16) h_next = __shfl_down_sync(0xffffffffu, h, 4);
        if (!row_ok) continue;
        if (gate == 0 && t < T) {                   // no iteration reads iteration T's words
          unsigned long long* word = xch + ((size_t)(t & 1) * B + b) * wrow;
          if constexpr (kBf16) {
            if ((u & 1) == 0)
              st_word(word + (layer * H + j) / 2, __uint_as_float(pack_bf16(h, h_next)), t + 1);
          } else {
            st_word(word + layer * H + j, h, t + 1);
          }
        }
        if (!valid) continue;
        const size_t row = (size_t)step * B + b;    // the stores are off the chain
        (layer == 0 ? g1 : g2)[row * G4 + (size_t)gate * H + j] = from_f<Elem>(act);
        if (gate == 0) {
          (layer == 0 ? c1 : c2)[row * H + j] = c;
          const size_t crow = (size_t)b * H + j;
          if (step == T - 1) {
            fin[(size_t)(2 * layer) * B * H + crow] = h;
            fin[(size_t)(2 * layer + 1) * B * H + crow] = c;
          }
          if (layer == 1 && step == snap) {
            fin[(size_t)4 * B * H + crow] = h;
            fin[(size_t)5 * B * H + crow] = c;
          }
        }
      }
    }
  }
}

template <int kBf16, int kU>
cudaError_t launch(const void* x1, const void* x2, const void* w1hh, const void* w2v,
                   const void* w2hh, void* g1, void* c1, void* g2, void* c2, void* fin,
                   unsigned long long* xch, int T, int B, int H, int snap, int groups, int tiles,
                   cudaStream_t stream) {
  using Elem = typename Tile<kBf16, kU>::Elem;
  auto kernel = s2vt_fused_fwd_kernel_mma<kBf16, kU>;
  const int R = (B + groups - 1) / groups, passes = ((R + 15) / 16 + tiles - 1) / tiles;
  const size_t smem = smem_bytes<kBf16, kU>(H, tiles, passes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Elem* px1 = static_cast<const Elem*>(x1);
  const Elem* px2 = static_cast<const Elem*>(x2);
  const Elem* pw1hh = static_cast<const Elem*>(w1hh);
  const Elem* pw2v = static_cast<const Elem*>(w2v);
  const Elem* pw2hh = static_cast<const Elem*>(w2hh);
  Elem* pg1 = static_cast<Elem*>(g1);
  float* pc1 = static_cast<float*>(c1);
  Elem* pg2 = static_cast<Elem*>(g2);
  float* pc2 = static_cast<float*>(c2);
  float* pfin = static_cast<float*>(fin);
  void* args[] = {&px1, &px2, &pw1hh, &pw2v, &pw2hh, &pg1, &pc1, &pg2, &pc2, &pfin,
                  &xch, &T,   &B,     &H,    &snap,  &groups, &tiles};
  const dim3 grid(groups * (H / kU)), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
}

// Whether the route serves H, B with U units per block, `groups` batch
// groups and `tiles` m16 tiles per pass: 128 <= H <= 512, H % 128 == 0 (a
// warp's k share is whole k slices, a lane's exchange loads cover a row),
// U in {4, 8}, every group holds rows, and a thread runs at most kSlots
// pairs. (Shared memory and SMs are the caller's check.)
bool serves(int H, int B, int U, int groups, int tiles) {
  if (H < 128 || H > kMaxHidden || H % 128 || B < 1 || groups < 1 || tiles < 1 ||
      tiles > kMaxTiles || !(U == 4 || U == 8))
    return false;
  const int R = (B + groups - 1) / groups;
  const int passes = ((R + 15) / 16 + tiles - 1) / tiles;
  return (B + R - 1) / R == groups && passes * tiles * U / 2 <= kSlots;
}

}  // namespace mma_route

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t s2vt_fused_fwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// x1, x2 [T, B, 4H] and w1hh, w2v, w2hh [4H, H] in the I/O type (float32, or
// bf16 when bf16 != 0); g1, g2 [T, B, 4H] in the I/O type; c1, c2 [T, B, H],
// fin [6, B, H] = (h1T, c1T, h2T, c2T, h2snap, c2snap) and hbuf [2, B, 2H]
// (zero-filled by the caller) in float32, all on card `device`. Launches on
// `stream`; returns the cudaError_t of the launch.
int s2vt_fused_fwd(const void* x1, const void* x2, const void* w1hh, const void* w2v,
                   const void* w2hh, void* g1, void* c1, void* g2, void* c2, void* fin,
                   void* hbuf, int T, int B, int H, int U, int snap, int bf16, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(x1, x2, w1hh, w2v, w2hh, g1, c1, g2, c2, fin, hbuf, T, B,
                                      H, U, snap, st);
  return (int)launch<float>(x1, x2, w1hh, w2v, w2hh, g1, c1, g2, c2, fin, hbuf, T, B, H, U, snap,
                            st);
}

// Dynamic shared memory of one mma-route block: hidden size H, U units per
// block, `tiles` m16 tiles per pass, `passes` passes per iteration.
size_t s2vt_fused_fwd_mma_smem_bytes(int H, int U, int tiles, int passes, int bf16) {
  using namespace mma_route;
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: return smem_bytes<0, 4>(H, tiles, passes);
    case 9: return smem_bytes<1, 4>(H, tiles, passes);
    case 16: return smem_bytes<0, 8>(H, tiles, passes);
    case 17: return smem_bytes<1, 8>(H, tiles, passes);
    default: return 0;
  }
}

// The mma route: the arguments of s2vt_fused_fwd without hbuf, then `xch`,
// the exchange of this launch alone (zeroed 8-byte words: 2 * B * 2H in
// float32, 2 * B * H in bf16), U units per block (4 or 8), `groups` batch
// groups (groups * H / U blocks, all resident at once) and `tiles` m16 row
// tiles per pass. Returns the cudaError_t of the launch.
int s2vt_fused_fwd_mma(const void* x1, const void* x2, const void* w1hh, const void* w2v,
                       const void* w2hh, void* g1, void* c1, void* g2, void* c2, void* fin,
                       void* xch, int T, int B, int H, int snap, int U, int groups, int tiles,
                       int bf16, int device, void* stream) {
  if (!mma_route::serves(H, B, U, groups, tiles) || T < 1 || snap < 0 || snap >= T)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* words = static_cast<unsigned long long*>(xch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2VT_FWD_MMA(BF, UU)                                                                  \
  mma_route::launch<BF, UU>(x1, x2, w1hh, w2v, w2hh, g1, c1, g2, c2, fin, words, T, B, H, snap, \
                            groups, tiles, st)
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 8: err = S2VT_FWD_MMA(0, 4); break;
    case 9: err = S2VT_FWD_MMA(1, 4); break;
    case 16: err = S2VT_FWD_MMA(0, 8); break;
    case 17: err = S2VT_FWD_MMA(1, 8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2VT_FWD_MMA
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
