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

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
