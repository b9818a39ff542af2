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

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
