// Greedy-step out-projection and argmax for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_decode.py::_kernel (launched by argmax_linear).
// For each row b of h [B, H]:
//
//   out[b] = argmax_v mask(h[b] . W[v] + bias[v])     (W [V, H], torch layout)
//
// where mask sets the columns v >= valid to -1e30 (the pad-vocab mask of
// ops/layers.py::mask_invalid_vocab) and the FIRST maximum wins, as
// torch.argmax and jnp.argmax pick it. h and W are float32; with bf16 != 0
// both are rounded to bf16 as product operands and the sums stay float32, as
// the port's apply_linear does. The bias is added in float32 after the sum.
//
// Design:
//  - Grid (vocab tiles, row tiles of RB rows of h): RB = 16 with VR = 4 W rows
//    per warp (32 per block, 320 blocks at V = 10240) for B <= 16, else
//    RB = 32 with VR = 2. Each block stages its h rows in shared memory
//    (rounded to bf16 first in bf16 mode, zero past B) and reads its W rows
//    once, coalesced: W is [V, H], so the H values of one logit column are
//    contiguous. The lanes of a warp split the k range; each lane keeps
//    VR x RB partial sums in registers, loads VR x 4 values of W at a time,
//    and uses each value of h it reads from shared memory for VR products.
//    A warp reduce-scatter per W row leaves the sum of h row `lane` with
//    lane `lane`.
//  - Each lane then keeps a running (max, index) for its h row with a strict
//    `>` over increasing vocab index; the block combines its 8 warps and
//    writes one (max, index) per row and vocab tile to scratch.
//  - The last block of a row tile to finish (an atomic counter per row tile,
//    after a __threadfence) reduces the tiles' candidates: the larger value
//    wins, the lower index on a tie, so the result does not depend on the
//    order in which the blocks ran. It resets the counter to 0 for the next
//    launch. One launch per call.
//  - Products and sums float32 on the CUDA cores (no tensor cores in this
//    version).
//
// Bounds on an H100 SXM at the MSVD width (V = 10240, H = 512), B = 16,
// float32: W is 21 MB -> ~6.3 us at 3.35 TB/s; 2*B*H*V = 0.17 GFLOP -> ~2.5 us
// at the 67 TFLOP/s float32 peak. The bytes of W set the bound. This
// version's own limits are the shared-memory reads of h (one per VR
// products) and, at B = 16, a grid of ~2.4 blocks per SM.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                    // k positions each lane loads at once
constexpr float kNegInf = -1e30f;            // ops/layers.py NEG_INF

// (v1, i1) beats (v2, i2): larger value, lower index on a tie.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// RB rows of h per block, VR rows of W per warp (kVT = 8 * VR per block).
template <int RB, int VR>
__global__ void __launch_bounds__(kThreads)
argmax_linear_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ bias, long long* __restrict__ out,
                     float* __restrict__ pmax, int* __restrict__ pidx,
                     unsigned int* __restrict__ counter, int B, int H, int V, int valid,
                     int bf16) {
  extern __shared__ float hs[];                // [RB][H]
  __shared__ float red_v[kWarps][32];
  __shared__ int red_i[kWarps][32];
  __shared__ bool is_last;

  const int vt = blockIdx.x, rt = blockIdx.y;
  const int row0 = rt * RB;
  const int rows = min(RB, B - row0);
  for (int i = threadIdx.x; i < RB * H; i += kThreads) {
    const int r = i / H;
    float v = r < rows ? h[(size_t)(row0 + r) * H + (i - r * H)] : 0.0f;
    hs[i] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vbase = (vt * kWarps + warp) * VR;   // this warp's W rows vbase .. + VR - 1
  float acc[VR][RB];
#pragma unroll
  for (int j = 0; j < VR; ++j)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[j][r] = 0.0f;
  for (int k0 = lane; k0 < H; k0 += 32 * kLoads) {
    float wv[VR][kLoads];                      // VR * kLoads loads in flight
#pragma unroll
    for (int j = 0; j < VR; ++j) {
      const float* wr = w + (size_t)min(vbase + j, V - 1) * H;
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int k = k0 + 32 * q;
        float x = k < H ? __ldg(wr + k) : 0.0f;
        wv[j][q] = bf16 ? round_bf16(x) : x;
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int k = min(k0 + 32 * q, H - 1);   // past H: wv is 0, any h value will do
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float hv = hs[r * H + k];        // one shared-memory read for VR products
#pragma unroll
        for (int j = 0; j < VR; ++j) acc[j][r] = fmaf(wv[j][q], hv, acc[j][r]);
      }
    }
  }
  float best = -INFINITY;
  int best_i = INT_MAX;
#pragma unroll
  for (int j = 0; j < VR; ++j) {
    reduce_scatter(acc[j], lane);              // acc[j][0]: the sum of h row (lane % RB)
    const int v = vbase + j;
    if (v < V) {
      const float logit = v < valid ? acc[j][0] + bias[v] : kNegInf;
      if (logit > best) {                      // strict: the earlier column wins a tie
        best = logit;
        best_i = v;
      }
    }
  }
  red_v[warp][lane] = best;
  red_i[warp][lane] = best_i;
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float bv = red_v[0][r];
    int bi = red_i[0][r];
    for (int q = 1; q < kWarps; ++q) {
      if (beats(red_v[q][r], red_i[q][r], bv, bi)) {
        bv = red_v[q][r];
        bi = red_i[q][r];
      }
    }
    pmax[(size_t)vt * B + row0 + r] = bv;
    pidx[(size_t)vt * B + row0 + r] = bi;
  }

  // The last block of this row tile reduces the vocab tiles' candidates.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + rt, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int r = warp; r < rows; r += kWarps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int t = lane; t < (int)gridDim.x; t += 32) {
      const float cv = __ldcg(pmax + (size_t)t * B + row0 + r);
      const int ci = __ldcg(pidx + (size_t)t * B + row0 + r);
      if (beats(cv, ci, bv, bi)) {
        bv = cv;
        bi = ci;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[row0 + r] = bi;
  }
  if (threadIdx.x == 0) counter[rt] = 0u;     // ready for the next launch
}

template <int RB, int VR>
int launch(const float* h, const float* w, const float* bias, long long* out, float* pmax,
           int* pidx, unsigned int* counter, int B, int H, int V, int valid, int bf16,
           cudaStream_t stream) {
  const size_t smem = (size_t)RB * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(argmax_linear_kernel<RB, VR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kVT = kWarps * VR;
  const dim3 grid((V + kVT - 1) / kVT, (B + RB - 1) / RB), block(kThreads);
  argmax_linear_kernel<RB, VR><<<grid, block, smem, stream>>>(h, w, bias, out, pmax, pidx,
                                                              counter, B, H, V, valid, bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Vocab tiles (blocks along the vocab) for V columns and B rows: the scratch
// holds one candidate per tile and row.
int argmax_linear_vocab_tiles(int B, int V) {
  const int vt = kWarps * (B <= 16 ? 4 : 2);
  return (V + vt - 1) / vt;
}

// Dynamic shared memory a block needs for hidden size H (the 32-row tile).
size_t argmax_linear_smem_bytes(int H) { return (size_t)32 * H * sizeof(float); }

// h [B, H], w [V, H], bias [V] float32; out [B] int64; pmax [tiles, B]
// float32 and pidx [tiles, B] int32 scratch; counter [ceil(B / 16)] uint32,
// zero before the first launch (each launch leaves it zero). All contiguous on
// card `device`. Columns >= valid are masked. Launches on `stream`; returns
// the cudaError_t of the launch.
int argmax_linear(const void* h, const void* w, const void* bias, void* out, void* pmax,
                  void* pidx, void* counter, int B, int H, int V, int valid, int bf16, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* ph = static_cast<const float*>(h);
  auto* pw = static_cast<const float*>(w);
  auto* pb = static_cast<const float*>(bias);
  auto* po = static_cast<long long*>(out);
  auto* pm = static_cast<float*>(pmax);
  auto* pi = static_cast<int*>(pidx);
  auto* pc = static_cast<unsigned int*>(counter);
  auto* st = static_cast<cudaStream_t>(stream);
  if (B <= 16) return launch<16, 4>(ph, pw, pb, po, pm, pi, pc, B, H, V, valid, bf16, st);
  return launch<32, 2>(ph, pw, pb, po, pm, pi, pc, B, H, V, valid, bf16, st);
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
