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
// Design (that of lstm_seq_fwd.cu with three gate rows per unit):
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

#include "common.cuh"

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

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
