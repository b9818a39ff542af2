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
//  - Products and sums float32 on the CUDA cores (no tensor cores in this
//    version).
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, float32:
//  - beam encode, T = 80: x_proj and gates 10.5 MB each, the h and c
//    sequences 2.6 MB each, W_hh 4 MB: ~30 MB -> ~9 us at 3.35 TB/s;
//    2*T*B*4H*H = 2.7 GFLOP -> ~40 us at the 67 TFLOP/s float32 peak. The
//    operations set the bound (in bf16, at the tensor-core peak, the bytes).
//  - In practice neither: the floor is the chain of T dependent steps, each
//    ending in a grid-wide barrier and starting with a re-read of h (B * H
//    floats) from L2 in every block. The design keeps everything else off
//    that chain: the weights never leave shared memory and c never leaves
//    the thread that owns it.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchTile = 16;  // batch rows per shared-memory h tile
constexpr int kRowBlock = 4;    // batch rows per warp item (register tile)
constexpr int kVals = 4 * kRowBlock;  // sums per item: 4 gates x 4 rows
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// One halving step of the reduce-scatter: lanes that differ in bit S swap
// halves, each keeping the sum of the half it owns. S is a template argument
// so that every index into v is a constant and v stays in registers.
template <int S>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kVals], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float lo = v[i], hi = v[i + S];
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, S);
  }
}

// After the call, lanes l and l + 16 hold the warp-wide sum of v[l & 15] in v[0].
__device__ __forceinline__ void reduce_scatter(float (&v)[kVals], int lane) {
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
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

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
