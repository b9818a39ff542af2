// The "stream" route of the per-layer sequence kernels (lstm_seq_fwd.cu,
// lstm_seq_bwd.cu, gru_seq_fwd.cu, gru_seq_bwd.cu) and of the attention
// decoder (att_decode_fwd.cu): the widths whose weights do not fit the
// resident routes' shared memory (on an H100, H > ~1050; #7 H > 660 at
// L = 80).
//
// Design:
//  - One launch per step (the caller's host loop on one stream): the kernel
//    boundary orders step t after step t - 1, so no block waits on another
//    and no weight is held between steps. The weights are read from global
//    memory (L2, or HBM where they do not fit there) once per step.
//  - Forward: a block takes kRows batch rows and one hidden unit per warp;
//    each warp sums its unit's gate rows over the whole reduction, so every
//    gate of a unit meets in one warp and its cells run there.
//  - Backward: every block needs all the gate gradients of the step after,
//    [B, 4H], so that a block that took few units would re-read them for
//    little work. A block takes four units per warp and one kChunk slice of
//    the reduction, and writes its partial sums; a second launch sums the
//    slices in order and runs the cells, one thread per (row, unit). A carry
//    (c in the LSTM backward, dh * z in the GRU backward) stays with the
//    thread that owns its (row, unit) from one launch to the next, in the
//    output buffer that ends up holding it.
//  - The block stages its kRows operand rows (h, or the gate gradients of
//    the step after) in shared memory, kChunk values of the reduction at a
//    time, row-major, so that the staging reads are coalesced (kStageLoads
//    in flight per thread) and both its writes and the products' reads are
//    free of bank conflicts. The lanes of a warp split the reduction: each
//    lane reads kAhead positions of each of its weight rows ahead from
//    global memory (coalesced across the lanes), then uses each value for
//    kRows products, each staged operand value for NG. Sums are float32 on
//    the CUDA cores, each operand rounded to bf16 first in bf16 mode, as the
//    resident routes do; warp reduce-scatters leave each (weight row, batch
//    row) sum with one lane.
//  - The backward reads W_hh^T (transposed once per call by
//    transpose_kernel), so that its weight rows are contiguous too.
//
// This file is included by those sources; _build.py hashes it into every
// library's name.

#pragma once

#include <cstddef>

#include "common.cuh"

namespace stream_route {

constexpr int kRows = 16;      // batch rows per block
constexpr int kChunk = 1792;   // reduction values staged at once: 16 x 1792 floats, 112 KB
constexpr int kAhead = 4;      // reduction positions a lane loads ahead, per weight row
constexpr int kStageLoads = 8; // staged operand values a thread loads at once

// The kChunk slices of a reduction of R values.
inline int splits(int R) { return (R + kChunk - 1) / kChunk; }

// Dynamic shared memory of a block whose reduction has K values.
inline size_t smem_bytes(int K) {
  return (size_t)kRows * (K < kChunk ? K : kChunk) * sizeof(float);
}

// acc[g][r] = the lane's share of sum_k a(b0 + r, k) * w(g, k), k in
// [k_begin, k_end), for its NG weight rows g: the block stages a's rows
// [b0, b0 + kRows) in xs (zero past B), and the warp's lanes split k. Every
// thread of the block calls it (it synchronises the block); `active` false
// leaves acc zero.
template <int NG, class AOp, class WOp>
__device__ __forceinline__ void lane_sums(AOp a, WOp w, int k_begin, int k_end, int B, int b0,
                                          bool active, int bf16, float* xs,
                                          float (&acc)[NG][kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    const int kc = k_end - k0 < kChunk ? k_end - k0 : kChunk, n = kRows * kc;
    __syncthreads();  // the previous chunk's products have read xs
    for (int i0 = threadIdx.x; i0 < n; i0 += kStageLoads * blockDim.x) {
      float v[kStageLoads];                                    // in flight together
#pragma unroll
      for (int q = 0; q < kStageLoads; ++q) {
        const int i = i0 + q * blockDim.x, r = i / kc;
        v[q] = i < n && b0 + r < B ? a(b0 + r, k0 + i - r * kc) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kStageLoads; ++q) {
        const int i = i0 + q * blockDim.x;
        if (i < n) xs[i] = bf16 ? round_bf16(v[q]) : v[q];   // [kRows][kc]
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int k = lane; k < kc; k += 32 * kAhead) {
      float wv[kAhead][NG];                                    // in flight together
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int kk = k + 32 * q;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float v = kk < kc ? w(g, k0 + kk) : 0.0f;
          wv[q][g] = bf16 ? round_bf16(v) : v;
        }
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int kk = min(k + 32 * q, kc - 1);               // past the chunk: wv is 0
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float x = xs[r * kc + kk];
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[g][r] = fmaf(wv[q][g], x, acc[g][r]);
        }
      }
    }
  }
}

// The warp-wide sums of lane_sums' shares: afterwards lanes 0-15 hold in
// s[g] the sum of weight row g for row `lane` (lanes 16-31 hold partial
// copies). Two weight rows per reduce-scatter of 32 values.
template <int NG>
__device__ __forceinline__ void warp_sums(float (&acc)[NG][kRows], float (&s)[NG], int lane) {
  static_assert(kRows == 16, "a reduce-scatter of 32 values holds two rows of 16");
#pragma unroll
  for (int p = 0; p < NG; p += 2) {
    if (p + 1 < NG) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] = acc[p][i];
        v[16 + i] = acc[p + 1][i];
      }
      reduce_scatter(v, lane);           // lane l: weight row p + l / 16, row l % 16
      s[p] = v[0];
      s[p + 1] = __shfl_down_sync(0xffffffffu, v[0], 16);
    } else {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = acc[p][i];
      reduce_scatter(v, lane);           // lanes l and l + 16: row l % 16
      s[p] = v[0];
    }
  }
}

// The grid of a launch that gives each block `units` of U hidden units and
// kRows batch rows.
inline dim3 grid(int B, int H, int units) {
  return dim3((H + units - 1) / units, (B + kRows - 1) / kRows);
}

// wt [C, R] = w [R, C]^T, by 32 x 32 tiles through shared memory; blocks of
// 32 x 8 threads, grid (ceil(C / 32), ceil(R / 32)).
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ w, float* __restrict__ wt, int R, int C) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[i][threadIdx.x] = w[(size_t)r * C + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < C && r < R) wt[(size_t)c * R + r] = tile[threadIdx.x][i];
  }
}

inline cudaError_t transpose(const float* w, float* wt, int R, int C, cudaStream_t st) {
  transpose_kernel<<<dim3((C + 31) / 32, (R + 31) / 32), dim3(32, 8), 0, st>>>(w, wt, R, C);
  return cudaGetLastError();
}

// Opt a kernel into `smem` bytes of dynamic shared memory (above the 48 KB
// default).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace stream_route
