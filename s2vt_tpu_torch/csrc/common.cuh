// Device helpers shared by the port's kernel sources, each of which includes
// this file by its relative path. _build.py hashes it into every library's
// name, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>

// v rounded to bf16 and back: how a TPU kernel reads a bf16 product operand.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One halving step of the reduce-scatter: lanes that differ in bit S swap
// halves, each keeping the sum of the half it owns. S is a template argument
// so that every index into v is a constant and v stays in registers.
template <int S, int N>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[N], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float lo = v[i], hi = v[i + S];
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, S);
  }
}

// 32 sums per lane: after the call, lane l holds the warp-wide sum of v[l].
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
}

// 16 sums per lane: after the call, lanes l and l + 16 hold the warp-wide
// sum of v[l & 15] in v[0].
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int lane) {
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
}
