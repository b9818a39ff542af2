// Tensor-core helpers shared by the port's mma.sync kernels (the "mma" routes
// of conv3x3_bn_relu.cu, argmax_linear.cu and lstm_seq_fwd.cu, the "cluster"
// route of lstm_seq_bwd.cu): 16-byte cp.async copies into a ring in shared
// memory, ldmatrix fragment loads, the bf16 and TF32 mma.sync products, bf16
// pairs, and the splits of a float32 into two TF32 operands for 3xTF32
// products. _build.py hashes this file into every library's name.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

// 16 bytes from global `src` to shared `dst`, bypassing L1; with valid false
// nothing is read and the 16 bytes are zeros (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v rounded to TF32 (10 mantissa bits; nearest, ties away from zero) as the
// bits of a float: what cvt.rna.tf32.f32 gives for a finite v, in two integer
// operations instead of one on the slower conversion pipe.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small: big the TF32 value of v, small the float v - big, of which
// the tensor cores read the upper 10 mantissa bits (truncation, ~2^-21 of v).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = __float_as_uint(v - __uint_as_float(big));
}

// v = big + small for 3xTF32, big passed whole: the tensor cores read its
// upper 19 bits (a truncation), and small = v - trunc(v) is exact in float32
// (its own truncation costs ~2^-21 of v). Two operations, where the rounded
// split above takes three.
__device__ __forceinline__ void split_trunc(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v);
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {   // lo in the low half
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
