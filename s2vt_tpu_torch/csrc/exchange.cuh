// The step-tagged exchange shared by the port's recurrent kernels (the
// "cluster" route of lstm_seq_bwd.cu, the "mma" routes of lstm_seq_fwd.cu,
// fused_s2vt_fwd.cu, gru_seq_fwd.cu and gru_seq_bwd.cu): 8-byte words that
// carry 32 bits of payload and the step that wrote them, so that a reader
// polls the words themselves and needs no flag, no fence and no grid
// barrier (NCCL's "LL" protocol); the wall clock that bounds a poll, and the
// round of a poll that traps past it; and the 4-byte cp.async that stages a
// thread's own cell inputs (in the cluster route).
// _build.py hashes this file into every library's name.

#pragma once

#include <cstdint>
#include <cstdio>

// Wall time (ns) a poll waits before it traps: far beyond any exchange, even
// with the card time-sliced between contexts.
constexpr unsigned long long kSpinLimitNs = 5000000000ull;

// 4 bytes from global to shared, through L1 (the cell inputs are read once).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// An exchange word: the value's bits low, its tag (step + 1) high. Stored
// and polled with relaxed gpu-scope accesses (8 bytes each, single-copy
// atomic; CUB's decoupled look-back polls its tagged words the same way).
// The word carries its own data, so the store orders nothing else: no
// "memory" clobber, and the compiler may move other loads and stores
// across it (a clobber serialised the forward's cells, one after another).
__device__ __forceinline__ void st_word(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long x = ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(x));
}
__device__ __forceinline__ void ld_words(unsigned long long (&v)[2], const unsigned long long* p) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(v[0]), "=l"(v[1])
               : "l"(p)
               : "memory");
}
__device__ __forceinline__ bool tagged(const unsigned long long (&v)[2], unsigned tag) {
  return (unsigned)(v[0] >> 32) == tag && (unsigned)(v[1] >> 32) == tag;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

__device__ __noinline__ void poll_trap(const char* kernel, unsigned long long waited, int step,
                                       int row) {
  printf("%s: block %d thread %d polled %llu ns for batch row %d of step %d; trapping\n",
         kernel, blockIdx.x, threadIdx.x, waited, row, step);
  __trap();
}

// One more round of a poll that started at `start` (0: not yet) for the
// words of batch row `row` written at `step`: traps, naming `kernel`, once
// it has waited kSpinLimitNs of wall time.
__device__ __forceinline__ void poll_round(unsigned long long& start, const char* kernel,
                                           int step, int row) {
  const unsigned long long now = global_ns();
  if (start == 0) start = now;
  else if (now - start > kSpinLimitNs) poll_trap(kernel, now - start, step, row);
}
