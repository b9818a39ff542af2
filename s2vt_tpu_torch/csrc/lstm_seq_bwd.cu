// Per-layer LSTM sequence backward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_rnn.py::_bwd_kernel (launched by _run_backward).
// The reverse sweep of lstm_seq_fwd.cu. With iterations it = 0..T and the
// cell step t = T-1-it:
//
//   dh   = dhT                        (it = 0)
//        = dxp[t + 1] @ W_hh          (it > 0; dh0 when t = -1)
//   dxp[t], dc = cell_bwd(gates[t], c[t], c_prev[t], dh + dout[t], dc)   (t >= 0)
//
// cell_bwd is _cell_bwd of the TPU kernel: float32 math on the stored
// post-activation gates, c and c_prev, with a float32 dc carry (dcT at the
// start, dc0 at the end). Everything read and written is float32; with
// bf16 != 0 the gate gradients and W_hh are rounded to bf16 as operands of
// the product, and dxp is stored unrounded, as the TPU kernel does.
//
// Design:
//  - One persistent cooperative launch; one grid-wide barrier between
//    iterations (T of them). Block b owns U hidden units j in [U*b, U*b + U)
//    and keeps the columns j of W_hh (4H x U values, float32) resident in
//    shared memory for the whole launch, so it forms dh[:, j] and runs the
//    cell backward for its units by itself. U is 4 or 8, the fewer that keeps
//    one block per SM (lstm_seq_bwd_units_per_block): 4 up to H = 528 on 132
//    SMs, 8 up to 1056 (16 would need more than the 227 KB of shared memory
//    a block can have for any H that 8 does not serve).
//  - The exchange between blocks is the output itself: iteration it + 1
//    reads the dxp row that iteration it wrote, so no ping-pong buffer is
//    needed. Rows are read with __ldcg (L2, not the incoherent L1) straight
//    into registers: each value is used by one thread only, so nothing is
//    staged in shared memory.
//  - Per pass of up to 16 batch rows, thread (row group of 16/U rows,
//    k-slice) reads 16-byte chunks of dxp[t + 1] for its rows and
//    accumulates a (16/U)-row x U-unit register tile against the weight
//    columns (laid out so a warp's float4 reads are contiguous). A warp reduce-scatter leaves the 16
//    sums with lanes 0-15; four warps' partials are summed through shared
//    memory by the thread that runs the cell for that (row, unit).
//  - The dc carry lives in the dc0 output: only the owning thread reads and
//    writes it, and after t = 0 it holds dc0. The cell inputs are loaded
//    before the products so that their loads overlap them.
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, T = 159
// (training), float32:
//  - bytes: gates and dxp ([T, B, 4H] each, 21 MB each), c, c_prev and dout
//    ([T, B, H], 5.2 MB each), W_hh 4 MB: ~62 MB -> ~18 us at 3.35 TB/s;
//  - operations: 2*T*B*4H*H = 5.3 GFLOP -> ~80 us at the 67 TFLOP/s float32
//    peak. The operations set the bound (in bf16, at the tensor-core peak,
//    the bytes).
//  - In practice neither: the floor is the chain of T + 1 dependent
//    iterations, each ending in a grid-wide barrier and starting with a
//    re-read of [B, 4H] gate gradients from L2 in every block.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowTile = 16;                       // batch rows per pass
constexpr int kThreads = 512;
constexpr int kVals = 16;                          // partial sums per thread: rows x units
constexpr int kUnitChoices[] = {4, 8};            // the instantiated units per block

size_t smem_floats(int H, int U) {
  return (size_t)4 * H * U + (kThreads / 32) * kVals;   // weight columns + partials
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cseq,
                    const float* __restrict__ cprev, const float* __restrict__ w,
                    const float* __restrict__ dout, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, float* dxp, float* dh0, float* dc0, int T,
                    int B, int H, int bf16) {
  constexpr int kRows = kVals / kUnits;            // batch rows per thread
  constexpr int kGroups = kRowTile / kRows;        // row groups per pass
  constexpr int kSlices = kThreads / kGroups;      // k-slices per row group
  constexpr int kWarpsPerGroup = kSlices / 32;
  static_assert(kRows * kUnits == kVals && kUnits % 4 == 0, "float4 weight reads");
  static_assert(kSlices % 32 == 0, "a warp lies inside one row group");
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int nchunk = H;                          // 16-byte chunks (4 floats) per gate row
  float* wsm = smem;                             // [4][nchunk][kUnits]
  float* red = wsm + (size_t)G * kUnits;         // [kThreads / 32][kVals]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kUnits;

  // Resident weight columns: wsm[(q*nchunk + ch)*kUnits + u] = W_hh[ch*4 + q, j0 + u],
  // so that for one q a warp reading consecutive chunks reads consecutive float4s.
  for (int idx = tid; idx < G * kUnits; idx += kThreads) {
    const int u = idx % kUnits;
    const int r = idx / kUnits;                  // gate row g' = ch*4 + q
    const int ch = r / 4, q = r % 4;
    const int j = j0 + u;
    const float v = j < H ? w[(size_t)r * H + j] : 0.0f;
    wsm[((size_t)q * nchunk + ch) * kUnits + u] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const int grp = tid / kSlices, slice = tid % kSlices;
  // The cell this thread runs in each pass (threads below kGroups * kVals):
  // partial index cv = n * kUnits + u of row group cgrp.
  const int cgrp = tid / kVals, cv = tid % kVals;
  const int cn = cv / kUnits, cu = cv % kUnits;
  const int cj = j0 + cu;

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                    // cell step; -1 in the last iteration

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      // Cell inputs first: their loads overlap the products.
      const int cb = b0 + cgrp * kRows + cn;
      const bool cell = tid < kGroups * kVals && cb < B && cj < H;
      const size_t crow = (size_t)cb * H + cj;
      float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, cc = 0.f, cp = 0.f, dh = 0.f, carry = 0.f;
      if (cell && t >= 0) {
        const size_t grow = ((size_t)t * B + cb) * G + cj;
        gi = gates[grow];
        gf = gates[grow + H];
        gg = gates[grow + 2 * H];
        go = gates[grow + 3 * H];
        const size_t trow = (size_t)t * B * H + crow;
        cc = cseq[trow];
        cp = cprev[trow];
        dh = dout[trow];
        carry = it == 0 ? dcT[crow] : dc0[crow];
      }

      float acc[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      if (it > 0) {
        // Rows b0 + grp*kRows + n of dxp[t + 1], as 16-byte chunks.
        const int rb0 = b0 + grp * kRows;
        const float4* p = reinterpret_cast<const float4*>(dxp) + ((size_t)(t + 1) * B + rb0) * nchunk;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int ch = slice; ch < nchunk; ch += kSlices) {
          float4 r[kRows];
#pragma unroll
          for (int n = 0; n < kRows; ++n) r[n] = rb0 + n < B ? __ldcg(p + (size_t)n * nchunk + ch) : zero;
          if (bf16) {
#pragma unroll
            for (int n = 0; n < kRows; ++n) {
              r[n].x = round_bf16(r[n].x);
              r[n].y = round_bf16(r[n].y);
              r[n].z = round_bf16(r[n].z);
              r[n].w = round_bf16(r[n].w);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4* wq = reinterpret_cast<const float4*>(
                wsm + ((size_t)q * nchunk + ch) * kUnits);
#pragma unroll
            for (int u4 = 0; u4 < kUnits / 4; ++u4) {
              const float4 w4 = wq[u4];
#pragma unroll
              for (int n = 0; n < kRows; ++n) {
                const float a = q == 0 ? r[n].x : (q == 1 ? r[n].y : (q == 2 ? r[n].z : r[n].w));
                const int i = n * kUnits + 4 * u4;
                acc[i + 0] = fmaf(a, w4.x, acc[i + 0]);
                acc[i + 1] = fmaf(a, w4.y, acc[i + 1]);
                acc[i + 2] = fmaf(a, w4.z, acc[i + 2]);
                acc[i + 3] = fmaf(a, w4.w, acc[i + 3]);
              }
            }
          }
        }
      }
      reduce_scatter(acc, lane);
      __syncthreads();   // the previous pass's cells have read `red`
      if (lane < kVals) red[warp * kVals + lane] = acc[0];
      __syncthreads();

      if (cell) {
        float dprev = 0.f;   // dh from the step after t
        if (it == 0) {
          dprev = dhT[crow];
        } else {
#pragma unroll
          for (int k = 0; k < kWarpsPerGroup; ++k) dprev += red[(cgrp * kWarpsPerGroup + k) * kVals + cv];
        }
        if (t < 0) {
          dh0[crow] = dprev;
        } else {
          dh += dprev;
          const float tc = tanhf(cc);
          const float dcv = carry + dh * go * (1.0f - tc * tc);
          const size_t grow = ((size_t)t * B + cb) * G + cj;
          dxp[grow] = dcv * gg * gi * (1.0f - gi);
          dxp[grow + H] = dcv * cp * gf * (1.0f - gf);
          dxp[grow + 2 * H] = dcv * gi * (1.0f - gg * gg);
          dxp[grow + 3 * H] = dh * tc * go * (1.0f - go);
          dc0[crow] = dcv * gf;
        }
      }
    }
    if (it < T) grid.sync();
  }
}

template <int kUnits>
cudaError_t launch(const float* gates, const float* cseq, const float* cprev, const float* w,
                   const float* dout, const float* dhT, const float* dcT, float* dxp, float* dh0,
                   float* dc0, int T, int B, int H, int bf16, cudaStream_t stream) {
  const size_t smem = smem_floats(H, kUnits) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_bwd_kernel<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &cseq, &cprev, &w,  &dout, &dhT, &dcT,
                  &dxp,   &dh0,  &dc0,   &T,  &B,    &H,   &bf16};
  const dim3 grid((H + kUnits - 1) / kUnits), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)lstm_seq_bwd_kernel<kUnits>, grid, block, args,
                                     smem, stream);
}

}  // namespace

extern "C" {

// Hidden units each block owns for hidden size H on a card with `sms` SMs:
// the fewest instantiated count that keeps one block per SM, or 0 if none does.
int lstm_seq_bwd_units_per_block(int H, int sms) {
  for (int U : kUnitChoices)
    if ((H + U - 1) / U <= sms) return U;
  return 0;
}

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t lstm_seq_bwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// gates [T, B, 4H] (post-activation), cseq and cprev [T, B, H], w [4H, H]
// (W_hh), dout [T, B, H], dhT and dcT [B, H]; outputs dxp [T, B, 4H], dh0 and
// dc0 [B, H]. All float32, contiguous, on card `device`; U units per block,
// one of lstm_seq_bwd_units_per_block's answers. bf16 != 0 rounds the gate
// gradients and W_hh to bf16 as product operands. Launches on `stream`;
// returns the cudaError_t of the launch.
int lstm_seq_bwd(const void* gates, const void* cseq, const void* cprev, const void* w,
                 const void* dout, const void* dhT, const void* dcT, void* dxp, void* dh0,
                 void* dc0, int T, int B, int H, int U, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(cseq),
                       static_cast<const float*>(cprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT),
                       static_cast<const float*>(dcT)};
  float* pdxp = static_cast<float*>(dxp);
  float* pdh0 = static_cast<float*>(dh0);
  float* pdc0 = static_cast<float*>(dc0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (U) {
    case 4:
      err = launch<4>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], pdxp, pdh0, pdc0, T, B, H,
                      bf16, st);
      break;
    case 8:
      err = launch<8>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], pdxp, pdh0, pdc0, T, B, H,
                      bf16, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
