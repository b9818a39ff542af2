// Per-layer GRU sequence backward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_gru.py::_bwd_kernel (launched by _run_backward).
// The reverse sweep of gru_seq_fwd.cu. With iterations it = 0..T and the
// step t = T-1-it:
//
//   dprev = dhT                                        (it = 0)
//         = carry + [dr_pre | dz_pre | dghn][t + 1] @ W_hh   (it > 0; dh0 at t = -1)
//   dh     = dprev + dout[t]
//   dz     = dh * (h_{t-1} - n) ;  dn_pre = dh * (1 - z) * (1 - n^2)
//   dghn   = dn_pre * r ;  dr_pre = dn_pre * gh_n * r * (1 - r) ;  dz_pre = dz * z * (1 - z)
//   carry  = dh * z
//
// on the stored post-activation r, z, n, gh_n and h_{t-1}. dxp[t] is
// [dr_pre | dz_pre | dn_pre] (what x_proj's W_ih and b_ih take); the
// recurrent product takes [dr_pre | dz_pre | dghn], whose n-column is
// dn_pre * r, and dghn[t] is stored too (dW_hh and db_hh are reductions of it
// outside the kernel, as in JAX). Everything read and written is float32;
// with bf16 != 0 the recurrent gate gradients and W_hh are rounded to bf16
// as operands of the product, and nothing is stored rounded, as the TPU
// kernel does.
//
// Design (that of lstm_seq_bwd.cu with a two-part operand):
//  - One persistent cooperative launch; one grid-wide barrier between
//    iterations (T of them). Block b owns U hidden units j in [U*b, U*b + U)
//    and keeps the columns j of W_hh (3H x U values, float32) resident in
//    shared memory for the whole launch, so it forms the recurrent dh[:, j]
//    and runs the gate backward for its units by itself. U is 4 or 8, the
//    fewer that keeps one block per SM (gru_seq_bwd_units_per_block): 4 up
//    to H = 528 on 132 SMs, 8 up to 1056.
//  - The exchange between blocks is the outputs themselves: iteration it + 1
//    reads the operand row of step t + 1 from the dxp output (its r and z
//    columns) and the dghn output (its n column), written one iteration
//    earlier, so no exchange buffer is needed. Operand k in [0, 3H) is
//    dxp[.., k] for k < 2H and dghn[.., k - 2H] above. Rows are read with
//    __ldcg (L2, not the incoherent L1) straight into registers, as 16-byte
//    chunks when H % 4 == 0 (every chunk then lies inside one of the two
//    outputs and is aligned), as single floats otherwise.
//  - Per pass of up to 16 batch rows, thread (row group of 16/U rows,
//    k-slice) accumulates a (16/U)-row x U-unit register tile against the
//    weight columns (laid out so a warp's float4 reads are contiguous). A
//    warp reduce-scatter leaves the 16 sums with lanes 0-15; four warps'
//    partials are summed through shared memory by the thread that runs the
//    gate backward for that (row, unit).
//  - The carry dh * z lives in the dh0 output: only the owning thread reads
//    and writes it, and after t = 0 it holds dh0. The gate inputs are loaded
//    before the products so that their loads overlap them.
//
// Bounds on an H100 SXM at the MSVD width (H = 512), B = 16, T = 159
// (training), float32:
//  - bytes: gates and dxp ([T, B, 3H] each, 15.6 MB each), gh_n, h_{t-1},
//    dout and dghn ([T, B, H], 5.2 MB each), W_hh 3 MB: ~55 MB -> ~16 us at
//    3.35 TB/s;
//  - operations: 2*T*B*3H*H = 4.0 GFLOP -> ~60 us at the 67 TFLOP/s float32
//    peak. The operations set the bound (in bf16, at the tensor-core peak,
//    the bytes).
//  - In practice neither: the floor is the chain of T + 1 dependent
//    iterations, each ending in a grid-wide barrier and starting with a
//    re-read of [B, 3H] gate gradients from L2 in every block.
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

// 16-byte chunks of a [3H] operand row.
__host__ __device__ inline int chunks_for(int H) { return (3 * H + 3) / 4; }

size_t smem_floats(int H, int U) {
  return (size_t)4 * chunks_for(H) * U + (kThreads / 32) * kVals;   // weight columns + partials
}

// Operand values k0 .. k0 + 3 of one row: dxp row x (its first 2H values),
// then dghn row n (H values), then zeros up to the chunk's end.
__device__ __forceinline__ float4 load_chunk(const float* x, const float* n, int k0, int H,
                                             bool vec) {
  if (vec) {   // H % 4 == 0: the chunk lies inside one of the two rows, aligned
    return k0 < 2 * H ? __ldcg(reinterpret_cast<const float4*>(x + k0))
                      : __ldcg(reinterpret_cast<const float4*>(n + k0 - 2 * H));
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + q;
    v[q] = k < 2 * H ? __ldcg(x + k) : (k < 3 * H ? __ldcg(n + k - 2 * H) : 0.f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ ghn,
                   const float* __restrict__ hprev, const float* __restrict__ w,
                   const float* __restrict__ dout, const float* __restrict__ dhT, float* dxp,
                   float* dghn, float* dh0, int T, int B, int H, int bf16) {
  constexpr int kRows = kVals / kUnits;            // batch rows per thread
  constexpr int kGroups = kRowTile / kRows;        // row groups per pass
  constexpr int kSlices = kThreads / kGroups;      // k-slices per row group
  constexpr int kWarpsPerGroup = kSlices / 32;
  static_assert(kRows * kUnits == kVals && kUnits % 4 == 0, "float4 weight reads");
  static_assert(kSlices % 32 == 0, "a warp lies inside one row group");
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int nchunk = chunks_for(H);
  const bool vec = (H & 3) == 0;
  float* wsm = smem;                             // [4][nchunk][kUnits]
  float* red = wsm + (size_t)4 * nchunk * kUnits;  // [kThreads / 32][kVals]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kUnits;

  // Resident weight columns: wsm[(q*nchunk + ch)*kUnits + u] = W_hh[ch*4 + q, j0 + u]
  // (zero past row 3H), so that for one q a warp reading consecutive chunks
  // reads consecutive float4s.
  for (int idx = tid; idx < 4 * nchunk * kUnits; idx += kThreads) {
    const int u = idx % kUnits;
    const int r = idx / kUnits;                  // operand row g' = ch*4 + q
    const int ch = r / 4, q = r % 4;
    const int j = j0 + u;
    const float v = j < H && r < G ? w[(size_t)r * H + j] : 0.0f;
    wsm[((size_t)q * nchunk + ch) * kUnits + u] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  const int grp = tid / kSlices, slice = tid % kSlices;
  // The gate backward this thread runs in each pass (threads below
  // kGroups * kVals): partial index cv = m * kUnits + u of row group cgrp.
  const int cgrp = tid / kVals, cv = tid % kVals;
  const int cm = cv / kUnits, cu = cv % kUnits;
  const int cj = j0 + cu;

  for (int it = 0; it <= T; ++it) {
    const int t = T - 1 - it;                    // step; -1 in the last iteration

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      // Gate inputs first: their loads overlap the products.
      const int cb = b0 + cgrp * kRows + cm;
      const bool cell = tid < kGroups * kVals && cb < B && cj < H;
      const size_t crow = (size_t)cb * H + cj;
      float rg = 0.f, zg = 0.f, ng = 0.f, gn = 0.f, hp = 0.f, dh = 0.f, carry = 0.f;
      if (cell && t >= 0) {
        const size_t grow = ((size_t)t * B + cb) * G + cj;
        rg = gates[grow];
        zg = gates[grow + H];
        ng = gates[grow + 2 * H];
        const size_t trow = (size_t)t * B * H + crow;
        gn = ghn[trow];
        hp = hprev[trow];
        dh = dout[trow];
      }
      if (cell && it > 0) carry = dh0[crow];

      float acc[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      if (it > 0) {
        // Rows b0 + grp*kRows + n of step t + 1's operand, as 16-byte chunks.
        const int rb0 = b0 + grp * kRows;
        const float* xr = dxp + ((size_t)(t + 1) * B + rb0) * G;
        const float* nr = dghn + ((size_t)(t + 1) * B + rb0) * H;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int ch = slice; ch < nchunk; ch += kSlices) {
          float4 r[kRows];
#pragma unroll
          for (int n = 0; n < kRows; ++n)
            r[n] = rb0 + n < B ? load_chunk(xr + (size_t)n * G, nr + (size_t)n * H, 4 * ch, H, vec)
                               : zero;
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
      __syncthreads();   // the previous pass's gate threads have read `red`
      if (lane < kVals) red[warp * kVals + lane] = acc[0];
      __syncthreads();

      if (cell) {
        float dprev;   // dh from the step after t
        if (it == 0) {
          dprev = dhT[crow];
        } else {
          float rec = 0.f;
#pragma unroll
          for (int k = 0; k < kWarpsPerGroup; ++k) rec += red[(cgrp * kWarpsPerGroup + k) * kVals + cv];
          dprev = carry + rec;
        }
        if (t < 0) {
          dh0[crow] = dprev;
        } else {
          dh += dprev;
          const float dz = dh * (hp - ng);
          const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
          const size_t grow = ((size_t)t * B + cb) * G + cj;
          dxp[grow] = dn_pre * gn * rg * (1.0f - rg);
          dxp[grow + H] = dz * zg * (1.0f - zg);
          dxp[grow + 2 * H] = dn_pre;
          dghn[(size_t)t * B * H + crow] = dn_pre * rg;
          dh0[crow] = dh * zg;
        }
      }
    }
    if (it < T) grid.sync();
  }
}

template <int kUnits>
cudaError_t launch(const float* gates, const float* ghn, const float* hprev, const float* w,
                   const float* dout, const float* dhT, float* dxp, float* dghn, float* dh0,
                   int T, int B, int H, int bf16, cudaStream_t stream) {
  const size_t smem = smem_floats(H, kUnits) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_seq_bwd_kernel<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &ghn, &hprev, &w, &dout, &dhT, &dxp,
                  &dghn,  &dh0, &T,     &B, &H,    &bf16};
  const dim3 grid((H + kUnits - 1) / kUnits), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)gru_seq_bwd_kernel<kUnits>, grid, block, args,
                                     smem, stream);
}

}  // namespace

extern "C" {

// Hidden units each block owns for hidden size H on a card with `sms` SMs:
// the fewest instantiated count that keeps one block per SM, or 0 if none does.
int gru_seq_bwd_units_per_block(int H, int sms) {
  for (int U : kUnitChoices)
    if ((H + U - 1) / U <= sms) return U;
  return 0;
}

// Dynamic shared memory one block needs for hidden size H and U units per block.
size_t gru_seq_bwd_smem_bytes(int H, int U) { return smem_floats(H, U) * sizeof(float); }

// gates [T, B, 3H] (post-activation r, z, n), ghn, hprev and dout [T, B, H],
// w [3H, H] (W_hh), dhT [B, H]; outputs dxp [T, B, 3H], dghn [T, B, H] and
// dh0 [B, H]. All float32, contiguous, on card `device`; U units per block,
// one of gru_seq_bwd_units_per_block's answers. bf16 != 0 rounds the
// recurrent gate gradients and W_hh to bf16 as product operands. Launches on
// `stream`; returns the cudaError_t of the launch.
int gru_seq_bwd(const void* gates, const void* ghn, const void* hprev, const void* w,
                const void* dout, const void* dhT, void* dxp, void* dghn, void* dh0, int T,
                int B, int H, int U, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(gates), static_cast<const float*>(ghn),
                       static_cast<const float*>(hprev), static_cast<const float*>(w),
                       static_cast<const float*>(dout),  static_cast<const float*>(dhT)};
  float* pdxp = static_cast<float*>(dxp);
  float* pdghn = static_cast<float*>(dghn);
  float* pdh0 = static_cast<float*>(dh0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (U) {
    case 4:
      err = launch<4>(in[0], in[1], in[2], in[3], in[4], in[5], pdxp, pdghn, pdh0, T, B, H, bf16,
                      st);
      break;
    case 8:
      err = launch<8>(in[0], in[1], in[2], in[3], in[4], in[5], pdxp, pdghn, pdh0, T, B, H, bf16,
                      st);
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
