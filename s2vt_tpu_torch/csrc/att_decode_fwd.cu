// Attention-decoder sequence forward for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_att_decode.py::_kernel (launched by
// att_decode_sequence_pallas). The attention baseline's teacher-forced
// decoder loop, from h = c = 0 and ctx = ctx0, for t = 0 .. T-1:
//
//   gates = xp_t + ctx @ W_ctx^T + h @ W_hh^T      (xp_t carries the embedding
//                                                   half of W_ih, b_ih and b_hh)
//   c, h  = LSTM cell (i, f, g, o) of gates and c
//   dw    = h @ W_att^T + b_att                          [B, H]
//   et    = sum_H tanh(enc_wh + dw[:, None]) * w_apply   [B, L]
//   ctx   = sum_L softmax_L(et)[:, :, None] * enc_out    [B, 2H]
//   out_t = h
//
// Everything it reads and writes is float32. With bf16 != 0 it rounds to
// bf16 exactly what the TPU kernel rounds: W_ctx, W_hh and W_att; enc_wh and
// enc_out (stored values there, rounded here as they are read); the operands
// ctx and h of the gate products and h of the dw product. The w_apply
// reduction, the softmax and all state stay float32.
//
// Design:
//  - One persistent cooperative launch, ceil(H / U) blocks (one per SM), each
//    owning hidden units j in [b*U, b*U + U). The block keeps the 4*U gate
//    rows of [W_ctx | W_hh] (3H values each) and the U rows of W_att resident
//    in shared memory for the whole launch.
//  - A step needs all of h (for dw), then all of et for each batch row (the
//    softmax over L), then all of ctx (the next gates). Each is made by all
//    blocks together, so a step has four phases and a grid barrier after
//    each of the first three and after the step:
//      A  gates and cell of the owned units (all B rows): h_t -> out[t]
//      B  dw of the owned units                          -> dw scratch
//      C  et: one warp per (row, position) pair over all H -> et scratch
//      D  softmax over L of every row, and the owned 2U columns of ctx
//                                                        -> ctx scratch
//    The last step stops after A (its ctx is never used): 4 (T - 1) grid
//    barriers in all.
//  - Why not fewer barriers: phase C could instead sum partial scores over
//    each block's own units, but those partials then have to be summed
//    across blocks, either with float atomics into et, whose order (and so
//    whose result) changes from run to run, or by a reduction that needs the
//    same barrier. Phase C as written gives every score one owner and the
//    kernel is deterministic.
//  - Exchanged values (h, ctx, dw, et) are read after the barrier through L2
//    with __ldcg, never the incoherent L1. c is read back only by the thread
//    that wrote it. enc_wh and enc_out never change during the launch and
//    are read with __ldg; they are not resident: at B = 96 they are 47 MB.
//  - Products on the CUDA cores in float32 (no tensor cores in this version):
//    a warp per (unit, group of 4 rows) item with a 4-gate x 4-row register
//    tile and a warp reduce-scatter, as in lstm_seq_fwd.cu.
//
// Bounds on an H100 SXM at the MSVD width (H = 512, L = 80), B = 16, T = 79,
// float32: 2*B*(2H*4H + H*4H + H*H) + 8*B*L*H = 114 MFLOP per step, 9.0 GFLOP
// in all -> ~135 us at the 67 TFLOP/s float32 peak; the weights, enc_wh,
// enc_out, xp and out are ~34 MB -> ~10 us at 3.35 TB/s. The operations set
// the bound. In practice the floor is the chain of T steps of four dependent
// phases, each ending in a grid-wide barrier; the design keeps the weights in
// shared memory and moves only [B, 3H] of state per block per step.
// chip_smoke.py recomputes these figures from the shapes it runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBlock = 4;          // batch rows per warp item (register tile)
constexpr int kVals = 4 * kRowBlock;  // sums per item: 4 gates x 4 rows
constexpr int kMaxThreads = 512;
constexpr int kMaxUnits = 16;         // 2U context columns per block fit one warp

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float rd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

int warps_for(int U, int R) {
  const int w = U * (R / kRowBlock);
  return w < kMaxThreads / 32 ? w : kMaxThreads / 32;
}

// Shared memory of one block, in floats, for hidden size H, L encoder
// positions, U units per block and tiles of R batch rows.
size_t smem_floats(int H, int L, int U, int R) {
  return (size_t)12 * U * H                      // [W_ctx | W_hh] gate rows
         + (size_t)U * H + H                     // W_att rows, w_apply
         + (size_t)R * 3 * H                     // [ctx | h] tile
         + (size_t)U * (R / kRowBlock) * kVals   // item sums
         + (size_t)warps_for(U, R) * L;          // softmax weights, one row per warp
}

__device__ __forceinline__ float4 rd4(float4 v, int bf16) {
  return make_float4(rd(v.x, bf16), rd(v.y, bf16), rd(v.z, bf16), rd(v.w, bf16));
}

// Stages rows [b0, b0 + bt) of [a | h] into dst (row stride wa + wh): the wa
// columns of each row from a (row stride wa), the wh columns from h (row
// stride wh; zeros where h is null), read through L2 and rounded to bf16 when
// bf16 != 0. float4 copies (wa, wh multiples of 4), four loads in flight per
// thread before any store.
__device__ __forceinline__ void stage_rows(float* dst, const float* a, int wa, const float* h,
                                           int wh, int b0, int bt, int bf16, int tid, int nthr) {
  const int w4 = (wa + wh) / 4, a4 = wa / 4;
  const int n4 = bt * w4;
  for (int i0 = tid; i0 < n4; i0 += 4 * nthr) {
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * nthr;
      v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i >= n4) continue;
      const int b = b0 + i / w4, c4 = i % w4;
      if (c4 < a4)
        v[q] = __ldcg(reinterpret_cast<const float4*>(a + (size_t)b * wa) + c4);
      else if (h != nullptr)
        v[q] = __ldcg(reinterpret_cast<const float4*>(h + (size_t)b * wh) + c4 - a4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i0 + q * nthr < n4) reinterpret_cast<float4*>(dst)[i0 + q * nthr] = rd4(v[q], bf16);
  }
}

// The same with single floats, for widths that are not multiples of 4.
__device__ __forceinline__ void stage_rows1(float* dst, const float* a, int wa, const float* h,
                                            int wh, int b0, int bt, int bf16, int tid,
                                            int nthr) {
  const int w = wa + wh;
  for (int i = tid; i < bt * w; i += nthr) {
    const int b = b0 + i / w, c = i % w;
    float v = 0.0f;
    if (c < wa)
      v = __ldcg(a + (size_t)b * wa + c);
    else if (h != nullptr)
      v = __ldcg(h + (size_t)b * wh + c - wa);
    dst[i] = rd(v, bf16);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
att_decode_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ wctx,
                      const float* __restrict__ whh, const float* __restrict__ watt,
                      const float* __restrict__ batt, const float* __restrict__ wapp,
                      const float* __restrict__ encwh, const float* __restrict__ encout,
                      const float* __restrict__ ctx0, float* out, float* scratch, int T, int B,
                      int H, int L, int U, int R, int bf16) {
  extern __shared__ float smem[];
  const int K = 3 * H, H2 = 2 * H, G = 4 * H;
  float* wsm = smem;                                  // [U][4][K]
  float* wat = wsm + (size_t)12 * U * H;              // [U][H]
  float* wap = wat + (size_t)U * H;                   // [H]
  float* zsm = wap + H;                               // [R][K]
  float* red = zsm + (size_t)R * K;                   // [U * R/4][16]
  float* att = red + (size_t)U * (R / kRowBlock) * kVals;  // [warps][L]
  // Scratch, each part 16-byte aligned where H % 4 == 0 (et, of any size, last).
  float* ctxb = scratch;                              // [B, 2H]
  float* cbuf = ctxb + (size_t)B * H2;                // [B, H]  c, owner thread only
  float* dwb = cbuf + (size_t)B * H;                  // [B, H]
  float* etb = dwb + (size_t)B * H;                   // [B, L]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int j0 = blockIdx.x * U;

  // Resident weights: wsm[(u*4 + g)*K + k] = [W_ctx | W_hh][g*H + j0 + u, k];
  // wat[u*H + k] = W_att[j0 + u, k].
  for (int idx = tid; idx < 4 * U * K; idx += nthr) {
    const int k = idx % K, r = idx / K;
    const int g = r % 4, j = j0 + r / 4;
    float v = 0.0f;
    if (j < H)
      v = k < H2 ? wctx[(size_t)(g * H + j) * H2 + k] : whh[(size_t)(g * H + j) * H + k - H2];
    wsm[idx] = rd(v, bf16);
  }
  for (int idx = tid; idx < U * H; idx += nthr) {
    const int j = j0 + idx / H;
    wat[idx] = j < H ? rd(watt[(size_t)j * H + idx % H], bf16) : 0.0f;
  }
  for (int k = tid; k < H; k += nthr) wap[k] = wapp[k];

  int cw = 1;  // lanes per context row in phase D: a power of two >= 2U
  while (cw < 2 * U) cw <<= 1;

  for (int t = 0; t < T; ++t) {
    const float* hin = t == 0 ? nullptr : out + (size_t)(t - 1) * B * H;
    const float* cin = t == 0 ? ctx0 : ctxb;

    // A: gates and cell of the owned units, in tiles of R rows.
    for (int b0 = 0; b0 < B; b0 += R) {
      const int bt = min(R, B - b0);
      const int nbg = (bt + kRowBlock - 1) / kRowBlock;
      const int items = U * nbg;

      __syncthreads();  // weights loaded / the previous tile's readers done
      if ((H & 3) == 0)
        stage_rows(zsm, cin, H2, hin, H, b0, bt, bf16, tid, nthr);
      else
        stage_rows1(zsm, cin, H2, hin, H, b0, bt, bf16, tid, nthr);
      __syncthreads();

      for (int item = warp; item < items; item += nwarps) {
        const int bg = item % nbg, u = item / nbg;
        const float* wu = wsm + (size_t)u * 4 * K;
        const float* zr[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) zr[n] = zsm + (size_t)min(bg * kRowBlock + n, bt - 1) * K;
        float acc[kVals];
#pragma unroll
        for (int i = 0; i < kVals; ++i) acc[i] = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const float w0 = wu[k], w1 = wu[K + k], w2 = wu[2 * K + k], w3 = wu[3 * K + k];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            const float zv = zr[n][k];
            acc[0 * kRowBlock + n] = fmaf(w0, zv, acc[0 * kRowBlock + n]);
            acc[1 * kRowBlock + n] = fmaf(w1, zv, acc[1 * kRowBlock + n]);
            acc[2 * kRowBlock + n] = fmaf(w2, zv, acc[2 * kRowBlock + n]);
            acc[3 * kRowBlock + n] = fmaf(w3, zv, acc[3 * kRowBlock + n]);
          }
        }
        reduce_scatter(acc, lane);
        if (lane < kVals) red[item * kVals + lane] = acc[0];
      }
      __syncthreads();

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
        const float c = fg * (t > 0 ? cbuf[crow] : 0.0f) + ig * gg;
        cbuf[crow] = c;
        out[(size_t)t * B * H + crow] = og * tanhf(c);
      }
    }
    if (t + 1 == T) break;
    grid.sync();

    // B: dw = h_t @ W_att^T + b_att for the owned units.
    const float* ht = out + (size_t)t * B * H;
    for (int b0 = 0; b0 < B; b0 += R) {
      const int bt = min(R, B - b0);
      const int nbg = (bt + kRowBlock - 1) / kRowBlock;
      __syncthreads();
      if ((H & 3) == 0)
        stage_rows(zsm, ht, H, nullptr, 0, b0, bt, bf16, tid, nthr);
      else
        stage_rows1(zsm, ht, H, nullptr, 0, b0, bt, bf16, tid, nthr);
      __syncthreads();
      for (int item = warp; item < U * nbg; item += nwarps) {
        const int bg = item % nbg, u = item / nbg, j = j0 + u;
        const float* wu = wat + (size_t)u * H;
        const float* zr[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) zr[n] = zsm + (size_t)min(bg * kRowBlock + n, bt - 1) * H;
        float acc[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) acc[n] = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const float w = wu[k];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) acc[n] = fmaf(w, zr[n][k], acc[n]);
        }
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) acc[n] = warp_sum(acc[n]);
        float v = acc[0];
#pragma unroll
        for (int n = 1; n < kRowBlock; ++n) v = lane == n ? acc[n] : v;
        const int r = bg * kRowBlock + lane;
        if (j < H && lane < kRowBlock && r < bt) dwb[(size_t)(b0 + r) * H + j] = v + batt[j];
      }
    }
    grid.sync();

    // C: et[b, l] = sum_j tanh(enc_wh[b, l, j] + dw[b, j]) * w_apply[j],
    // one warp per (b, l) pair; loads unrolled so that several are in flight.
    for (int p = blockIdx.x * nwarps + warp; p < B * L; p += gridDim.x * nwarps) {
      const float* ew = encwh + (size_t)p * H;
      const float* dw = dwb + (size_t)(p / L) * H;
      float acc = 0.0f;
      if ((H & 3) == 0) {
        const float4* ew4 = reinterpret_cast<const float4*>(ew);
        const float4* dw4 = reinterpret_cast<const float4*>(dw);
        const float4* wa4 = reinterpret_cast<const float4*>(wap);
#pragma unroll 4
        for (int k = lane; k < H / 4; k += 32) {
          const float4 e = __ldg(ew4 + k), d = __ldcg(dw4 + k), w = wa4[k];
          acc = fmaf(tanhf(rd(e.x, bf16) + d.x), w.x, acc);
          acc = fmaf(tanhf(rd(e.y, bf16) + d.y), w.y, acc);
          acc = fmaf(tanhf(rd(e.z, bf16) + d.z), w.z, acc);
          acc = fmaf(tanhf(rd(e.w, bf16) + d.w), w.w, acc);
        }
      } else {
#pragma unroll 4
        for (int k = lane; k < H; k += 32)
          acc = fmaf(tanhf(rd(__ldg(ew + k), bf16) + __ldcg(dw + k)), wap[k], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) etb[p] = acc;
    }
    grid.sync();

    // D: softmax over L of every row, then the block's 2U context columns:
    // lane = (position group, column), cw lanes per position.
    float* aw = att + (size_t)warp * L;
    const int cc = lane % cw, lg = lane / cw, ng = 32 / cw;
    const int col = 2 * U * blockIdx.x + cc;
    const bool live = cc < 2 * U && col < H2;
    for (int b = warp; b < B; b += nwarps) {
      const float* e = etb + (size_t)b * L;
      float m = __int_as_float(0xff800000);  // -inf
      for (int l = lane; l < L; l += 32) m = fmaxf(m, __ldcg(e + l));
      m = warp_max(m);
      float s = 0.0f;
      for (int l = lane; l < L; l += 32) {
        const float x = expf(__ldcg(e + l) - m);
        aw[l] = x;
        s += x;
      }
      s = warp_sum(s);
      __syncwarp();
      float acc = 0.0f;
      if (live) {
        const float* eo = encout + (size_t)b * L * H2 + col;
        int l = lg;
        for (; l + 3 * ng < L; l += 4 * ng) {  // four loads in flight
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q] = __ldg(eo + (size_t)(l + q * ng) * H2);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc = fmaf(aw[l + q * ng] / s, rd(x[q], bf16), acc);
        }
        for (; l < L; l += ng) acc = fmaf(aw[l] / s, rd(__ldg(eo + (size_t)l * H2), bf16), acc);
      }
      for (int off = cw; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (live && lg == 0) ctxb[(size_t)b * H2 + col] = acc;
      __syncwarp();  // aw is rewritten for the warp's next row
    }
    grid.sync();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (see smem_floats).
size_t att_decode_fwd_smem_bytes(int H, int L, int U, int R) {
  return smem_floats(H, L, U, R) * sizeof(float);
}

// Rows per batch tile for hidden size H, L positions and U units per block:
// the largest of 16, 8 and 4 whose block fits in smem_limit bytes, or 0 if
// none does (or U is too large for one warp to hold a row's 2U context
// columns).
int att_decode_fwd_tile_rows(int H, int L, int U, size_t smem_limit) {
  if (U < 1 || U > kMaxUnits) return 0;
  for (int R = 16; R >= kRowBlock; R /= 2)
    if (smem_floats(H, L, U, R) * sizeof(float) <= smem_limit) return R;
  return 0;
}

// xp [T, B, 4H]; wctx [4H, 2H], whh [4H, H], watt [H, H] (torch [out, in]
// layout); batt, wapp [H]; encwh [B, L, H]; encout [B, L, 2H]; ctx0 [B, 2H];
// out [T, B, H]; scratch [B * (4H + L)] floats. All float32, contiguous,
// 16-byte aligned, on card `device`. U units per block, R rows per tile (from
// att_decode_fwd_tile_rows). bf16 != 0 rounds as the TPU kernel does.
// Launches on `stream`; returns the cudaError_t of the launch.
int att_decode_fwd(const void* xp, const void* wctx, const void* whh, const void* watt,
                   const void* batt, const void* wapp, const void* encwh, const void* encout,
                   const void* ctx0, void* out, void* scratch, int T, int B, int H, int L, int U,
                   int R, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(H, L, U, R) * sizeof(float);
  err = cudaFuncSetAttribute(att_decode_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* pxp = static_cast<const float*>(xp);
  const float* pwctx = static_cast<const float*>(wctx);
  const float* pwhh = static_cast<const float*>(whh);
  const float* pwatt = static_cast<const float*>(watt);
  const float* pbatt = static_cast<const float*>(batt);
  const float* pwapp = static_cast<const float*>(wapp);
  const float* pencwh = static_cast<const float*>(encwh);
  const float* pencout = static_cast<const float*>(encout);
  const float* pctx0 = static_cast<const float*>(ctx0);
  float* pout = static_cast<float*>(out);
  float* pscratch = static_cast<float*>(scratch);
  void* args[] = {&pxp,  &pwctx, &pwhh,    &pwatt, &pbatt, &pwapp, &pencwh, &pencout, &pctx0,
                  &pout, &pscratch, &T,    &B,     &H,     &L,     &U,      &R,       &bf16};
  const dim3 grid((H + U - 1) / U), block(32 * warps_for(U, R));
  err = cudaLaunchCooperativeKernel((const void*)att_decode_fwd_kernel, grid, block, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
