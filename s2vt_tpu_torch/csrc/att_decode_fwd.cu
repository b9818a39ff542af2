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
// Three routes, chosen by the caller before the launch
// (ops/fused_att_decode.py::att_decode_fwd_route): "mma" (below, after the
// direct kernel: the context product folded into one batched tensor-core
// product off the step chain, batch groups, three step-tagged exchanges per
// step and no grid barrier) for the shapes where it was measured faster,
// "direct" for every other shape whose weights fit its blocks' shared
// memory, and "stream" (last: four launches per step on stream.cuh's
// products, the weights read from global memory) for the widths beyond.
//
// "direct" route.
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
#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "exchange.cuh"
#include "mma.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBlock = 4;          // batch rows per warp item (register tile)
constexpr int kVals = 4 * kRowBlock;  // sums per item: 4 gates x 4 rows
constexpr int kMaxThreads = 512;
constexpr int kMaxUnits = 16;         // 2U context columns per block fit one warp

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float rd(float v, int bf16) {
  return bf16 ? round_bf16(v) : v;
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


// ---------------------------------------------------------------------------
// "mma" route. Replaces the same TPU kernel (pallas_att_decode.py::_kernel)
// for the shapes ops/fused_att_decode.py::att_decode_fwd_route sends here. On
// an H100 the direct route's step goes to its four grid barriers, every
// block's staging of all of [ctx | h] from L2, the thin context product on
// the CUDA cores and the column reads of enc_out. This route:
//
//  - Folds the context product out of the loop. ctx enters the loop only
//    through ctx @ W_ctx^T, and ctx = sum_l a[b, l] enc_out[b, l, :], so
//    ctx @ W_ctx^T = sum_l a[b, l] P[b, l, :] with P = enc_out @ W_ctx^T
//    [B, L, 4H]: the operations of the loop's T context products (L = T + 1
//    at the MSVD length), but in one batched product that fills the tensor
//    cores, off the step chain. A first launch (att_decode_fwd_kernel_fold)
//    forms P, and ctx0 @ W_ctx^T as B more rows, in float32: in bf16 mode on
//    mma.sync m16n8k16 from enc_out, ctx0 and W_ctx rounded as the TPU
//    kernel rounds them (the loop's ctx itself is never formed, so it is not
//    rounded: the fold is the float32 ctx's product), in float32 as 3xTF32
//    on m16n8k8, each k slice's three products into a fresh partial. Its
//    columns come in the loop's order, block p's 4U gate columns (unit-major:
//    the four gates of a unit side by side) contiguous: P is [H/U][BL + B][4U].
//  - Splits the batch into groups. The grid is G groups of H / U blocks;
//    block p of group q runs the cells of units [p U, p U + U) for the
//    group's R rows and keeps resident in shared memory, in the operand
//    type, the 4U gate rows of W_hh and the U rows of W_att (5 U H values:
//    with W_ctx out of the loop float32 takes U = 8), the group's [R, L, 4U]
//    slice of P where it fits (float32), and the enc_wh rows of the (b, l)
//    score pairs it owns where they fit; what does not fit is read from
//    device memory every step. ops/fused_att_decode.py::att_decode_plan
//    picks U, G, the m16 tiles per pass and what is resident.
//  - Exchanges three things per step within a group, as 8-byte step-tagged
//    words (exchange.cuh), with no grid barrier and no flag; a block loads
//    the words it polls 16 bytes at a time until all carry the step's tag,
//    and a poll that waits kSpinLimitNs of wall time traps:
//      h_t  (H per row; two bf16 operands per word in bf16 mode). Each block
//           stages its group's rows and forms, in one pass over them on the
//           tensor cores ([R -> m16 tiles, H] x [H, 5U]: bf16 on m16n8k16,
//           float32 as 3xTF32 on m16n8k8, k split over the 8 warps, the
//           shares added in order; tools/att_decode_variants.py's
//           ``w_as_a``, W x h^T with 8 rows filling an n8 tile, measured
//           slower), dw_t of its U units and the h part of step t + 1's
//           gates of its 4U rows, which stays in shared memory.
//      dw_t (H per row, float32). Each block polls the rows of the score
//           pairs it owns (one owner per score: deterministic, no atomics)
//           and forms et = sum_j tanh(enc_wh + dw) w_apply, a warp per pair,
//           two pairs per warp in flight (tanh from __expf:
//           tools/att_decode_variants.py's ``tanhf`` measured the library's
//           slower).
//      et_t (L per row). Each block polls its group's rows, forms the
//           softmax over L of each (the same way in every block) and
//           a_t . P of its 4U columns (each cell in four lanes, L split over
//           them; the lane of gate g then forms it from x_proj, the fold
//           and the h part), runs its cells (c in shared memory, read back
//           by the thread that wrote it) and writes the h_{t+1} words, then
//           out.
//    Step 0's gates take ctx0's rows of P. A step's x_proj is copied into
//    shared memory by cp.async before its poll, so that it lands while the
//    block waits. The exchange buffers are zeroed per launch and double
//    buffered by step parity: no block writes step t + 2's words before
//    every block of its group has read step t's, since each exchange waits
//    for all of the group's blocks.
//  - Launches cooperatively, so every block is resident at once or the
//    launch fails.
//
// Bounds: chip_smoke.py::att_decode_bound_ms counts the function's work,
// with float32's products as three TF32 passes at the TF32 peak (this
// route's 3xTF32). In practice the chain of T
// steps, each three dependent exchanges with a product, the scores and the
// fold between them; and where P is not resident (B = 96), its slice read
// every step: 4 B L 4H bytes, 63 MB per step at B = 96. Block 0's clock
// cycles per step at H = 512, T = 79, L = 80 (tools/att_decode_variants.py,
// phase_clock), float32: B = 16 et poll 2959, cells 2111, h poll 3858,
// products 4645, dw poll 1574, scores 2530; B = 96 the cells (P streamed)
// 46013 of 104287.

namespace mma_route {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 4;                     // m16 row tiles staged per pass

// The fold's product: kPM x kPN output tiles, k in steps of kPK, the warps 2
// (rows) x kPWarpsN (columns), operands staged through registers into a
// double buffer in dynamic shared memory (tools/att_decode_variants.py's
// ``fold_128x128``, 8 warps of 64 x 32 that re-read half the L2 bytes,
// measured slower in float32 and no faster in bf16).
constexpr int kPM = 64, kPN = 64, kPK = 32, kPThreads = 128;
constexpr int kPWarpsN = kPThreads / 64;
constexpr int kPMI = kPM / 2 / 16, kPNI = kPN / kPWarpsN / 8;  // m16 / n8 tiles per warp
constexpr int kPLoads = kPM * kPK / 4 / kPThreads;             // float4s of a tile per thread
static_assert(kPLoads * kPThreads * 4 == kPN * kPK && kPK == 32, "A and W tiles load alike");

// The fold's dynamic shared memory: both tiles, double-buffered.
__host__ __device__ __forceinline__ size_t fold_smem_bytes(int bf16) {
  return (size_t)2 * (kPM + kPN) * (kPK + (bf16 ? 8 : 4)) * (bf16 ? 2 : 4);
}

template <int kBf16>
using Operand = typename std::conditional<kBf16 != 0, __nv_bfloat16, float>::type;

template <int kBf16>
__device__ __forceinline__ Operand<kBf16> operand(float v) {
  if constexpr (kBf16) return __float2bfloat16_rn(v);
  else return v;
}

// tanh(x) = 1 - 2 / (1 + e^{2x}) on the special-function unit: two MUFU
// operations and three others where tanhf takes some twenty; within ~2e-7
// of tanhf absolute (a score sums H of them, each times w_apply), and +-1
// past |x| ~ 44.
__device__ __forceinline__ float tanh_exp(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four floats into shared memory as operands: a float4, or four bf16.
__device__ __forceinline__ void put4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void put4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// P = [enc_out; ctx0] @ W_ctx^T: M = B L + B rows of K = 2H (enc_out's rows,
// then ctx0's), N = 4H columns in the loop's order: column n is entry w =
// n % 4U of block p = n / 4U, W_ctx row (w % 4) H + p U + w / 4. Writes
// pout[p][m][w], float32.
template <int kBf16>
__global__ void __launch_bounds__(kPThreads)
att_decode_fwd_kernel_fold(const float* __restrict__ encout, const float* __restrict__ ctx0,
                           const float* __restrict__ wctx, float* __restrict__ pout, int B,
                           int H, int L, int U) {
  using Elem = Operand<kBf16>;
  constexpr int kStride = kPK + (kBf16 ? 8 : 4);  // staged row, in elements (conflict-free)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem(*as)[kPM][kStride] = reinterpret_cast<Elem(*)[kPM][kStride]>(smem_raw);
  Elem(*ws)[kPN][kStride] =
      reinterpret_cast<Elem(*)[kPN][kStride]>(smem_raw + 2 * kPM * kStride * sizeof(Elem));
  const int BL = B * L, M = BL + B, K = 2 * H, U4 = 4 * U;
  const int m0 = blockIdx.x * kPM, n0 = blockIdx.y * kPN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / kPWarpsN, wn = warp % kPWarpsN;

  // This thread's kPLoads float4s of each tile: float4 i = tid + kPThreads j
  // is row i / 8, columns 4 (i % 8) to 4 (i % 8) + 3 of the k tile.
  const float* asrc[kPLoads];
  const float* wsrc[kPLoads];
#pragma unroll
  for (int j = 0; j < kPLoads; ++j) {
    const int i = tid + kPThreads * j, r = i >> 3, c = (i & 7) * 4;
    const int m = m0 + r;
    asrc[j] = m < BL ? encout + (size_t)m * K + c
                     : (m < M ? ctx0 + (size_t)(m - BL) * K + c : nullptr);
    const int n = n0 + r, p = n / U4, w = n - p * U4;
    wsrc[j] = wctx + (size_t)((w & 3) * H + p * U + (w >> 2)) * K + c;
  }
  float4 ra[kPLoads], rw[kPLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kPLoads; ++j) {
      ra[j] = asrc[j] ? __ldg(reinterpret_cast<const float4*>(asrc[j] + k0))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rw[j] = __ldg(reinterpret_cast<const float4*>(wsrc[j] + k0));
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kPLoads; ++j) {
      const int i = tid + kPThreads * j, r = i >> 3, c = (i & 7) * 4;
      put4(&as[buf][r][c], ra[j]);
      put4(&ws[buf][r][c], rw[j]);
    }
  };

  float acc[kPMI][kPNI][4];
#pragma unroll
  for (int mi = 0; mi < kPMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kPNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int ktiles = K / kPK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) fetch((kt + 1) * kPK);     // lands during this tile's products
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kPK; kk += 16) {
        uint32_t a[kPMI][4], b[kPNI][2];
#pragma unroll
        for (int mi = 0; mi < kPMI; ++mi) {
          const Elem* r0 = &as[buf][wm * (kPM / 2) + mi * 16 + g][kk + 2 * tig];
          const Elem* r1 = r0 + 8 * kStride;
          a[mi][0] = ld32(r0);
          a[mi][1] = ld32(r1);
          a[mi][2] = ld32(r0 + 8);
          a[mi][3] = ld32(r1 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < kPNI; ++ni) {
          const Elem* wr = &ws[buf][wn * (kPN / kPWarpsN) + ni * 8 + g][kk + 2 * tig];
          b[ni][0] = ld32(wr);
          b[ni][1] = ld32(wr + 8);
        }
#pragma unroll
        for (int mi = 0; mi < kPMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kPNI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    } else {
      // 3xTF32: small x big, big x small, big x big into a fresh partial per
      // k slice, added with round-to-nearest (the tensor cores truncate as
      // they accumulate).
#pragma unroll
      for (int kk = 0; kk < kPK; kk += 8) {
        uint32_t ab[kPMI][4], asml[kPMI][4], bb[kPNI][2], bs[kPNI][2];
#pragma unroll
        for (int mi = 0; mi < kPMI; ++mi) {
          const Elem* r0 = &as[buf][wm * (kPM / 2) + mi * 16 + g][kk + tig];
          const Elem* r1 = r0 + 8 * kStride;
          split_tf32(r0[0], ab[mi][0], asml[mi][0]);
          split_tf32(r1[0], ab[mi][1], asml[mi][1]);
          split_tf32(r0[4], ab[mi][2], asml[mi][2]);
          split_tf32(r1[4], ab[mi][3], asml[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < kPNI; ++ni) {
          const Elem* wr = &ws[buf][wn * (kPN / kPWarpsN) + ni * 8 + g][kk + tig];
          split_tf32(wr[0], bb[ni][0], bs[ni][0]);
          split_tf32(wr[4], bb[ni][1], bs[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < kPMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kPNI; ++ni) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, asml[mi], bb[ni]);
            mma_tf32(part, ab[mi], bs[ni]);
            mma_tf32(part, ab[mi], bb[ni]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[j];
          }
      }
    }
    if (kt + 1 < ktiles) stash(buf ^ 1);            // last read at kt - 1, before its barrier
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < kPMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kPNI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * (kPM / 2) + mi * 16 + g + 8 * half;
        if (m >= M) continue;
        const int n = n0 + wn * (kPN / kPWarpsN) + ni * 8 + 2 * tig, p = n / U4, w = n - p * U4;
        *reinterpret_cast<float2*>(pout + ((size_t)p * M + m) * U4 + w) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
}

template <int kBf16, int kU>
struct Tile {
  static constexpr int kN = (5 * kU + 7) / 8 * 8;  // weight rows: 4U gate rows, U dw rows, zeros
  static constexpr int kNT = kN / 8;                // n8 tiles over them
  static constexpr int kWarpsK = kWarps;            // k shares: one per warp
  static constexpr int kKStep = kBf16 ? 16 : 8;     // k per mma.sync
  static constexpr int kPad = kBf16 ? 8 : 4;        // 16 bytes per staged row
  static constexpr int kRedStride = kN + 4;         // k-share row, in floats
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of a block's shared memory, in order: the weight rows, the
// staged h rows, the k shares, the h part of the gates, x_proj, P's slice,
// the pairs' enc_wh rows, the polled dw rows, w_apply, the attention
// weights, c.
struct Smem {
  size_t w, h, red, hp, x, p, e, d, wap, a, c, end;
};

// For operand size es, kN weight columns and `shares` k shares; hidden size
// H, L positions, U units per block, R rows per group, rp rows staged per
// pass, Q score pairs per block spanning `span` rows; P's slice and enc_wh's
// pairs resident or not.
__host__ __device__ __forceinline__ Smem smem_layout(int es, int kN, int shares, int H, int L,
                                                     int U, int R, int rp, int Q, int span,
                                                     int p_res, int e_res) {
  const size_t stride = (size_t)H + (es == 2 ? 8 : 4);
  Smem s;
  size_t o = 0;
  s.w = o;   o = align16(o + (size_t)kN * stride * es);
  s.h = o;   o = align16(o + (size_t)rp * stride * es);
  s.red = o; o = align16(o + (size_t)shares * rp * (kN + 4) * 4);
  s.hp = o;  o = align16(o + (size_t)R * 4 * U * 4);
  s.x = o;   o = align16(o + (size_t)R * 4 * U * 4);
  s.p = o;   o = align16(o + (p_res ? (size_t)R * L * 4 * U * 4 : 0));
  s.e = o;   o = align16(o + (e_res ? (size_t)Q * H * 4 : 0));
  s.d = o;   o = align16(o + (size_t)span * H * 4);
  s.wap = o; o = align16(o + (size_t)H * 4);
  s.a = o;   o = align16(o + (size_t)R * L * 4);
  s.c = o;   o = align16(o + (size_t)R * U * 4);
  s.end = o;
  return s;
}

// Score pairs per block (of a group of R rows over `blocks` blocks) and the
// rows such a run of pairs can span.
__host__ __device__ __forceinline__ int pairs_per_block(int R, int L, int blocks) {
  return (R * L + blocks - 1) / blocks;
}
__host__ __device__ __forceinline__ int pair_span(int Q, int L, int R) {
  const int s = (Q + L - 2) / L + 1;
  return s < R ? s : R;
}

template <int kBf16, int kU>
__host__ __device__ __forceinline__ Smem block_smem(int H, int L, int R, int tiles, int p_res,
                                                    int e_res) {
  using C = Tile<kBf16, kU>;
  const int rp = R < 16 * tiles ? R : 16 * tiles;
  const int Q = pairs_per_block(R, L, H / kU);
  return smem_layout(kBf16 ? 2 : 4, C::kN, C::kWarpsK, H, L, kU, R, rp, Q, pair_span(Q, L, R),
                     p_res, e_res);
}

// Polls n2 16-byte pairs of exchange words, pair i at addr(i), until both
// words of every pair carry `tag`, kChunk pairs in flight per thread; then
// hands each pair's payloads to sink(i, lo, hi).
template <int kChunk, class Addr, class Sink>
__device__ __forceinline__ void poll_pairs(int n2, unsigned tag, int step, int row_pairs,
                                           Addr addr, Sink sink) {
  for (int i0 = threadIdx.x; i0 < n2; i0 += kChunk * kThreads) {
    unsigned long long v[kChunk][2];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      v[q][0] = v[q][1] = 0ull;
      if (i0 + q * kThreads < n2) ld_words(v[q], addr(i0 + q * kThreads));
    }
    unsigned long long start = 0;
    for (;;) {
      bool stale = false;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) stale |= i0 + q * kThreads < n2 && !tagged(v[q], tag);
      if (!stale) break;
      poll_round(start, "att_decode_fwd mma route", step, i0 / row_pairs);
#pragma unroll
      for (int q = 0; q < kChunk; ++q)                // every stale pair again, together
        if (i0 + q * kThreads < n2 && !tagged(v[q], tag)) ld_words(v[q], addr(i0 + q * kThreads));
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (i0 + q * kThreads < n2) sink(i0 + q * kThreads, (unsigned)v[q][0], (unsigned)v[q][1]);
  }
}

template <int kBf16, int kU>
__global__ void __launch_bounds__(kThreads, 1)
att_decode_fwd_kernel_mma(const float* __restrict__ xp, const float* __restrict__ whh,
                          const float* __restrict__ watt, const float* __restrict__ batt,
                          const float* __restrict__ wapp, const float* __restrict__ encwh,
                          const float* __restrict__ pbuf, float* __restrict__ out,
                          unsigned long long* words, int T, int B, int H, int L, int groups,
                          int tiles, int p_res, int e_res) {
  using C = Tile<kBf16, kU>;
  using Elem = Operand<kBf16>;
  constexpr int U4 = 4 * kU, U5 = 5 * kU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int P = gridDim.x / groups;                  // blocks per group
  const int p = blockIdx.x % P, j0 = p * kU;         // units [j0, j0 + U)
  const int R = (B + groups - 1) / groups;
  const int b0 = (blockIdx.x / P) * R;               // the group's rows [b0, b0 + rows)
  const int rows = min(R, B - b0);
  const int RP = min(R, 16 * tiles);                 // rows staged per pass
  const Smem lay = block_smem<kBf16, kU>(H, L, R, tiles, p_res, e_res);
  Elem* wsm = reinterpret_cast<Elem*>(smem_raw + lay.w);       // [kN][stride]
  Elem* hs = reinterpret_cast<Elem*>(smem_raw + lay.h);        // [RP][stride]
  float* red = reinterpret_cast<float*>(smem_raw + lay.red);   // [kWarpsK][RP][kRedStride]
  float* hp = reinterpret_cast<float*>(smem_raw + lay.hp);     // [R][4U]
  float* xsm = reinterpret_cast<float*>(smem_raw + lay.x);     // [R][4U]
  float* psm = reinterpret_cast<float*>(smem_raw + lay.p);     // [R][L][4U]
  float* esm = reinterpret_cast<float*>(smem_raw + lay.e);     // [Q][H]
  float* dsm = reinterpret_cast<float*>(smem_raw + lay.d);     // [span][H]
  float* wap = reinterpret_cast<float*>(smem_raw + lay.wap);   // [H]
  float* att = reinterpret_cast<float*>(smem_raw + lay.a);     // [R][L]
  float* csm = reinterpret_cast<float*>(smem_raw + lay.c);     // [R][U]
  const int stride = H + C::kPad;
  const int wrow = kBf16 ? H / 2 : H;                // h words per batch row
  unsigned long long* hw = words;                    // [2][B][wrow]
  unsigned long long* dww = hw + (size_t)2 * B * wrow;  // [2][B][H]
  unsigned long long* eww = dww + (size_t)2 * B * H;    // [2][B][L]

  // The block's columns of P and its group's rows of them; its score pairs
  // [pi0, pi1) of the group's rows x L (row-major), rows [r_lo, r_lo + nspan).
  const size_t M = (size_t)B * L + B;
  const float* pblk = pbuf + (size_t)p * M * U4;
  const float* pgrp = pblk + (size_t)b0 * L * U4;
  const float* pslice = p_res ? psm : pgrp;
  const int Qg = pairs_per_block(rows, L, P);
  const int pi0 = min(p * Qg, rows * L), pi1 = min(pi0 + Qg, rows * L);
  const int npairs = pi1 - pi0, r_lo = pi0 / L;
  const int nspan = npairs > 0 ? (pi1 - 1) / L - r_lo + 1 : 0;
  const float* ewh = encwh + ((size_t)b0 * L + pi0) * H;
  const float* eslice = e_res ? esm : ewh;

  // Resident: wsm[n * stride + k] = W_hh[(n % 4) H + j0 + n / 4, k] for n <
  // 4U, W_att[j0 + n - 4U, k] for n < 5U, zeros after; P's slice and the
  // pairs' enc_wh rows (rounded in bf16 mode) where they fit; w_apply; c = 0.
  for (int idx = tid; idx < C::kN * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H;
    float v = 0.0f;
    if (n < U4) v = whh[(size_t)((n & 3) * H + j0 + (n >> 2)) * H + k];
    else if (n < U5) v = watt[(size_t)(j0 + n - U4) * H + k];
    wsm[(size_t)n * stride + k] = operand<kBf16>(v);
  }
  if (p_res)
    for (int i = tid; i < rows * L * kU; i += kThreads)
      reinterpret_cast<float4*>(psm)[i] = __ldg(reinterpret_cast<const float4*>(pgrp) + i);
  if (e_res)
    for (int i = tid; i < npairs * H; i += kThreads) esm[i] = rd(__ldg(ewh + i), kBf16);
  for (int k = tid; k < H; k += kThreads) wap[k] = wapp[k];
  for (int i = tid; i < R * kU; i += kThreads) csm[i] = 0.0f;
  __syncthreads();

  const int ncell = rows * kU;
  const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(xsm);
  for (int t = 0; t < T; ++t) {
    // The step's x_proj, by cp.async: it lands while the block polls.
    for (int i = tid; i < rows * U4; i += kThreads) {
      const int r = i / U4, n = i - r * U4;
      cp_async4(xs_addr + 4 * i,
                xp + ((size_t)t * B + b0 + r) * (4 * H) + (n & 3) * H + j0 + (n >> 2));
    }
    cp_async_commit();
    if (t > 0) {
      // et_{t-1} of the group's rows.
      const unsigned long long* base = eww + ((size_t)((t - 1) & 1) * B + b0) * L;
      poll_pairs<4>(rows * L / 2, t, t - 1, L / 2,
                    [&](int i) { return base + 2 * i; },
                    [&](int i, unsigned lo, unsigned hi) {
                      *reinterpret_cast<float2*>(att + 2 * i) =
                          make_float2(__uint_as_float(lo), __uint_as_float(hi));
                    });
    }
    cp_async_wait<0>();
    __syncthreads();
    if (t > 0) {
      // Softmax over L of each row, in every block the same way.
      for (int r = warp; r < rows; r += kWarps) {
        float* e = att + r * L;
        float m = __int_as_float(0xff800000);        // -inf
        for (int l = lane; l < L; l += 32) m = fmaxf(m, e[l]);
        m = warp_max(m);
        float s = 0.0f;
        for (int l = lane; l < L; l += 32) {
          const float x = expf(e[l] - m);
          e[l] = x;
          s += x;
        }
        s = warp_sum(s);
        for (int l = lane; l < L; l += 32) e[l] = e[l] / s;
      }
      __syncthreads();
    }

    // The step's cells, each in four lanes of a warp (lanes i, i + 8, i + 16,
    // i + 24 run the warp's cell i): a_t . P over L split over the lanes
    // (step 0: ctx0's row of P), then gate q in lane q * 8 + i. Eight lanes
    // of one q read eight cells' float4s of one row l of P: 128 bytes, no
    // bank conflict.
    for (int c0 = 0; c0 < ncell; c0 += kThreads / 4) {
      const int c = c0 + warp * 8 + (lane & 7), q = lane >> 3;
      const bool valid = c < ncell;
      const int r = valid ? c / kU : 0, u = valid ? c - r * kU : 0;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (valid) {
        if (t == 0) {
          if (q == 0)
            acc = __ldg(reinterpret_cast<const float4*>(pblk + ((size_t)B * L + b0 + r) * U4) + u);
        } else {
          const float* ar = att + r * L;
          const float4* pr = reinterpret_cast<const float4*>(pslice + (size_t)r * L * U4) + u;
#pragma unroll 4
          for (int l = q; l < L; l += 4) {
            const float a = ar[l];
            const float4 v = pr[(size_t)l * kU];
            acc.x = fmaf(a, v.x, acc.x);
            acc.y = fmaf(a, v.y, acc.y);
            acc.z = fmaf(a, v.z, acc.z);
            acc.w = fmaf(a, v.w, acc.w);
          }
        }
      }
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
      }
      float act = 0.0f;
      if (valid) {
        const int n = r * U4 + u * 4 + q;
        const float fold = q == 0 ? acc.x : q == 1 ? acc.y : q == 2 ? acc.z : acc.w;
        const float pre = xsm[n] + fold + (t > 0 ? hp[n] : 0.0f);
        act = q == 2 ? tanhf(pre) : sigmoid_f(pre);
      }
      const int base = lane & 7;
      const float ig = __shfl_sync(0xffffffffu, act, base);
      const float fg = __shfl_sync(0xffffffffu, act, base + 8);
      const float gg = __shfl_sync(0xffffffffu, act, base + 16);
      const float og = __shfl_sync(0xffffffffu, act, base + 24);
      float h = 0.0f;
      if (valid && q == 0) {
        const float cc = fg * csm[c] + ig * gg;
        csm[c] = cc;
        h = og * tanhf(cc);
      }
      float h_next = 0.0f;                          // bf16: h of unit u + 1, same row
      if constexpr (kBf16) h_next = __shfl_down_sync(0xffffffffu, h, 1);
      if (valid && q == 0) {
        unsigned long long* word = hw + ((size_t)(t & 1) * B + b0 + r) * wrow;
        if constexpr (kBf16) {
          if ((u & 1) == 0)
            st_word(word + (j0 + u) / 2, __uint_as_float(pack_bf16(h, h_next)), t + 1);
        } else {
          st_word(word + j0 + u, h, t + 1);
        }
        out[((size_t)t * B + b0 + r) * H + j0 + u] = h;
      }
    }
    if (t == T - 1) break;                          // no later step reads this one's h

    // h_t of the group's rows, in passes of RP rows: dw_t of the block's
    // units goes out as words, the h part of step t + 1's gates into hp.
    for (int pr0 = 0; pr0 < rows; pr0 += RP) {
      const int rp = min(RP, rows - pr0);
      const unsigned long long* base = hw + ((size_t)(t & 1) * B + b0 + pr0) * wrow;
      poll_pairs<8>(rp * wrow / 2, t + 1, t, wrow / 2,
                    [&](int i) { return base + 2 * i; },
                    [&](int i, unsigned lo, unsigned hi) {
                      const int r = i / (wrow / 2), col = i - r * (wrow / 2);
                      *reinterpret_cast<uint2*>(hs + (size_t)r * stride + (kBf16 ? 4 : 2) * col) =
                          make_uint2(lo, hi);
                    });
      __syncthreads();                              // hs holds the pass's rows

      // Products, h x W^T: this warp's k share, every n8 tile of the weight
      // rows, m16 tile by tile; rows past the pass repeat its last row.
      {
        constexpr int kNTW = C::kNT;
        const int kshare = H / C::kWarpsK, kbeg = warp * kshare;
        float* rw = red + (size_t)warp * RP * C::kRedStride;
        for (int mt = 0; mt * 16 < rp; ++mt) {
          const Elem* h0p = hs + (size_t)min(mt * 16 + g, rp - 1) * stride;
          const Elem* h1p = hs + (size_t)min(mt * 16 + g + 8, rp - 1) * stride;
          float acc[kNTW][4];
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll 1  // tools/att_decode_variants.py's k_unroll2 measured slower
          for (int k0 = kbeg; k0 < kbeg + kshare; k0 += C::kKStep) {
            if constexpr (kBf16) {
              const uint32_t a[4] = {ld32(h0p + k0 + 2 * tig), ld32(h1p + k0 + 2 * tig),
                                     ld32(h0p + k0 + 2 * tig + 8), ld32(h1p + k0 + 2 * tig + 8)};
#pragma unroll
              for (int nt = 0; nt < kNTW; ++nt) {
                const Elem* wr = wsm + (size_t)(nt * 8 + g) * stride + k0 + 2 * tig;
                const uint32_t b[2] = {ld32(wr), ld32(wr + 8)};
                mma_bf16(acc[nt], a, b);
              }
            } else {
              uint32_t ab[4], asml[4];
              split_tf32(h0p[k0 + tig], ab[0], asml[0]);
              split_tf32(h1p[k0 + tig], ab[1], asml[1]);
              split_tf32(h0p[k0 + tig + 4], ab[2], asml[2]);
              split_tf32(h1p[k0 + tig + 4], ab[3], asml[3]);
#pragma unroll
              for (int nt = 0; nt < kNTW; ++nt) {
                const Elem* wr = wsm + (size_t)(nt * 8 + g) * stride + k0 + tig;
                uint32_t bb[2], bs[2];
                split_tf32(wr[0], bb[0], bs[0]);
                split_tf32(wr[4], bb[1], bs[1]);
                float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(part, asml, bb);
                mma_tf32(part, ab, bs);
                mma_tf32(part, ab, bb);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[nt][j] += part[j];
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt) {
            const int col = nt * 8 + 2 * tig, ra = mt * 16 + g;
            if (ra < rp)
              *reinterpret_cast<float2*>(rw + (size_t)ra * C::kRedStride + col) =
                  make_float2(acc[nt][0], acc[nt][1]);
            if (ra + 8 < rp)
              *reinterpret_cast<float2*>(rw + (size_t)(ra + 8) * C::kRedStride + col) =
                  make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
      __syncthreads();                              // every k share of the pass is written

      // The shares added in order: the h part of the gates into hp; dw, with
      // b_att, out as words.
      for (int i = tid; i < rp * U5; i += kThreads) {
        const int r = i / U5, n = i - r * U5;
        float s = red[(size_t)r * C::kRedStride + n];
#pragma unroll
        for (int k = 1; k < C::kWarpsK; ++k) s += red[((size_t)k * RP + r) * C::kRedStride + n];
        if (n < U4) {
          hp[(pr0 + r) * U4 + n] = s;
        } else {
          const int j = j0 + n - U4;
          st_word(dww + ((size_t)(t & 1) * B + b0 + pr0 + r) * H + j, s + batt[j], t + 1);
        }
      }
      __syncthreads();                              // hs and red are free for the next pass
    }

    // dw_t of the rows of this block's score pairs, then their scores.
    if (nspan > 0) {
      const unsigned long long* base = dww + ((size_t)(t & 1) * B + b0 + r_lo) * H;
      poll_pairs<8>(nspan * H / 2, t + 1, t, H / 2,
                    [&](int i) { return base + 2 * i; },
                    [&](int i, unsigned lo, unsigned hi) {
                      *reinterpret_cast<float2*>(dsm + 2 * i) =
                          make_float2(__uint_as_float(lo), __uint_as_float(hi));
                    });
    }
    __syncthreads();
    // Two pairs per warp at a time (pairs k and k + 8), so that their loads
    // are in flight together; a lone last pair is formed twice.
    for (int k = warp; k < npairs; k += 2 * kWarps) {
      const int nk = k + kWarps < npairs ? 2 : 1;
      const float4* e4[2];
      const float4* d4[2];
      int row[2], pos[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int kk = v < nk ? k + v * kWarps : k, pi = pi0 + kk, r = pi / L;
        row[v] = r;
        pos[v] = pi - r * L;
        e4[v] = reinterpret_cast<const float4*>(eslice + (size_t)kk * H);
        d4[v] = reinterpret_cast<const float4*>(dsm + (size_t)(r - r_lo) * H);
      }
      const float4* w4 = reinterpret_cast<const float4*>(wap);
      float acc[2] = {0.0f, 0.0f};
#pragma unroll 2
      for (int i = lane; i < H / 4; i += 32) {
        const float4 w = w4[i];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float4 e = e4[v][i], d = d4[v][i];
          acc[v] = fmaf(tanh_exp(rd(e.x, kBf16) + d.x), w.x, acc[v]);
          acc[v] = fmaf(tanh_exp(rd(e.y, kBf16) + d.y), w.y, acc[v]);
          acc[v] = fmaf(tanh_exp(rd(e.z, kBf16) + d.z), w.z, acc[v]);
          acc[v] = fmaf(tanh_exp(rd(e.w, kBf16) + d.w), w.w, acc[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) acc[v] = warp_sum(acc[v]);
      if (lane == 0)
        for (int v = 0; v < nk; ++v)
          st_word(eww + ((size_t)(t & 1) * B + b0 + row[v]) * L + pos[v], acc[v], t + 1);
    }
  }
}

// The route's first launch: P into pbuf in the layout of U units per block.
template <int kBf16>
cudaError_t launch_fold(const float* encout, const float* ctx0, const float* wctx, float* pbuf,
                        int B, int H, int L, int U, cudaStream_t stream) {
  auto kernel = att_decode_fwd_kernel_fold<kBf16>;
  const size_t smem = fold_smem_bytes(kBf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B * L + B + kPM - 1) / kPM, 4 * H / kPN);
  kernel<<<grid, kPThreads, smem, stream>>>(encout, ctx0, wctx, pbuf, B, H, L, U);
  return cudaGetLastError();
}

template <int kBf16, int kU>
cudaError_t launch(const float* xp, const float* wctx, const float* whh, const float* watt,
                   const float* batt, const float* wapp, const float* encwh, const float* encout,
                   const float* ctx0, float* out, float* pbuf, unsigned long long* words, int T,
                   int B, int H, int L, int groups, int tiles, int p_res, int e_res,
                   cudaStream_t stream) {
  cudaError_t err = launch_fold<kBf16>(encout, ctx0, wctx, pbuf, B, H, L, kU, stream);
  if (err != cudaSuccess) return err;
  auto kernel = att_decode_fwd_kernel_mma<kBf16, kU>;
  const size_t smem =
      block_smem<kBf16, kU>(H, L, (B + groups - 1) / groups, tiles, p_res, e_res).end;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &whh, &watt, &batt,   &wapp,  &encwh, &pbuf,  &out,  &words,
                  &T,  &B,   &H,    &L,      &groups, &tiles, &p_res, &e_res};
  const dim3 grid(groups * (H / kU)), block(kThreads);
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
}

// Whether the route serves H, L, B with U units per block, `groups` batch
// groups and `tiles` m16 tiles per pass: H % 128 == 0 (a warp's k share is
// whole k slices, a row's words whole 16-byte pairs), L even (an et row's
// words whole pairs), every group holds rows. (Shared memory and SMs are
// the caller's check.)
bool serves(int H, int L, int B, int U, int groups, int tiles) {
  if (H < 128 || H % 128 || L < 2 || L % 2 || B < 1 || groups < 1 || tiles < 1 ||
      tiles > kMaxTiles || !(U == 4 || U == 8 || U == 16))
    return false;
  const int rows = (B + groups - 1) / groups;
  return (B + rows - 1) / rows == groups;
}

}  // namespace mma_route

// ---------------------------------------------------------------------------
// The "stream" route (stream.cuh): per step t, four launches, so that no
// weight is held between them and every width is served --
//  1. the gates of [ctx | h_{t-1}] against [W_ctx | W_hh] (joined once per
//     call into one [4H, 3H] matrix in the scratch, so that each weight row
//     is one contiguous read) and the cell, a warp per unit (stream.cuh's
//     forward products): h_t into out[t], c into the scratch;
//  2. dw = h_t @ W_att^T + b_att, a warp per unit;
//  3. the scores et, a warp per (batch row, encoder position), its lanes
//     over H;
//  4. per batch row, the softmax over L (each block of the row again) and
//     ctx, a thread per column of 2H.
// 2-4 are skipped after the last step.
// ---------------------------------------------------------------------------

constexpr int kStreamWarps = 8;     // units per block: at H = 1000, 125 blocks
constexpr int kAttendThreads = 256;

// wcat [G, 3H] = [wctx [G, 2H] | whh [G, H]], a thread per value.
__global__ void __launch_bounds__(kAttendThreads)
att_decode_stream_join(const float* __restrict__ wctx, const float* __restrict__ whh,
                       float* __restrict__ wcat, int G, int H) {
  const size_t i = (size_t)blockIdx.x * kAttendThreads + threadIdx.x, H3 = 3 * (size_t)H;
  if (i >= (size_t)G * H3) return;
  const size_t r = i / H3, k = i - r * H3;
  wcat[i] = k < 2 * (size_t)H ? wctx[r * 2 * H + k] : whh[r * H + k - 2 * H];
}

__global__ void __launch_bounds__(32 * kStreamWarps)
att_decode_stream_cell(const float* __restrict__ xp, const float* __restrict__ wcat,
                       const float* __restrict__ ctx, float* __restrict__ out,
                       float* __restrict__ cbuf, int t, int B, int H, int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kStreamWarps + (threadIdx.x >> 5), b0 = blockIdx.y * sr::kRows;
  const size_t BH = (size_t)B * H, G = 4 * (size_t)H;
  const int H2 = 2 * H;
  const float* hp = t > 0 ? out + (t - 1) * BH : out;   // read only where t > 0
  float acc[4][sr::kRows], s[4];
  sr::lane_sums<4>(
      [=](int b, int k) {
        return k < H2 ? ctx[(size_t)b * H2 + k] : t > 0 ? hp[(size_t)b * H + k - H2] : 0.0f;
      },
      [=](int g, int k) { return __ldg(wcat + ((size_t)g * H + j) * (3 * H) + k); }, 0, 3 * H, B,
      b0, j < H, bf16, xs, acc);
  sr::warp_sums<4>(acc, s, lane);
  const int b = b0 + lane;
  if (j >= H || lane >= sr::kRows || b >= B) return;
  const size_t grow = ((size_t)t * B + b) * G + j, hrow = (size_t)b * H + j;
  const float ig = sigmoid_f(xp[grow] + s[0]);
  const float fg = sigmoid_f(xp[grow + H] + s[1]);
  const float gg = tanhf(xp[grow + 2 * H] + s[2]);
  const float og = sigmoid_f(xp[grow + 3 * H] + s[3]);
  const float cp = t > 0 ? cbuf[hrow] : 0.0f;
  const float c = fg * cp + ig * gg;
  out[t * BH + hrow] = og * tanhf(c);
  cbuf[hrow] = c;
}

__global__ void __launch_bounds__(32 * kStreamWarps)
att_decode_stream_dw(const float* __restrict__ watt, const float* __restrict__ batt,
                     const float* __restrict__ h, float* __restrict__ dw, int B, int H,
                     int bf16) {
  namespace sr = stream_route;
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kStreamWarps + (threadIdx.x >> 5), b0 = blockIdx.y * sr::kRows;
  float acc[1][sr::kRows], s[1];
  sr::lane_sums<1>([=](int b, int k) { return h[(size_t)b * H + k]; },
                   [=](int, int k) { return __ldg(watt + (size_t)j * H + k); }, 0, H, B, b0,
                   j < H, bf16, xs, acc);
  sr::warp_sums<1>(acc, s, lane);
  const int b = b0 + lane;
  if (j < H && lane < sr::kRows && b < B) dw[(size_t)b * H + j] = s[0] + batt[j];
}

// et[b][l] = sum_H tanh(enc_wh[b, l] + dw[b]) * w_apply, a warp per l.
__global__ void __launch_bounds__(kAttendThreads)
att_decode_stream_scores(const float* __restrict__ dw, const float* __restrict__ wapp,
                         const float* __restrict__ ewh, float* __restrict__ et, int H, int L,
                         int bf16) {
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int l = blockIdx.y * (kAttendThreads / 32) + (threadIdx.x >> 5);
  if (l >= L) return;
  const float* d = dw + (size_t)b * H;
  const float* e = ewh + ((size_t)b * L + l) * H;
  float s = 0.0f;
#pragma unroll 4
  for (int k = lane; k < H; k += 32) {
    const float v = bf16 ? round_bf16(e[k]) : e[k];
    s = fmaf(tanhf(v + d[k]), __ldg(wapp + k), s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) et[(size_t)b * L + l] = s;
}

// ctx[b] = sum_L softmax_L(et[b])[l] * enc_out[b, l], a thread per column;
// each block of row b takes the softmax of its L scores itself.
__global__ void __launch_bounds__(kAttendThreads)
att_decode_stream_context(const float* __restrict__ et, const float* __restrict__ eout,
                          float* __restrict__ ctx, int H, int L, int bf16) {
  extern __shared__ float at[];                 // [L]: exp(et - max) / sum
  __shared__ float total;
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const float* e = et + (size_t)b * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, e[l]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int l = lane; l < L; l += 32) {
      const float x = expf(e[l] - m);
      at[l] = x;
      sum += x;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) total = sum;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kAttendThreads) at[l] /= total;
  __syncthreads();
  const int H2 = 2 * H, j = blockIdx.y * kAttendThreads + threadIdx.x;
  if (j >= H2) return;
  const float* eo = eout + (size_t)b * L * H2 + j;
  float s = 0.0f;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    const float v = bf16 ? round_bf16(eo[(size_t)l * H2]) : eo[(size_t)l * H2];
    s = fmaf(at[l], v, s);
  }
  ctx[(size_t)b * H2 + j] = s;
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

// Dynamic shared memory of one mma-route block (see mma_route::smem_layout):
// hidden size H, L positions, U units per block, R rows per group, `tiles`
// m16 tiles per pass, P's slice and the pairs' enc_wh rows resident or not.
size_t att_decode_fwd_mma_smem_bytes(int H, int L, int U, int R, int tiles, int p_res, int e_res,
                                     int bf16) {
  using namespace mma_route;
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 16: return block_smem<0, 8>(H, L, R, tiles, p_res, e_res).end;
    case 17: return block_smem<1, 8>(H, L, R, tiles, p_res, e_res).end;
    case 33: return block_smem<1, 16>(H, L, R, tiles, p_res, e_res).end;
    default: return 0;
  }
}

// The mma route: the inputs of att_decode_fwd, out, then `pbuf` (P's
// 4H (B L + B) floats, written by the route's first launch) and `words`
// (this launch's exchange, zeroed 8-byte words: 2 B (H + H + L) in float32,
// 2 B (H / 2 + H + L) in bf16), with U units per block (8, or 16 in bf16:
// the U att_decode_plan takes on an H100), `groups` batch groups (groups *
// H / U blocks, all resident at once), `tiles` m16 tiles per pass and P's
// slice (p_res) and the score pairs' enc_wh rows (e_res) resident in shared
// memory or not. Two launches on `stream`; returns the cudaError_t of the
// second.
int att_decode_fwd_mma(const void* xp, const void* wctx, const void* whh, const void* watt,
                       const void* batt, const void* wapp, const void* encwh, const void* encout,
                       const void* ctx0, void* out, void* pbuf, void* words, int T, int B, int H,
                       int L, int U, int groups, int tiles, int p_res, int e_res, int bf16,
                       int device, void* stream) {
  if (!mma_route::serves(H, L, B, U, groups, tiles) || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* in[] = {static_cast<const float*>(xp),    static_cast<const float*>(wctx),
                       static_cast<const float*>(whh),   static_cast<const float*>(watt),
                       static_cast<const float*>(batt),  static_cast<const float*>(wapp),
                       static_cast<const float*>(encwh), static_cast<const float*>(encout),
                       static_cast<const float*>(ctx0)};
  float* o = static_cast<float*>(out);
  float* pb = static_cast<float*>(pbuf);
  unsigned long long* w = static_cast<unsigned long long*>(words);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2VT_ATT_MMA(BF, UU)                                                                  \
  mma_route::launch<BF, UU>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], o, \
                            pb, w, T, B, H, L, groups, tiles, p_res, e_res, st)
  switch (U * 2 + (bf16 ? 1 : 0)) {
    case 16: err = S2VT_ATT_MMA(0, 8); break;
    case 17: err = S2VT_ATT_MMA(1, 8); break;
    case 33: err = S2VT_ATT_MMA(1, 16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2VT_ATT_MMA
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stream route: the inputs of att_decode_fwd, out [T, B, H] and scratch
// [12 H H + 4 B H + B L] float32 ([W_ctx | W_hh], c, dw, ctx, et), for any
// H, L and B; 4 T - 2 launches on `stream`. Returns the cudaError_t of the first call that
// fails.
int att_decode_fwd_stream(const void* xp, const void* wctx, const void* whh, const void* watt,
                          const void* batt, const void* wapp, const void* ewh, const void* eout,
                          const void* ctx0, void* out, void* scratch, int T, int B, int H, int L,
                          int bf16, int device, void* stream) {
  if (T < 1 || B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t BH = (size_t)B * H;
  float* pout = static_cast<float*>(out);
  float* wcat = static_cast<float*>(scratch);
  float* cbuf = wcat + (size_t)12 * H * H;
  float* dw = cbuf + BH;
  float* ctx = dw + BH;
  float* et = ctx + 2 * BH;
  const size_t cell_smem = stream_route::smem_bytes(3 * H), dw_smem = stream_route::smem_bytes(H);
  const size_t at_smem = (size_t)L * sizeof(float);
  if ((err = stream_route::allow_smem(att_decode_stream_cell, cell_smem)) != cudaSuccess ||
      (err = stream_route::allow_smem(att_decode_stream_dw, dw_smem)) != cudaSuccess ||
      (err = stream_route::allow_smem(att_decode_stream_context, at_smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid = stream_route::grid(B, H, kStreamWarps);
  const dim3 score_grid(B, (L + kAttendThreads / 32 - 1) / (kAttendThreads / 32));
  const dim3 ctx_grid(B, (2 * H + kAttendThreads - 1) / kAttendThreads);
  att_decode_stream_join<<<(unsigned)(((size_t)12 * H * H + kAttendThreads - 1) / kAttendThreads),
                           kAttendThreads, 0, st>>>(static_cast<const float*>(wctx),
                                                    static_cast<const float*>(whh), wcat, 4 * H,
                                                    H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    att_decode_stream_cell<<<grid, 32 * kStreamWarps, cell_smem, st>>>(
        static_cast<const float*>(xp), wcat, t > 0 ? ctx : static_cast<const float*>(ctx0), pout,
        cbuf, t, B, H, bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (t == T - 1) break;
    att_decode_stream_dw<<<grid, 32 * kStreamWarps, dw_smem, st>>>(
        static_cast<const float*>(watt), static_cast<const float*>(batt), pout + t * BH, dw, B, H,
        bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    att_decode_stream_scores<<<score_grid, kAttendThreads, 0, st>>>(
        dw, static_cast<const float*>(wapp), static_cast<const float*>(ewh), et, H, L, bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    att_decode_stream_context<<<ctx_grid, kAttendThreads, at_smem, st>>>(
        et, static_cast<const float*>(eout), ctx, H, L, bf16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
