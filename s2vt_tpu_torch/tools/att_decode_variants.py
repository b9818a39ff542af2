"""Where the attention-decoder kernel's time goes, on its "mma" route.

    python -m s2vt_tpu_torch.tools.att_decode_variants [--route mma|layouts|sweep|all]
        [--reps 20] [--only as_built,phase_clock,...]

Builds ``csrc/att_decode_fwd.cu`` as it is and in variants that each change
one piece of its "mma" route, and prints for each the ``ptxas`` registers
and spills of its entry functions, its largest error against the plain
version (B = 16; "timing only" where the variant computes something else on
purpose), and at H = 512, T = 79, L = 80, B in {16, 96}, float32 and bf16
(CUDA events, the mean of ``--reps`` calls) the route's whole call, the time
of its first launch alone (P = [enc_out; ctx0] @ W_ctx^T, the fold's
product: ``p_only``, a build whose launch returns after P's) and the loop's
microseconds per step (the call less P, over T), beside the direct route as
built. Every call goes through ``fused_att_decode.launch`` with the
variant's library. The variants:

- ``no_poll``: the exchange words are taken as first read, tagged or not
  (the three exchanges' latency without the wait for their producers);
- ``no_products``: the h rows are staged but no product runs;
- ``no_scores``: the score pairs' words go out with no tanh sum formed;
- ``no_fold``: the cells skip a_t . P (the gates take x_proj and the h part);
- ``tanhf``: the scores' tanh by the library's tanhf in place of tanh_exp
  (1 - 2 / (1 + __expf(2x)));
- ``w_as_a``: the products as W x h^T (the 5U weight rows on the m16
  side, the pass's rows on the n8 side, so that 8 rows fill an n8 tile) in
  place of h x W^T;
- ``k_unroll2``: the products' k loop unrolled twice (not unrolled as
  built);
- ``f32_small_acc``: 3xTF32 with only big x big in a fresh partial per k
  slice, the two small terms into running accumulators of their own;
- ``f32_one_acc``: 3xTF32 with all three terms into the running sum (no
  fresh partial: the tensor cores' truncation as they add shows);
- ``fold_128x128``: P's launch in 128 x 128 output tiles of 8 warps (64 x
  32 each) in place of 64 x 64 tiles of 4 warps (32 x 32 each);
- ``f32_cuda_cores``: the float32 products on the CUDA cores (each lane a
  run of (row, column) sums over its warp's k share, fused multiply-adds in
  k order) in place of 3xTF32 on the tensor cores;
- ``ctx_words``: the loop unfolded, as the LSTM and GRU mma routes run
  theirs: each block keeps its 4U gate rows of W_ctx resident (in the
  region P's slice would take), forms its 2U columns of ctx_t = sum_l a_t
  enc_out from device memory and sends them as step-tagged words (a fourth
  exchange, in P's buffer, which the route's first launch has filled),
  polls its group's rows of ctx and forms ctx W_ctx^T on the tensor cores
  before the cells: what the fold buys. Its block fits the card in bf16 only (W_ctx's rows
  take 4U (2H + 8) bf16), at the batches whose rows run in one pass;
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase of
  a step (PHASES) and writes the sums, as floats, over h[0, 0, 0:6]: units
  0-5 of row 0 at step 0, written by block 0 alone and long before its loop
  ends (printed per step);

and layouts of the route as it is (launch parameters, not edits), run from
``more_units``, a build whose entry points also instantiate the U the source
leaves out (4 in both modes, 16 in float32): ``units4``, ``units8`` and
``units16`` force U units per block, with as many batch groups as the card
holds; ``p_streamed`` reads P's slice from device memory every step, where
the plan keeps it resident.

``--route sweep`` times the two routes as built, in turns (mma, direct,
direct, mma), at T = 79, L = 80 over SWEEP_BATCHES in both modes, each with
the layout the route takes: where the mma route is faster. ``--route
layouts`` times the route as built with every U over SWEEP_BATCHES in both
modes: which U the plan should take.

``no_poll``, ``no_products``, ``no_scores``, ``no_fold`` and ``phase_clock``
give wrong numbers (or time an instrumented build) and only time a piece.
Needs a card and ``nvcc``; builds into ``build/att_decode_variants/`` at the
root of the checkout.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops import fused_att_decode as fad
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "att_decode_variants"
H, L, T = 512, 80, 79
BATCHES = (16, 96)
SWEEP_BATCHES = (1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200)

# The mma route's pieces, by exact text.
_POLL = "      if (!stale) break;"
_PRODUCTS = "        for (int mt = 0; mt * 16 < rp; ++mt) {"
_SCORES = "      for (int i = lane; i < H / 4; i += 32) {"
_FOLD = "          for (int l = q; l < L; l += 4) {"
_TANH = "          acc[v] = fmaf(tanh_exp(rd(e.{c}, kBf16) + d.{c}), w.{c}, acc[v]);"
_PRODUCTS_START = "      // Products, h x W^T: this warp's k share, every n8 tile of the weight\n"
_PRODUCTS_END = ("      __syncthreads();                              // every k share of the "
                 "pass is written\n")
_K_LOOP = ("#pragma unroll 1  // tools/att_decode_variants.py's k_unroll2 measured slower\n"
           "          for (int k0 = kbeg; k0 < kbeg + kshare; k0 += C::kKStep) {")
# w_as_a: W x h^T, the 5U weight rows as m16 tiles (rows past them repeat row
# 0) and the pass's rows as n8 tiles, 16 at a time, in each warp over its k
# share.
_W_AS_A = """      // Products, weights x h^T so that the m16 side is the 5U weight rows
      // (rows past them repeat row 0) and the n8 side the pass's batch rows,
      // 16 at a time (rows past the pass repeat its last row): this warp's
      // k share, every m16 tile; their sums are dropped.
      {
        constexpr int kMT = (5 * kU + 15) / 16;        // m16 tiles over the weight rows
        const int kshare = H / C::kWarpsK, kbeg = warp * kshare;
        float* rw = red + (size_t)warp * RP * C::kRedStride;
        for (int nc = 0; nc * 16 < rp; ++nc) {
          const bool two = nc * 16 + 8 < rp;       // the chunk's second n8 tile holds rows
          const Elem* hr[2] = {hs + (size_t)min(nc * 16 + g, rp - 1) * stride,
                               hs + (size_t)min(nc * 16 + 8 + g, rp - 1) * stride};
          const Elem* wr[kMT][2];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int m = mt * 16 + g;
            wr[mt][0] = wsm + (size_t)(m < U5 ? m : 0) * stride;
            wr[mt][1] = wsm + (size_t)(m + 8 < U5 ? m + 8 : 0) * stride;
          }
          float acc[kMT][2][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
#pragma unroll 1
          for (int k0 = kbeg; k0 < kbeg + kshare; k0 += C::kKStep) {
            if constexpr (kBf16) {
              uint32_t b[2][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                b[j][0] = ld32(hr[j] + k0 + 2 * tig);
                b[j][1] = ld32(hr[j] + k0 + 2 * tig + 8);
              }
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
                const uint32_t a[4] = {ld32(wr[mt][0] + k0 + 2 * tig), ld32(wr[mt][1] + k0 + 2 * tig),
                                       ld32(wr[mt][0] + k0 + 2 * tig + 8),
                                       ld32(wr[mt][1] + k0 + 2 * tig + 8)};
                mma_bf16(acc[mt][0], a, b[0]);
                if (two) mma_bf16(acc[mt][1], a, b[1]);
              }
            } else {
              // 3xTF32, each k slice's three products into a fresh partial.
              uint32_t bb[2][2], bs[2][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                split_tf32(hr[j][k0 + tig], bb[j][0], bs[j][0]);
                split_tf32(hr[j][k0 + tig + 4], bb[j][1], bs[j][1]);
              }
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
                uint32_t ab[4], asml[4];
                split_tf32(wr[mt][0][k0 + tig], ab[0], asml[0]);
                split_tf32(wr[mt][1][k0 + tig], ab[1], asml[1]);
                split_tf32(wr[mt][0][k0 + tig + 4], ab[2], asml[2]);
                split_tf32(wr[mt][1][k0 + tig + 4], ab[3], asml[3]);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  if (j == 1 && !two) break;
                  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                  mma_tf32(part, asml, bb[j]);
                  mma_tf32(part, ab, bs[j]);
                  mma_tf32(part, ab, bb[j]);
#pragma unroll
                  for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[i];
                }
              }
            }
          }
          // acc[mt][j]: weight rows mt * 16 + g (+ 8), batch rows nc * 16 + j * 8
          // + 2 tig (+ 1) of the pass.
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int m = mt * 16 + g + (i >> 1) * 8, n = nc * 16 + j * 8 + 2 * tig + (i & 1);
                if (m < U5 && n < rp) rw[(size_t)n * C::kRedStride + m] = acc[mt][j][i];
              }
        }
      }
"""
# ctx_words: the pieces it edits, by exact text, and what it puts in their place.
_P_REGION = ("  s.p = o;   o = align16(o + (p_res ? (size_t)R * L * 4 * U * 4 : 0));\n")
_CTX_REGION = ("  s.p = o;   o = align16(o + ((size_t)4 * U + R) * (2 * H + (es == 2 ? 8 : 4)) * es);"
               "\n")
_SIGNATURE = ("                          const float* __restrict__ pbuf, float* __restrict__ out,"
              "\n")
_CTX_SIGNATURE = _SIGNATURE + ("                          const float* __restrict__ wctx, "
                               "const float* __restrict__ encout,\n"
                               "                          const float* __restrict__ ctx0,\n")
_ARGS = "&pbuf,  &out,  &words,"
_CTX_ARGS = "&pbuf,  &out, &wctx, &encout, &ctx0, &words,"
_WAP = "  for (int k = tid; k < H; k += kThreads) wap[k] = wapp[k];\n"
_CTX_WEIGHTS = """  {                                                 // ctx_words: W_ctx's gate rows
    const int stride2 = 2 * H + C::kPad;
    Elem* wcs = reinterpret_cast<Elem*>(smem_raw + lay.p);
    for (int idx = tid; idx < U4 * 2 * H; idx += kThreads) {
      const int n = idx / (2 * H), k = idx - n * 2 * H;
      wcs[(size_t)n * stride2 + k] =
          operand<kBf16>(wctx[(size_t)((n & 3) * H + j0 + (n >> 2)) * 2 * H + k]);
    }
  }
"""
_CTX_STEP = """    {                                               // ctx_words: ctx_t W_ctx^T
      const int H2 = 2 * H, stride2 = H2 + C::kPad;
      const Elem* wcs = reinterpret_cast<const Elem*>(smem_raw + lay.p);
      Elem* cts = reinterpret_cast<Elem*>(smem_raw + lay.p) + (size_t)U4 * stride2;
      unsigned long long* cw = reinterpret_cast<unsigned long long*>(const_cast<float*>(pbuf));
      if (t == 0) {
        for (int i = tid; i < rows * H2; i += kThreads) {
          const int r = i / H2, k = i - r * H2;
          cts[(size_t)r * stride2 + k] = operand<kBf16>(ctx0[(size_t)(b0 + r) * H2 + k]);
        }
      } else {
        for (int i = tid; i < rows * 2 * kU; i += kThreads) {
          const int r = i / (2 * kU), col = p * 2 * kU + i - r * 2 * kU;
          const float* eo = encout + (size_t)(b0 + r) * L * H2 + col;
          float sum = 0.0f;
          for (int l = 0; l < L; ++l)
            sum = fmaf(att[r * L + l], rd(__ldg(eo + (size_t)l * H2), kBf16), sum);
          st_word(cw + ((size_t)(t & 1) * B + b0 + r) * H2 + col, sum, t + 1);
        }
        const unsigned long long* base = cw + ((size_t)(t & 1) * B + b0) * H2;
        poll_pairs<8>(rows * H, t + 1, t, H, [&](int i) { return base + 2 * i; },
                      [&](int i, unsigned lo, unsigned hi) {
                        const int r = i / H, col = 2 * (i - r * H);
                        cts[(size_t)r * stride2 + col] = operand<kBf16>(__uint_as_float(lo));
                        cts[(size_t)r * stride2 + col + 1] = operand<kBf16>(__uint_as_float(hi));
                      });
      }
      __syncthreads();
      constexpr int kGT = U4 / 8;                   // n8 tiles of the gate rows
      const int kshare = H2 / C::kWarpsK, kbeg = warp * kshare;
      float* rw = red + (size_t)warp * RP * C::kRedStride;
      for (int mt = 0; mt * 16 < rows; ++mt) {
        const Elem* c0p = cts + (size_t)min(mt * 16 + g, rows - 1) * stride2;
        const Elem* c1p = cts + (size_t)min(mt * 16 + g + 8, rows - 1) * stride2;
        float acc[kGT][4];
#pragma unroll
        for (int nt = 0; nt < kGT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
        for (int k0 = kbeg; k0 < kbeg + kshare; k0 += C::kKStep) {
          if constexpr (kBf16) {
            const uint32_t a[4] = {ld32(c0p + k0 + 2 * tig), ld32(c1p + k0 + 2 * tig),
                                   ld32(c0p + k0 + 2 * tig + 8), ld32(c1p + k0 + 2 * tig + 8)};
#pragma unroll
            for (int nt = 0; nt < kGT; ++nt) {
              const Elem* wr = wcs + (size_t)(nt * 8 + g) * stride2 + k0 + 2 * tig;
              const uint32_t b[2] = {ld32(wr), ld32(wr + 8)};
              mma_bf16(acc[nt], a, b);
            }
          } else {
            uint32_t ab[4], asml[4];
            split_tf32(c0p[k0 + tig], ab[0], asml[0]);
            split_tf32(c1p[k0 + tig], ab[1], asml[1]);
            split_tf32(c0p[k0 + tig + 4], ab[2], asml[2]);
            split_tf32(c1p[k0 + tig + 4], ab[3], asml[3]);
#pragma unroll
            for (int nt = 0; nt < kGT; ++nt) {
              const Elem* wr = wcs + (size_t)(nt * 8 + g) * stride2 + k0 + tig;
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
        for (int nt = 0; nt < kGT; ++nt) {
          const int col = nt * 8 + 2 * tig, ra = mt * 16 + g;
          if (ra < rows)
            *reinterpret_cast<float2*>(rw + (size_t)ra * C::kRedStride + col) =
                make_float2(acc[nt][0], acc[nt][1]);
          if (ra + 8 < rows)
            *reinterpret_cast<float2*>(rw + (size_t)(ra + 8) * C::kRedStride + col) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
      __syncthreads();
    }
"""
_FOLD_START = "      if (valid) {\n        if (t == 0) {\n"
_FOLD_END = "#pragma unroll\n      for (int off = 8; off < 32; off <<= 1) {\n"
_CTX_FOLD = """      if (valid && q == 0) {                        // ctx_words: the shares of ctx W_ctx^T
        float v[4];
#pragma unroll
        for (int gq = 0; gq < 4; ++gq) {
          float sum = red[(size_t)r * C::kRedStride + u * 4 + gq];
#pragma unroll
          for (int k = 1; k < C::kWarpsK; ++k)
            sum += red[((size_t)k * RP + r) * C::kRedStride + u * 4 + gq];
          v[gq] = sum;
        }
        acc = make_float4(v[0], v[1], v[2], v[3]);
      }
"""

_FOLD_TILE = "constexpr int kPM = 64, kPN = 64, kPK = 32, kPThreads = 128;"
# p_only: the route's launch returns after P's.
_FOLD_LAUNCH = ("  cudaError_t err = launch_fold<kBf16>(encout, ctx0, wctx, pbuf, B, H, L, kU, "
                "stream);\n  if (err != cudaSuccess) return err;\n")
# more_units: the U the entry points leave out, by their switches' first case.
_SMEM_CASE = "    case 16: return block_smem<0, 8>(H, L, R, tiles, p_res, e_res).end;\n"
_LAUNCH_CASE = "    case 16: err = S2VT_ATT_MMA(0, 8); break;\n"
_MORE_SMEM = "".join(f"    case {2 * u + bf}: return block_smem<{bf}, {u}>(H, L, R, tiles, p_res, "
                     "e_res).end;\n" for u, bf in ((4, 0), (4, 1), (16, 0)))
_MORE_LAUNCH = "".join(f"    case {2 * u + bf}: err = S2VT_ATT_MMA({bf}, {u}); break;\n"
                       for u, bf in ((4, 0), (4, 1), (16, 0)))
# f32_small_acc / f32_one_acc: the 3xTF32 sums' accumulation.
_ACC_DECL = ("          float acc[kNTW][4];\n#pragma unroll\n          for (int nt = 0; nt < kNTW; "
             "++nt)\n#pragma unroll\n            for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;\n")
_TRIPLE = """                float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(part, asml, bb);
                mma_tf32(part, ab, bs);
                mma_tf32(part, ab, bb);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[nt][j] += part[j];
"""
_STORE = ("#pragma unroll\n          for (int nt = 0; nt < kNTW; ++nt) {\n"
          "            const int col = nt * 8 + 2 * tig, ra = mt * 16 + g;\n")
_SMALL_ACC_DECL = _ACC_DECL.replace("float acc[kNTW][4];", "float acc[kNTW][4], sacc[kNTW][4];") \
    .replace("acc[nt][j] = 0.0f;", "acc[nt][j] = sacc[nt][j] = 0.0f;")
_SMALL_TRIPLE = """                mma_tf32(sacc[nt], asml, bb);
                mma_tf32(sacc[nt], ab, bs);
                float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(part, ab, bb);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[nt][j] += part[j];
"""
_SMALL_ADD = """#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[nt][j] += sacc[nt][j];
"""
_ONE_TRIPLE = """                mma_tf32(acc[nt], asml, bb);
                mma_tf32(acc[nt], ab, bs);
                mma_tf32(acc[nt], ab, bb);
"""

# f32_cuda_cores: the float32 products as lane-strided sums on the CUDA cores,
# written into the same k-share rows as the tensor-core products.
_CORE_PRODUCTS = """        if constexpr (!kBf16) {
          for (int item = lane; item < rp * U5; item += 32) {
            const int r = item / U5, n = item - r * U5;
            const Elem* hr = hs + (size_t)r * stride + kbeg;
            const Elem* wr = wsm + (size_t)n * stride + kbeg;
            float s = 0.0f;
#pragma unroll 8
            for (int k = 0; k < kshare; ++k) s = fmaf(hr[k], wr[k], s);
            rw[(size_t)r * C::kRedStride + n] = s;
          }
        } else
"""

PHASES = ("et_poll", "cells", "h_poll", "products", "dw_poll", "scores")
_STEPS = "  for (int t = 0; t < T; ++t) {\n    // The step's x_proj, by cp.async"
_CELLS_START = ("    // The step's cells, each in four lanes of a warp (lanes i, i + 8, i + 16,"
                "\n")
_H_START = ("    // h_t of the group's rows, in passes of RP rows: dw_t of the block's\n")
_STAGED_SYNC = "      __syncthreads();                              // hs holds the pass's rows\n"
_PASS_END = ("      __syncthreads();                              // hs and red are free for the "
             "next pass\n")
_SCORES_START = "    for (int k = warp; k < npairs; k += 2 * kWarps) {\n"
_LOOP_END = ("          st_word(eww + ((size_t)(t & 1) * B + b0 + row[v]) * L + pos[v], acc[v], "
             "t + 1);\n    }\n  }\n}\n")
# (text, its replacement): block 0's thread 0 sums the clock cycles of each
# of PHASES and stores them, as floats, over out[0, 0, :6]: units 0-5 of row
# 0 at step 0, written by block 0 alone and long before its loop ends.
_PHASE_MARKS = (
    (_STEPS, f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = clock64();
  auto mark = [&](int phase) {{
    const long long now = clock64();
    clk[phase] += now - clk0;
    clk0 = now;
  }};
""" + _STEPS),
    (_CELLS_START, "    mark(0);\n" + _CELLS_START),
    (_H_START, "    mark(1);\n" + _H_START),
    (_STAGED_SYNC, _STAGED_SYNC + "      mark(2);\n"),
    (_PASS_END, _PASS_END + "      mark(3);\n"),
    (_SCORES_START, "    mark(4);\n" + _SCORES_START),
    (_LOOP_END, f"""          st_word(eww + ((size_t)(t & 1) * B + b0 + row[v]) * L + pos[v], acc[v], t + 1);
    }}
    mark(5);
  }}
  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph) out[ph] = (float)clk[ph];
}}
"""))

# Every variant of CHANGED removes each of its texts and keeps the line count.
CHANGED = {
    "no_poll": (_POLL,),
    "no_products": (_PRODUCTS,),
    "no_scores": (_SCORES,),
    "no_fold": (_FOLD,),
}
TIMING_ONLY = ("no_poll", "no_products", "no_scores", "no_fold", "phase_clock")
LAYOUTS = ("units4", "units8", "units16", "p_streamed")


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("att_decode_fwd")


def _cuda_cores(src: str) -> str:
    """The float32 products on the CUDA cores; bf16 unchanged."""
    start = src.index(_PRODUCTS)
    return src[:start] + _CORE_PRODUCTS + src[start:]


def _w_as_a(src: str) -> str:
    """The products as W x h^T."""
    start, end = src.index(_PRODUCTS_START), src.index(_PRODUCTS_END)
    return src[:start] + _W_AS_A + src[end:]


def _ctx_words(src: str) -> str:
    """The loop unfolded: W_ctx resident, ctx exchanged as words."""
    sub = _variants.replace_once
    src = sub(src, (_P_REGION, _CTX_REGION), (_SIGNATURE, _CTX_SIGNATURE), (_ARGS, _CTX_ARGS),
              (_WAP, _CTX_WEIGHTS + _WAP), (_CELLS_START, _CTX_STEP + _CELLS_START))
    start, end = src.index(_FOLD_START), src.index(_FOLD_END)
    return src[:start] + _CTX_FOLD + src[end:]


def ctx_words_smem(plan, bf16: bool) -> int:
    """The ctx_words block's shared memory: the route's without P's slice,
    with W_ctx's 4U gate rows and a ctx row per group row in its place."""
    es = 2 if bf16 else 4
    ctx = (4 * plan.units + plan.rows) * (2 * H + (8 if bf16 else 4)) * es
    return (fad.att_mma_smem_bytes(H, L, plan.units, plan.rows, plan.tiles, False,
                                   plan.e_resident, bf16) + -(-ctx // 16) * 16)


def mma_variants(src: str) -> dict:
    """{name: source}: the mma route as it is and with one piece changed or
    added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_poll": sub(src, (_POLL, "      if (true) break;")),
            "no_products": sub(src, (_PRODUCTS, _PRODUCTS.replace("mt * 16 < rp", "mt < 0"))),
            "no_scores": sub(src, (_SCORES, _SCORES.replace("i < H / 4", "i < 0"))),
            "no_fold": sub(src, (_FOLD, _FOLD.replace("l < L", "l < 0"))),
            "tanhf": sub(src, *((_TANH.format(c=c), _TANH.format(c=c).replace("tanh_exp", "tanhf"))
                                for c in "xyzw")),
            "w_as_a": _w_as_a(src),
            "k_unroll2": sub(src, (_K_LOOP, _K_LOOP.replace("unroll 1", "unroll 2"))),
            "f32_cuda_cores": _cuda_cores(src),
            "f32_small_acc": sub(src, (_ACC_DECL, _SMALL_ACC_DECL), (_TRIPLE, _SMALL_TRIPLE),
                                 (_STORE, _SMALL_ADD + _STORE)),
            "f32_one_acc": sub(src, (_TRIPLE, _ONE_TRIPLE)),
            "fold_128x128": sub(src, (_FOLD_TILE, _FOLD_TILE.replace("64", "128").replace(
                "kPThreads = 128", "kPThreads = 256"))),
            "ctx_words": _ctx_words(src),
            "phase_clock": sub(src, *_PHASE_MARKS)}


def more_units(src: str) -> str:
    """The source with U = 4 (both modes) and float32 U = 16 instantiated
    too, for the layouts."""
    return _variants.replace_once(src, (_SMEM_CASE, _MORE_SMEM + _SMEM_CASE),
                                  (_LAUNCH_CASE, _MORE_LAUNCH + _LAUNCH_CASE))


def p_only(src: str) -> str:
    """The source whose mma launch returns after its first kernel, P's."""
    return _variants.replace_once(
        src, (_FOLD_LAUNCH, _FOLD_LAUNCH.replace("if (err != cudaSuccess)", "if (true)")))


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fad.set_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def inputs(B: int, device, gen):
    """The nine inputs at H, L, T: weights at torch's init scale, encoder
    tensors as an encoder makes them (chip_smoke.py's att_inputs)."""
    k = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(*shape, device=device, generator=gen) * 2 - 1) * k

    def n(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    return [n(T, B, 4 * H), u(4 * H, 2 * H), u(4 * H, H), u(H, H), u(H), u(H),
            torch.tanh(n(B, L, H)), torch.tanh(n(B, L, 2 * H)), n(B, 2 * H, scale=0.1)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _mode(bf16: bool) -> str:
    return "bf16" if bf16 else "f32"


def _layout_plan(layout, B: int, bf16: bool, props):
    """The plan of a layout name (None: the route's own)."""
    if layout in (None, "p_streamed", "ctx_words"):
        plan = fad.att_decode_plan(H, L, B, bf16, props)
        if layout and plan is not None:
            plan = plan._replace(p_resident=False)
        if layout == "ctx_words" and plan is not None and (
                plan.passes > 1 or ctx_words_smem(plan, bf16) > props.smem_optin):
            return None                              # its block does not fit
        return plan
    return fad.att_decode_plan(H, L, B, bf16, props, units=int(layout[len("units"):]))


def _plan_text(p) -> str:
    return (f"{p.units}U/{p.groups}G/{p.tiles}x{p.passes}"
            f"{'/P' if p.p_resident else ''}{'/E' if p.e_resident else ''}")


def run_mma(args, card, ins) -> None:
    props = _build.card("cuda")
    src = kernel_source()
    chosen = {k: v for k, v in mma_variants(src).items() if not args.only or k in args.only}
    layouts = [name for name in LAYOUTS if not args.only or name in args.only]
    # P's time from p_only builds: the shipped fold, and fold_128x128's.
    extra = {"more_units": more_units(src)} if layouts else {}
    extra["p_only"] = p_only(more_units(src))
    if "fold_128x128" in chosen:
        extra["fold_128x128_p_only"] = p_only(more_units(chosen["fold_128x128"]))
    libs = build({**chosen, **extra})
    want = {bf16: fad.att_decode_fwd_reference(*ins[16], bf16) for bf16 in (False, True)}
    runs = [(name, *libs[name], "ctx_words" if name == "ctx_words" else None) for name in chosen]
    runs += [(name, *libs["more_units"], name) for name in layouts]
    direct_lib = libs["p_only"][0]                     # the direct kernel is in every build
    errs = [(fad.launch(*ins[16], bf16, "direct", lib=direct_lib) - want[bf16]).abs().max().item()
            for bf16 in (False, True)]
    cells = []
    for bf16 in (False, True):
        for B in BATCHES:
            ms = cuda_ms(lambda: fad.launch(*ins[B], bf16, "direct", lib=direct_lib), args.reps)
            cells.append(f"B={B} {_mode(bf16)} {ms:.4f} ms ({ms / T * 1e3:.2f} us/step)")
    times = ", ".join(cells)
    print(f"att_decode direct route as built: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} "
          f"at B=16; H={H} T={T} L={L} {times} [{card}]", flush=True)
    for name, lib, report, layout in runs:
        def call(B, bf16, lib=lib, layout=layout):
            p = _layout_plan(layout, B, bf16, props)
            return fad.launch(*ins[B], bf16, "mma", lib=lib, plan=p) if p else None

        errs = []
        for bf16 in (False, True):
            got = call(16, bf16)
            torch.cuda.synchronize()
            errs.append((got - want[bf16]).abs().max().item() if got is not None
                        else float("nan"))
        note = "timing only" if name in TIMING_ONLY else "checked"
        built = "more_units" if name in LAYOUTS else name
        p_lib = libs.get(f"{name}_p_only", libs["p_only"])[0]
        cells = []
        for bf16 in (False, True):
            for B in BATCHES:
                p = _layout_plan(layout, B, bf16, props)
                if p is None:
                    continue
                ms = cuda_ms(lambda: call(B, bf16), args.reps)
                p_ms = cuda_ms(lambda: fad.launch(*ins[B], bf16, "mma", lib=p_lib, plan=p),
                               args.reps)
                cells.append(f"B={B} {_mode(bf16)} {_plan_text(p)} {ms:.4f} ms (P {p_ms:.4f} ms, "
                             f"loop {(ms - p_ms) / T * 1e3:.2f} us/step)")
        print(f"att_decode mma variant {name}: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} "
              f"at B=16 ({note}); ptxas {ptxas_report(report)}; machine instructions "
              f"{_variants.sass_sizes(OUT_DIR / f'{built}.so')}; "
              f"H={H} T={T} L={L} "
              + ", ".join(cells) + f" [{card}]", flush=True)
        if name == "phase_clock":
            for bf16 in (False, True):
                for B in BATCHES:
                    p = _layout_plan(None, B, bf16, props)
                    if p is None or p.units < len(PHASES):
                        continue
                    outs = call(B, bf16)
                    torch.cuda.synchronize()
                    cyc = [v / T for v in outs.flatten()[:len(PHASES)].tolist()]
                    print(f"att_decode mma phases B={B} {_mode(bf16)} {_plan_text(p)} (block 0, "
                          f"thread 0, clock cycles per step): "
                          + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                          + f"; total {sum(cyc):.0f} [{card}]", flush=True)


def run_layouts(args, card) -> None:
    """Every U (the ``more_units`` build) over SWEEP_BATCHES, and P streamed
    where the plan keeps it resident."""
    props = _build.card("cuda")
    lib = build({"more_units": more_units(kernel_source())})["more_units"][0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for bf16 in (False, True):
        for B in SWEEP_BATCHES:
            ins = inputs(B, dev, gen)
            cells = []
            for layout in LAYOUTS:
                plan = _layout_plan(layout, B, bf16, props)
                if plan is None or (layout == "p_streamed" and
                                    not fad.att_decode_plan(H, L, B, bf16, props).p_resident):
                    continue
                ms = cuda_ms(lambda: fad.launch(*ins, bf16, "mma", lib=lib, plan=plan), args.reps)
                cells.append(f"{layout} {_plan_text(plan)} {ms:.4f} ms")
            chosen = fad.att_decode_plan(H, L, B, bf16, props)
            print(f"att_decode layouts B={B} {_mode(bf16)} H={H} T={T} L={L}: " + ", ".join(cells)
                  + f"; plan takes {_plan_text(chosen)} [{card}]", flush=True)


def run_sweep(args, card) -> None:
    """Both routes of the shipped build, in turns, over SWEEP_BATCHES."""
    props = _build.card("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for bf16 in (False, True):
        for B in SWEEP_BATCHES:
            plan = fad.att_decode_plan(H, L, B, bf16, props)
            if plan is None:
                continue
            ins = inputs(B, dev, gen)

            def mma(ins=ins, plan=plan, bf16=bf16):
                fad.launch(*ins, bf16, "mma", plan=plan)

            def direct(ins=ins, bf16=bf16):
                fad.launch(*ins, bf16, "direct")
            turns = [cuda_ms(f, args.reps) for f in (mma, direct, direct, mma)]
            m_ms, d_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            print(f"att_decode sweep B={B} {_mode(bf16)} H={H} T={T} L={L}: mma "
                  f"{_plan_text(plan)} {m_ms:.4f} ms, direct {d_ms:.4f} ms, route "
                  f"{fad.att_decode_fwd_route(H, L, B, bf16, props)} [{card}]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("mma", "layouts", "sweep", "all"), default="all")
    ap.add_argument("--reps", type=int, default=20, help="calls per timed shape")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated variant names to build or run (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.route in ("mma", "all"):
        run_mma(args, card, {B: inputs(B, dev, gen) for B in BATCHES})
    if args.route in ("layouts", "all"):
        run_layouts(args, card)
    if args.route in ("sweep", "all"):
        run_sweep(args, card)


if __name__ == "__main__":
    main()
