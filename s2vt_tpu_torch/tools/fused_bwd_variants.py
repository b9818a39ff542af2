"""Where the fused dual-LSTM S2VT backward kernel's time goes, on its "mma" route.

    python -m s2vt_tpu_torch.tools.fused_bwd_variants [--route mma|layouts|sweep|all]
        [--reps 20] [--only as_built,phase_clock,...]

Builds ``csrc/fused_s2vt_bwd.cu`` as it is and in variants that each change
one piece of its "mma" route (bf16 only), and prints for each the ``ptxas``
registers and spills of its entry functions, the machine instructions of
its mma kernels (``cuobjdump``), its largest error against the plain
version (B = 16, T = 159; "timing only" where the variant computes
something else on purpose), and its time per launch and per iteration at H
= 512, T = 159 (T + 1 iterations), B in {16, 96} (CUDA events, the mean of
``--reps`` launches), beside the direct route as built in float32 and bf16,
with the bytes all blocks read of the operand per iteration
(``l2_bytes``). Every launch goes through ``fused_s2vt.launch_bwd`` with the
variant's library. The variants:

- ``no_poll``: the exchange words are taken as first read, tagged or not
  (the exchange's latency without the wait for its producers);
- ``no_stores``: the cells write only the exchange words, not dxp1 and
  dxp2;
- ``no_products``: the rows are staged and the partials pushed, but no
  product runs;
- ``no_push``: each block stores its partials into its own shared memory,
  not the owners' (distributed shared memory's cost);
- ``inputs_after_poll``: the cells' inputs (g, c, c_prev, dout2) copied
  after the poll, before the products, in place of before the poll;
- ``bf16_unpacked``: one value per exchange word in place of two
  neighbouring units' values per word (the exchange's bytes doubled; its
  buffer sized by the build's own ``s2vt_fused_bwd_mma_xch_words``; the L2
  bytes printed are the packed words');
- ``dc_unfused`` and ``dg_unfused``: the cell math's 1 - tanh(c)^2 and
  1 - g^2 as a rounded product and a difference, in place of the
  expression nvcc contracts (the expression forms of the cell math);
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase
  of a pass (the cells' input copies and the poll, the products, the
  shares' sums and the pushes, the cluster barrier, the cells) and writes
  the sums, as floats, over dxp1[0, 0, (p % 4) H + 2 (p / 4)] (units 0-3 of
  row 0 at step 0, written by block 0 alone and before its loop ends;
  printed per iteration);

and layouts of the route (launch parameters): ``u<U>c<C>`` forces U units
per block and clusters of C blocks, with as many batch groups as the card's
SMs and co-resident clusters hold. The source instantiates U = 8, the
layout the plan takes; ``layout_sources`` builds U = 4 too.

``--route layouts`` times every layout at T = 159 over SWEEP_BATCHES: which
U and C the plan should take. ``--route sweep`` times the two routes as
built, in turns (mma, direct, direct, mma), at T = 159 over SWEEP_BATCHES in
bf16, each with the layout the plan takes: where the mma route is faster
(float32 takes the direct route at every batch).

``no_poll``, ``no_stores``, ``no_products``, ``no_push`` and
``phase_clock`` give wrong numbers (or time an instrumented build) and only
time a piece. Needs a card and ``nvcc``; builds into
``build/fused_bwd_variants/`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops import fused_s2vt as fs
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "fused_bwd_variants"
H = 512
T = 159
BATCHES = (16, 96)
SWEEP_BATCHES = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200)
LAYOUTS = ((4, 2), (4, 4), (8, 2), (8, 4))

# The mma route's pieces, by exact text.
_POLL = "            if (!stale) break;"
_DST = ("        Elem* dst = (layer == 0 ? dxp1 : dxp2) + ((size_t)step * B + b) * G4 + j;"
        "   // off the chain")
_PUSH = "          float* to = cluster.map_shared_rank(rcv, unit / kU);"
_PRODUCTS = ("        for (int s0 = wk * per; s0 < s_end; s0 += 2) {"
             "   // two k16 slices' fragments at once")
_VALS = "constexpr int kVals = 4;                         // operand values per 16-byte exchange load"
_WORD_VALS = "constexpr int kWordVals = 2;                     // operand values per exchange word"
_STAGE = ("              *reinterpret_cast<uint2*>(os + so[i]) = make_uint2((unsigned)v[i][0], "
          "(unsigned)v[i][1]);")
_PAIR_WORD = ("            st_word(xrow + (layer * G4 + (2 * odd + q) * H + j - odd) / 2,\n"
              "                    __uint_as_float(pack_bf16(lo, hi)), it + 1);")
# The entry point's one instantiated layout (U = 8), and U = 4 beside it.
_UNITS_CHECK = "  if (U != 8) return (int)cudaErrorInvalidValue;"
_UNITS_LAUNCH = "  err = mma_route::launch<8>("
_DC = "  const float dcv = carry + dh * go * (1.0f - tc * tc);\n  d[0] ="
_DG = "  d[2] = dcv * gi * (1.0f - gg * gg);\n  d[3] = dh * tc"
_IN_START = "      // The inputs of the pass's cells, copied into cin by cp.async before\n"
_IN_END = "      cp_async_commit();\n"
_STAGED_SYNC = "      __syncthreads();                              // os holds the pass's rows\n"
_PUSHED = "      cluster_barrier();                            // every partial of the pass has arrived\n"
_PASSES = ("    for (int ps = 0; ps < npass; ++ps) {\n"
           "      const int pr0 = ps * RP;\n")
_ITERS = ("  for (int it = 0; it <= T; ++it) {\n"
          "    const int t1 = T - it, t2 = T - 1 - it;       // layer 1 and layer 2 steps\n")
_KERNEL_END = ("        for (int k = 0; k < 4; ++k) dst[(size_t)k * H] = from_f<Elem>(d[k]);\n"
               "      }\n    }\n  }\n}\n")

PHASES = ("inputs and poll", "products", "shares and pushes", "cluster barrier", "cells")
_MMA_DONE = "        __syncthreads();                            // every warp is done with os\n"
# (text, its replacement): block 0's thread 0 sums the clock cycles of each
# of PHASES (the cells of a pass until the next pass starts) and stores them,
# as floats, over dxp1[0, 0, (p % 4) H + 2 (p / 4)]: units 0-3 of gate p % 4
# of row 0 at step 0, written by block 0 alone and before its loop ends.
_PHASE_MARKS = (
    (_ITERS, f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = clock64();
  auto mark = [&](int phase) {{
    const long long now = clock64();
    clk[phase] += now - clk0;
    clk0 = now;
  }};
""" + _ITERS),
    (_PASSES, _PASSES + "      mark(4);\n"),
    (_STAGED_SYNC, _STAGED_SYNC + "      mark(0);\n"),
    (_MMA_DONE, _MMA_DONE + "        mark(1);\n"),
    (_PUSHED, "      mark(2);\n" + _PUSHED + "      mark(3);\n"),
    (_KERNEL_END, _KERNEL_END[:-2] + f"""  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph)
      *reinterpret_cast<float*>(dxp1 + (size_t)(ph % 4) * H + 2 * (ph / 4)) = (float)clk[ph];
}}
"""))

TIMING_ONLY = ("no_poll", "no_stores", "no_products", "no_push", "phase_clock")


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("fused_s2vt_bwd")


def _moved_inputs(src: str) -> str:
    """The cells' input loads moved from before the poll to after it."""
    start = src.index(_IN_START)
    end = src.index(_IN_END, start) + len(_IN_END)
    block = src[start:end]
    return _variants.replace_once(src[:start] + src[end:], (_STAGED_SYNC, _STAGED_SYNC + block))


def mma_variants(src: str) -> dict:
    """{name: source}: the mma route as it is and with one piece changed or
    added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_poll": sub(src, (_POLL, "            if (true) break;")),
            "no_stores": sub(src, (_DST, _DST.replace("// off the chain", "if (T > 0) continue;"))),
            "no_products": sub(src, (_PRODUCTS, _PRODUCTS.replace("s0 < s_end", "s0 < wk * per"))),
            "no_push": sub(src, (_PUSH, _PUSH.replace("cluster.map_shared_rank(rcv, unit / kU)",
                                                      "rcv + 0 * unit"))),
            "inputs_after_poll": _moved_inputs(src),
            "bf16_unpacked": sub(
                src, (_VALS, _VALS.replace("= 4;", "= 2;")),
                (_WORD_VALS, _WORD_VALS.replace("= 2;", "= 1;")),
                (_STAGE, "              *reinterpret_cast<uint32_t*>(os + so[i]) = pack_bf16("
                 "__uint_as_float((unsigned)v[i][0]), __uint_as_float((unsigned)v[i][1]));"),
                (_PAIR_WORD, "            st_word(xrow + layer * G4 + (2 * odd + q) * H + j - odd, "
                 "round_bf16(lo), it + 1);\n            st_word(xrow + layer * G4 + (2 * odd + q) * H + "
                 "j - odd + 1, round_bf16(hi), it + 1);")),
            "dc_unfused": sub(src, (_DC, _DC.replace("(1.0f - tc * tc)",
                                                     "__fsub_rn(1.0f, __fmul_rn(tc, tc))"))),
            "dg_unfused": sub(src, (_DG, _DG.replace("(1.0f - gg * gg)",
                                                     "__fsub_rn(1.0f, __fmul_rn(gg, gg))"))),
            "phase_clock": sub(src, *_PHASE_MARKS)}


def layout_sources(src: str) -> dict:
    """{name: source}: the source as built (U = 8) and ``units4``, whose
    entry point also instantiates and launches U = 4."""
    return {"as_built": src,
            "units4": _variants.replace_once(
                src, (_UNITS_CHECK, _UNITS_CHECK.replace("U != 8)", "U != 8 && U != 4)")),
                (_UNITS_LAUNCH, "  err = (U == 4 ? mma_route::launch<4> : mma_route::launch<8>)("))}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fs.set_bwd_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def inputs(B: int, bf16: bool, device, gen):
    """The backward's inputs at H, T from a forward run of random weights
    (so that the gates and c are real LSTM states), and a random dout2."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    k = 1.0 / H ** 0.5
    x1, x2 = (torch.randn(T, B, 4 * H, device=device, generator=gen).to(dtype) for _ in range(2))
    ws = [((torch.rand(4 * H, H, device=device, generator=gen) * 2 - 1) * k).to(dtype)
          for _ in range(3)]
    g1, c1, g2, c2 = fs.fused_s2vt_fwd(x1, x2, *ws, T - 1)[:4]
    return (g1, c1, g2, c2, torch.randn(T, B, H, device=device, generator=gen), *ws)


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


def max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def l2_bytes(B: int, bf16: bool, plan=None) -> int:
    """Bytes all blocks read of the operand [dg1' | dg2'] per iteration at
    H: with ``plan``, the bf16 mma route's exchange words ((H / U) B 8H / C
    values, two per 8-byte word); without, the direct route's rows of dxp1
    and dxp2 (H / 4 blocks read B 8H values in the I/O type)."""
    if plan is None:
        return (H // 4) * B * 8 * H * (2 if bf16 else 4)
    return (H // plan.units) * B * 8 * H // plan.cluster * 4


def l2_mib(B, bf16, plan=None) -> str:
    return f"{l2_bytes(B, bf16, plan) / 2 ** 20:.2f} MiB"


def _mode(bf16: bool) -> str:
    return "bf16" if bf16 else "f32"


def run_mma(args, card, ins) -> None:
    props = fs.bwd_card("cuda")
    chosen = {k: v for k, v in mma_variants(kernel_source()).items()
              if not args.only or k in args.only}
    libs = build(chosen)
    want = fs.fused_s2vt_bwd_reference(*ins[(16, True)])
    direct_lib = next(iter(libs.values()))[0]          # the direct kernel is in every build
    errs = [max_err(fs.launch_bwd(*ins[(16, bf16)], "direct", lib=direct_lib),
                    fs.fused_s2vt_bwd_reference(*ins[(16, bf16)])) for bf16 in (False, True)]
    times = ", ".join(
        f"B={B} {_mode(bf16)} "
        f"{(ms := cuda_ms(lambda: fs.launch_bwd(*ins[(B, bf16)], 'direct', lib=direct_lib), args.reps)):.4f}"
        f" ms ({ms / (T + 1) * 1e3:.2f} us/iteration, L2 {l2_mib(B, bf16)})"
        for bf16 in (False, True) for B in BATCHES)
    print(f"fused_bwd direct route as built: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} at "
          f"B=16 T={T}; H={H} {times} [{card}]", flush=True)
    for name, (lib, report) in libs.items():
        def call(B, lib=lib):
            return fs.launch_bwd(*ins[(B, True)], "mma", lib=lib,
                                 plan=fs.fused_bwd_plan(H, B, True, props))

        got = call(16)
        torch.cuda.synchronize()
        err = max_err(got, want)
        note = "timing only" if name in TIMING_ONLY else "checked"
        sass = _variants.sass_sizes(OUT_DIR / f"{name}.so")
        times = []
        for B in BATCHES:
            plan = fs.fused_bwd_plan(H, B, True, props)
            ms = cuda_ms(lambda: call(B), args.reps)
            times.append(f"B={B} bf16 {plan.units}U/{plan.cluster}C/{plan.groups}G/"
                         f"{plan.pass_rows}x{plan.passes} {ms:.4f} ms "
                         f"({ms / (T + 1) * 1e3:.2f} us/iteration, L2 {l2_mib(B, True, plan)})")
        print(f"fused_bwd mma variant {name}: max_abs_err bf16 {err:.3e} at B=16 T={T} ({note}); "
              f"ptxas {ptxas_report(report)}; SASS instructions {sass}; H={H} "
              + ", ".join(times) + f" [{card}]", flush=True)
        if name == "phase_clock":
            for B in BATCHES:
                flat = call(B)[0].flatten()
                torch.cuda.synchronize()
                at = [(p % 4) * H + 2 * (p // 4) for p in range(len(PHASES))]
                cyc = [flat[a:a + 2].view(torch.float32).item() / (T + 1) for a in at]
                print(f"fused_bwd mma phases B={B} bf16 (block 0, thread 0, clock cycles per "
                      "iteration): " + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                      + f"; total {sum(cyc):.0f} [{card}]", flush=True)


def run_layouts(args, card) -> None:
    """Every layout (U = 8 from the shipped build, U = 4 from ``units4``) at
    T = 159 over SWEEP_BATCHES in bf16, each checked against the plain
    version at its first batch."""
    props = fs.bwd_card("cuda")
    libs = build(layout_sources(kernel_source()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for B in SWEEP_BATCHES:
        ins = inputs(B, True, dev, gen)
        want = fs.fused_s2vt_bwd_reference(*ins) if B == SWEEP_BATCHES[0] else None
        cells = []
        for units, cluster in LAYOUTS:
            plan = fs.fused_bwd_plan(H, B, True, props, units=units, cluster=cluster)
            if plan is None:
                continue
            lib = libs["as_built" if units in fs._BWD_UNITS else "units4"][0]
            if want is not None:
                err = f" err {max_err(fs.launch_bwd(*ins, 'mma', lib=lib, plan=plan), want):.3e}"
            else:
                err = ""
            ms = cuda_ms(lambda: fs.launch_bwd(*ins, "mma", lib=lib, plan=plan), args.reps)
            cells.append(f"{units}U/{cluster}C/{plan.groups}G/{plan.pass_rows}x{plan.passes} "
                         f"{ms:.4f} ms (L2 {l2_mib(B, True, plan)}){err}")
        chosen = fs.fused_bwd_plan(H, B, True, props)
        print(f"fused_bwd layouts B={B} bf16 H={H} T={T}: " + ", ".join(cells)
              + f"; plan takes U={chosen.units} C={chosen.cluster} [{card}]", flush=True)


def run_sweep(args, card) -> None:
    """Both routes of the shipped build in bf16, in turns, over
    SWEEP_BATCHES."""
    props = fs.bwd_card("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for B in SWEEP_BATCHES:
        plan = fs.fused_bwd_plan(H, B, True, props)
        if plan is None:
            continue
        ins = inputs(B, True, dev, gen)

        def mma(ins=ins, plan=plan):
            fs.launch_bwd(*ins, "mma", plan=plan)

        def direct(ins=ins):
            fs.launch_bwd(*ins, "direct")
        turns = [cuda_ms(f, args.reps) for f in (mma, direct, direct, mma)]
        m_ms, d_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        print(f"fused_bwd sweep B={B} bf16 H={H} T={T}: mma "
              f"{plan.units}U/{plan.cluster}C/{plan.groups}G/{plan.pass_rows}x{plan.passes} "
              f"{m_ms:.4f} ms, direct {d_ms:.4f} ms, route "
              f"{fs.fused_s2vt_bwd_route(H, B, True, props)} [{card}]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("mma", "layouts", "sweep", "all"), default="all")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed shape")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated variant names to build or run (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.route in ("mma", "all"):
        ins = {(B, bf16): inputs(B, bf16, dev, gen) for bf16 in (False, True) for B in BATCHES}
        run_mma(args, card, ins)
    if args.route in ("layouts", "all"):
        run_layouts(args, card)
    if args.route in ("sweep", "all"):
        run_sweep(args, card)


if __name__ == "__main__":
    main()
