"""Where the fused dual-LSTM S2VT forward kernel's time goes, route by route.

    python -m s2vt_tpu_torch.tools.fused_fwd_variants [--route mma|sweep|all]
        [--reps 20] [--only as_built,phase_clock,...]

Builds ``csrc/fused_s2vt_fwd.cu`` as it is and in variants that each change
one piece of its "mma" route, and prints for each the ``ptxas`` registers
and spills of its entry functions, the machine instructions of its mma
kernels (``cuobjdump``), its largest error against the plain
version (B = 16, T = 159; "timing only" where the variant computes something
else on purpose) and its time per launch and per iteration at H = 512,
T = 159 (T + 1 iterations), B in {16, 96}, float32 and bf16 (CUDA events,
the mean of ``--reps`` launches), beside the direct route as built. The
variants:

- ``no_poll``: the exchange words are taken as first read, tagged or not
  (the exchange's latency without the wait for its producers);
- ``no_stores``: the cells write only the exchange words, not the gates, c,
  the finals and the snapshot;
- ``no_products``: the rows are staged but no product runs;
- ``no_x``: the cells add no x;
- ``poll_sleep``: 200 ns of ``__nanosleep`` before each poll round;
- ``poll_one``: a poll round re-reads one stale word per lane, in place of
  every stale word;
- ``no_x_stage``: no copy of the pass's x into shared memory before its
  poll: each cell loads its own x from global memory;
- ``tf32x3``: float32 products on the tensor cores as 3xTF32 (big rounded
  to TF32, a fresh partial per k slice joined by a round-to-nearest add), in
  place of fused multiply-adds on the CUDA cores in the direct route's
  order;
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase of
  an iteration (the x copies and the poll, the products, the cells) and
  writes the sums over the first words of c1, which only block 0 writes
  (printed per iteration);

and layouts of the route as it is (launch parameters, not edits): ``units4``
and ``units8`` force U units per block with as many batch groups as the card
holds (float32 at U = 8 does not fit at H = 512).

``--route sweep`` times the two routes as built, in turns (mma, direct,
direct, mma), at T = 159 over the batches SWEEP_BATCHES in both modes, each
with the layout the route takes: where the mma route is faster.

``no_poll``, ``no_stores``, ``no_products``, ``no_x`` and ``phase_clock`` give
wrong numbers (or time an instrumented build) and only time a piece. Needs a card
and ``nvcc``; builds into ``build/fused_fwd_variants/`` at the root of the
checkout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops import fused_s2vt as fs
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "fused_fwd_variants"
H = 512
T = 159
BATCHES = (16, 96)
SWEEP_BATCHES = (1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200)

# The mma route's pieces, by exact text.
_POLL = "            if (!stale) break;"
_F32_CORES = "constexpr bool kF32OnCores = true;"
_GATES_STORE = ("        (layer == 0 ? g1 : g2)[row * G4 + (size_t)gate * H + j] = "
                "from_f<Elem>(act);")
_C_STORE = "        if (gate == 0) {\n          (layer == 0 ? c1 : c2)[row * H + j] = c;"
_MMA_PRODUCTS = "        for (int s0 = wk * per; s0 < (wk + 1) * per; s0 += C::kGroup) {"
_CORE_PRODUCTS = "        for (int item = warp; item < items; item += kWarps) {"
_X_LOAD = "          x = to_f(xb[((layer * RP + r) * 4 + gate) * kU + u]);"
_X_COPY = "        for (int idx = tid; idx < 8 * rp * kPer; idx += kThreads) {"
_POLL_ROUND = ("__device__ __forceinline__ void poll_round(unsigned long long& start, int iter, "
               "int row) {\n")
_ROUND = "            poll_round(start, t - 1, b0 + pr0 + r0 + warp);\n"
_RELOAD = ("                if (r < rp && col < v2row && !tagged(v[rr][i], tag))\n"
           "                  ld_words(v[rr][i], base + (size_t)r * wrow + 2 * col);")
_STAGED_SYNC = "      __syncthreads();                              // hs holds the pass's rows\n"
# Every variant of CHANGED removes each of its texts and keeps the line count.
CHANGED = {
    "no_poll": (_POLL,),
    "no_stores": (_GATES_STORE, _C_STORE),
    "no_products": (_MMA_PRODUCTS, _CORE_PRODUCTS),
    "no_x": (_X_LOAD,),
    "no_x_stage": (_X_LOAD, _X_COPY),
    "tf32x3": (_F32_CORES,),
}
TIMING_ONLY = ("no_poll", "no_stores", "no_products", "no_x", "phase_clock")
LAYOUTS = ("units4", "units8")

PHASES = ("poll", "products", "cells")
_PASS = "    for (int ps = 0; ps < npass; ++ps) {\n"
_ITERS = "  for (int t = 0; t <= T; ++t) {\n" + _PASS
_SUMS_SYNC = ("      __syncthreads();                              // every gate sum of the pass "
              "is written\n")
_KERNEL_END = "  }\n}\n\ntemplate <int kBf16, int kU>\ncudaError_t launch("
# (text, its replacement): block 0's thread 0 sums the clock cycles of each
# of PHASES (the cells of a pass until the next pass starts) and stores them,
# as floats, over c1[0, 0, :3]: units 0-2 of row 0 at step 0, written by
# block 0 alone and long before its loop ends.
_PHASE_MARKS = (
    (_ITERS, f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = clock64();
  auto mark = [&](int phase) {{
    const long long now = clock64();
    clk[phase] += now - clk0;
    clk0 = now;
  }};
""" + _ITERS + "      mark(2);\n"),
    (_STAGED_SYNC, _STAGED_SYNC + "      mark(0);\n"),
    (_SUMS_SYNC, _SUMS_SYNC + "      mark(1);\n"),
    (_KERNEL_END, f"""  }}
  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph)
      c1[ph] = (float)clk[ph];
}}

template <int kBf16, int kU>
cudaError_t launch("""))


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("fused_s2vt_fwd")


def mma_variants(src: str) -> dict:
    """{name: source}: the mma route as it is and with one piece changed or
    added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_poll": sub(src, (_POLL, "            if (true) break;")),
            "no_stores": sub(src, (_GATES_STORE, "        if (T < 0) " + _GATES_STORE.lstrip()),
                             (_C_STORE, _C_STORE.replace("gate == 0", "gate == 0 && T < 0"))),
            "no_products": sub(src, (_MMA_PRODUCTS, _MMA_PRODUCTS.replace(
                "s0 < (wk + 1) * per", "s0 < wk * per")),
                               (_CORE_PRODUCTS, _CORE_PRODUCTS.replace("item < items",
                                                                       "item < 0 * items"))),
            "no_x": sub(src, (_X_LOAD, "          x = 0.0f;")),
            "poll_sleep": sub(src, (_POLL_ROUND, _POLL_ROUND + "  __nanosleep(200);\n")),
            "poll_one": sub(src, (_ROUND, _ROUND + "            bool once = false;\n"),
                            (_RELOAD, _RELOAD.replace("!tagged(v[rr][i], tag))",
                                                      "!tagged(v[rr][i], tag) && !once)")
                             .replace(");", "), once = true;"))),
            "no_x_stage": sub(src, (_X_COPY, _X_COPY.replace("idx < 8", "idx < 0 * 8")),
                              (_X_LOAD, "          x = to_f((layer == 0 ? x1 : x2)[((size_t)step * B + "
                                        "b) * G4 + gate * H + j]);")),
            "tf32x3": sub(src, (_F32_CORES, "constexpr bool kF32OnCores = false;")),
            "phase_clock": sub(src, *_PHASE_MARKS)}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fs.set_fwd_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def sass_sizes(name: str) -> str:
    """Machine instructions of each mma-route kernel of variant ``name``'s
    library."""
    return _variants.sass_sizes(OUT_DIR / f"{name}.so")


def inputs(B: int, bf16: bool, device, gen):
    """The forward's inputs at H, T: x1, x2 [T, B, 4H] and the three [4H, H]
    weights, in the mode's dtype."""
    k = 1.0 / H ** 0.5
    mmd = torch.bfloat16 if bf16 else torch.float32
    xs = [torch.randn(T, B, 4 * H, device=device, generator=gen).to(mmd) for _ in range(2)]
    ws = [((torch.rand(4 * H, H, device=device, generator=gen) * 2 - 1) * k).to(mmd)
          for _ in range(3)]
    return xs + ws


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
    g1, c1, g2, c2, fin = got
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip((g1, c1, g2, c2, *fin.unbind(0)), want))


def shapes():
    return [(B, bf16) for bf16 in (False, True) for B in BATCHES]


def run_mma(args, card, ins) -> None:
    props = _build.card("cuda")
    want = {bf16: fs.fused_s2vt_fwd_reference(*ins[(16, bf16)], T // 2) for bf16 in (False, True)}
    chosen = {k: v for k, v in mma_variants(kernel_source()).items()
              if not args.only or k in args.only}
    libs = build(chosen)
    runs = [(name, lib, report, None) for name, (lib, report) in libs.items()]
    if "as_built" in libs:
        lib, report = libs["as_built"]
        runs += [(name, lib, report, name) for name in LAYOUTS
                 if not args.only or name in args.only]
    errs = [max_err(fs.launch_fwd(*ins[(16, bf16)], T // 2, "direct"), want[bf16])
            for bf16 in (False, True)]
    direct = ", ".join(
        f"B={B} {'bf16' if bf16 else 'f32'} "
        f"{(ms := cuda_ms(lambda: fs.launch_fwd(*ins[(B, bf16)], T // 2, 'direct'), args.reps)):.4f}"
        f" ms ({ms / (T + 1) * 1e3:.2f} us/iteration)" for B, bf16 in shapes())
    print(f"fused_fwd direct route as built: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} at "
          f"B=16 T={T}; H={H} T={T} {direct} [{card}]", flush=True)
    for name, lib, report, layout in runs:
        def plan(B, bf16, layout=layout):
            units = int(layout[len("units"):]) if layout else None
            return fs.fused_fwd_plan(H, B, bf16, props, units=units)

        def call(B, bf16, lib=lib):
            p = plan(B, bf16)
            return fs.launch_fwd(*ins[(B, bf16)], T // 2, "mma", lib=lib, plan=p) if p else None

        errs = []
        for bf16 in (False, True):
            got = call(16, bf16)
            torch.cuda.synchronize()
            errs.append(max_err(got, want[bf16]) if got else float("nan"))
        note = "timing only" if name in TIMING_ONLY else "checked"
        served = [(B, bf16) for B, bf16 in shapes() if plan(B, bf16)]
        times = ", ".join(
            f"B={B} {'bf16' if bf16 else 'f32'} {plan(B, bf16).units}U/{plan(B, bf16).groups}G/"
            f"{plan(B, bf16).tiles}x{plan(B, bf16).passes} "
            f"{(ms := cuda_ms(lambda: call(B, bf16), args.reps)):.4f} ms "
            f"({ms / (T + 1) * 1e3:.2f} us/iteration)" for B, bf16 in served)
        print(f"fused_fwd mma variant {name}: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} "
              f"at B=16 T={T} ({note}); ptxas {ptxas_report(report)}; SASS instructions "
              f"{sass_sizes(name if layout is None else 'as_built')}; H={H} T={T} {times} "
              f"[{card}]", flush=True)
        if name == "phase_clock":
            for B, bf16 in served:
                c1 = call(B, bf16)[1]
                torch.cuda.synchronize()
                cyc = [v / (T + 1) for v in c1.flatten()[:len(PHASES)].tolist()]
                print(f"fused_fwd mma phases T={T} B={B} {'bf16' if bf16 else 'f32'} (block 0, "
                      f"thread 0, clock cycles per iteration): "
                      + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                      + f"; total {sum(cyc):.0f} [{card}]", flush=True)


def run_sweep(args, card) -> None:
    """Both routes of the shipped build, in turns, over SWEEP_BATCHES."""
    props = _build.card("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for bf16 in (False, True):
        for B in SWEEP_BATCHES:
            plan = fs.fused_fwd_plan(H, B, bf16, props)
            if plan is None:
                continue
            ins = inputs(B, bf16, dev, gen)

            def mma(ins=ins, plan=plan):
                fs.launch_fwd(*ins, T // 2, "mma", plan=plan)

            def direct(ins=ins):
                fs.launch_fwd(*ins, T // 2, "direct")
            turns = [cuda_ms(f, args.reps) for f in (mma, direct, direct, mma)]
            m_ms, d_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            print(f"fused_fwd sweep B={B} {'bf16' if bf16 else 'f32'} H={H} T={T}: mma "
                  f"{plan.units}U/{plan.groups}G/{plan.tiles}x{plan.passes} {m_ms:.4f} ms, "
                  f"direct {d_ms:.4f} ms, route "
                  f"{fs.fused_s2vt_fwd_route(H, B, bf16, props)} [{card}]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("mma", "sweep", "all"), default="all")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed shape")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated variant names to build or run (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.route in ("mma", "all"):
        ins = {(B, bf16): inputs(B, bf16, dev, gen) for B, bf16 in shapes()}
        run_mma(args, card, ins)
    if args.route in ("sweep", "all"):
        run_sweep(args, card)


if __name__ == "__main__":
    main()
