"""Where the per-layer GRU backward kernel's time goes, on its "mma" route.

    python -m s2vt_tpu_torch.tools.gru_bwd_variants [--route mma|layouts|sweep|all]
        [--reps 20] [--only as_built,phase_clock,...]

Builds ``csrc/gru_seq_bwd.cu`` as it is and in variants that each change
one piece of its "mma" route, and prints for each the ``ptxas`` registers
and spills of its entry functions, the machine instructions of its mma
kernels (``cuobjdump``), its largest error against the plain
version (B = 16, T = 80; "timing only" where the variant computes something
else on purpose), whether its float32 outputs equal the direct route's bit
for bit there, and its time per launch and per iteration at H = 512, T in
{80, 159}, B in {16, 96}, float32 and bf16 (CUDA events, the mean of
``--reps`` launches), beside the direct route as built. Every launch goes
through ``fused_gru.launch_bwd`` with the variant's library. The variants:

- ``no_poll``: the exchange words are taken as first read, tagged or not
  (the exchange's latency without the wait for its producers);
- ``no_stores``: the cells write only the exchange words, not dxp, dghn
  and dh0;
- ``no_products``: the rows are staged but no product runs (on either
  path);
- ``inputs_after_poll``: the cells' inputs (r, z, n, gh_n, h_{t-1}, dout)
  loaded after the poll, before the products, in place of before the poll;
- ``dn_unfused`` and ``dn_as_written``: 1 - n^2 as a rounded product and
  a difference, or written as an expression for nvcc to contract, in place
  of fma(-n, n, 1) (the expression forms of the gate backward; float32 is
  the direct route's only with the form the direct kernel compiles);
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase
  of a pass (the cells' input loads and the poll, the products, the cells)
  and writes
  the sums, as floats, over dxp[0, 0, 0:3]: units 0-2 of row 0 at step 0,
  written by block 0 alone and before its loop ends (printed per
  iteration);

and layouts of the route as it is (launch parameters, not edits):
``units4``, ``units8``, ``units16`` and ``units32`` force U units per block,
with as many batch groups as the card holds (32 in bf16 only).

``--route sweep`` times the two routes as built, in turns (mma, direct,
direct, mma), at T = 80 and 159 over the batches SWEEP_BATCHES in both
modes, each with the layout the route takes: where the mma route is faster.
``--route layouts`` times the route as built with every U at T = 159 over
SWEEP_BATCHES in both modes: which U the plan should take.

``no_poll``, ``no_stores``, ``no_products`` and ``phase_clock`` give wrong
numbers (or time an instrumented build) and only time a piece. Needs a card
and ``nvcc``; builds into ``build/gru_bwd_variants/`` at the root of the
checkout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from s2vt_tpu_torch.ops import _build, fused_gru
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "gru_bwd_variants"
H = 512
SEQ_LENS = (80, 159)
BATCHES = (16, 96)
SWEEP_BATCHES = (1, 2, 4, 8, 12, 14, 16, 18, 20, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200)

# The mma route's pieces, by exact text.
_POLL = "    if (!stale) break;"
_ROW = "        const size_t row = (size_t)t * B + b;       // off the critical path"
_MMA_PRODUCTS = "          for (int s0 = warp * per; s0 < s_end; s0 += C::kGroup) {"
_CORE_PRODUCTS = ("          for (int item = warp; item < nrq * kUnitItems * kSliceWarps; "
                  "item += kWarps) {")
_DN = "fmaf(-n, n, 1.0f)"
_IN_START = "      // The inputs of the pass's cells, loaded before the poll so that they\n"
_IN_END = "        in[s][5] = dout[row];\n      }\n"
_STAGED_SYNC = "      __syncthreads();                              // hs holds the pass's rows\n"
_SHARES_SYNC = ("        __syncthreads();                            // every partial sum of the "
                "pass is written\n")
_ITERS = ("  for (int it = 0; it <= T; ++it) {\n"
          "    const int t = T - 1 - it;                       // step; -1 in the last iteration\n"
          "    for (int ps = 0; ps < npass; ++ps) {\n")
_KERNEL_END = "      }\n    }\n  }\n}\n\ntemplate <int kBf16, int kU>\ncudaError_t launch("

PHASES = ("inputs and poll", "products", "cells")
# (text, its replacement): block 0's thread 0 sums the clock cycles of each
# of PHASES (the cells of a pass until the next pass starts) and stores them,
# as floats, over dxp[0, 0, :3]: units 0-2 of row 0 at step 0, written by
# block 0 alone and before its loop ends.
_PHASE_MARKS = (
    (_ITERS, f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = clock64();
  auto mark = [&](int phase) {{
    const long long now = clock64();
    clk[phase] += now - clk0;
    clk0 = now;
  }};
""" + _ITERS + "      mark(2);\n"),
    (_STAGED_SYNC, _STAGED_SYNC + "      mark(0);\n"),
    (_SHARES_SYNC, _SHARES_SYNC + "        mark(1);\n"),
    (_KERNEL_END, f"""      }}
    }}
  }}
  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph) dxp[ph] = (float)clk[ph];
}}

template <int kBf16, int kU>
cudaError_t launch("""))

# Every variant of CHANGED removes each of its texts and keeps the line count.
CHANGED = {
    "no_poll": (_POLL,),
    "no_stores": (_ROW,),
    "no_products": (_MMA_PRODUCTS, _CORE_PRODUCTS),
    "dn_unfused": (_DN,),
    "dn_as_written": (_DN,),
}
TIMING_ONLY = ("no_poll", "no_stores", "no_products", "phase_clock")
LAYOUTS = ("units4", "units8", "units16", "units32")


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("gru_seq_bwd")


def _moved_inputs(src: str) -> str:
    """The cells' input loads moved from before the poll to after it."""
    start, end = src.index(_IN_START), src.index(_IN_END) + len(_IN_END)
    block = src[start:end]
    return _variants.replace_once(src[:start] + src[end:], (_STAGED_SYNC, _STAGED_SYNC + block))


def mma_variants(src: str) -> dict:
    """{name: source}: the mma route as it is and with one piece changed or
    added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_poll": sub(src, (_POLL, "    if (true) break;")),
            "no_stores": sub(src, (_ROW, _ROW.replace("off the critical path",
                                                      "none") + " if (T > 0) continue;")),
            "no_products": sub(src, (_MMA_PRODUCTS, _MMA_PRODUCTS.replace("s0 < s_end",
                                                                          "s0 < warp * per")),
                               (_CORE_PRODUCTS, _CORE_PRODUCTS.replace("item < nrq",
                                                                       "item < 0 * nrq"))),
            "inputs_after_poll": _moved_inputs(src),
            "dn_unfused": sub(src, (_DN, "__fsub_rn(1.0f, __fmul_rn(n, n))")),
            "dn_as_written": sub(src, (_DN, "(1.0f - n * n)")),
            "phase_clock": sub(src, *_PHASE_MARKS)}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fused_gru.set_bwd_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def inputs(B: int, T: int, device, gen):
    """The backward's inputs at H: gates (r, z in (0, 1), n in (-1, 1)),
    gh_n, h_{t-1}, w_hh [3H, H], dout, dhT."""
    def n(*shape):
        return torch.randn(*shape, device=device, generator=gen)
    pre = n(T, B, 3 * H)
    gates = torch.cat([torch.sigmoid(pre[..., :2 * H]), torch.tanh(pre[..., 2 * H:])], -1)
    w = (torch.rand(3 * H, H, device=device, generator=gen) * 2 - 1) / H ** 0.5
    return gates.contiguous(), n(T, B, H), torch.tanh(n(T, B, H)), w, n(T, B, H), n(B, H)


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
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def shapes():
    return [(T, B, bf16) for bf16 in (False, True) for T in SEQ_LENS for B in BATCHES]


def run_mma(args, card, ins) -> None:
    props = _build.card("cuda")
    chosen = {k: v for k, v in mma_variants(kernel_source()).items()
              if not args.only or k in args.only}
    libs = build(chosen)
    want = {bf16: fused_gru.gru_seq_bwd_reference(*ins[(80, 16)], bf16) for bf16 in (False, True)}
    runs = [(name, lib, report, None) for name, (lib, report) in libs.items()]
    if "as_built" in libs:
        lib, report = libs["as_built"]
        runs += [(name, lib, report, name) for name in LAYOUTS
                 if not args.only or name in args.only]
    direct_lib = next(iter(libs.values()))[0]          # the direct kernel is in every build
    direct = {bf16: fused_gru.launch_bwd(*ins[(80, 16)], bf16, "direct", lib=direct_lib)
              for bf16 in (False, True)}
    errs = [max_err(direct[bf16], want[bf16]) for bf16 in (False, True)]

    def direct_call(T, B, bf16):
        return fused_gru.launch_bwd(*ins[(T, B)], bf16, "direct", lib=direct_lib)
    times = ", ".join(
        f"T={T} B={B} {'bf16' if bf16 else 'f32'} "
        f"{(ms := cuda_ms(lambda: direct_call(T, B, bf16), args.reps)):.4f}"
        f" ms ({ms / (T + 1) * 1e3:.2f} us/iteration)" for T, B, bf16 in shapes())
    print(f"gru_bwd direct route as built: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} at "
          f"B=16 T=80; H={H} {times} [{card}]", flush=True)
    for name, lib, report, layout in runs:
        def plan(B, bf16, layout=layout):
            units = int(layout[len("units"):]) if layout else None
            return fused_gru.gru_bwd_mma_plan(H, B, bf16, props, units=units)

        def call(T, B, bf16, lib=lib):
            p = plan(B, bf16)
            return fused_gru.launch_bwd(*ins[(T, B)], bf16, "mma", lib=lib, plan=p) if p else None

        errs, same = [], "n/a"
        for bf16 in (False, True):
            got = call(80, 16, bf16)
            torch.cuda.synchronize()
            errs.append(max_err(got, want[bf16]) if got else float("nan"))
            if got and not bf16:
                same = "/".join("yes" if torch.equal(g, d) else "no"
                                for g, d in zip(got, direct[False]))
        note = "timing only" if name in TIMING_ONLY else "checked"
        sass = _variants.sass_sizes(OUT_DIR / f"{'as_built' if layout else name}.so")
        served = [(T, B, bf16) for T, B, bf16 in shapes() if plan(B, bf16)]
        times = ", ".join(
            f"T={T} B={B} {'bf16' if bf16 else 'f32'} {plan(B, bf16).units}U/"
            f"{plan(B, bf16).groups}G/{plan(B, bf16).tiles}x{plan(B, bf16).passes} "
            f"{(ms := cuda_ms(lambda: call(T, B, bf16), args.reps)):.4f}"
            f" ms ({ms / (T + 1) * 1e3:.2f} us/iteration)" for T, B, bf16 in served)
        print(f"gru_bwd mma variant {name}: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} at "
              f"B=16 T=80 ({note}); f32 equal to the direct route (dxp/dghn/dh0) {same}; "
              f"ptxas {ptxas_report(report)}; SASS instructions {sass}; H={H} {times} "
              f"[{card}]", flush=True)
        if name.startswith("phase_clock"):
            for T, B, bf16 in served:
                dxp = call(T, B, bf16)[0]
                torch.cuda.synchronize()
                cyc = [v / (T + 1) for v in dxp.flatten()[:len(PHASES)].tolist()]
                print(f"gru_bwd mma phases T={T} B={B} {'bf16' if bf16 else 'f32'} (block 0, "
                      f"thread 0, clock cycles per iteration): "
                      + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                      + f"; total {sum(cyc):.0f} [{card}]", flush=True)


def run_layouts(args, card) -> None:
    """The shipped build with every U, at T = 159, over SWEEP_BATCHES."""
    props = _build.card("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    T = SEQ_LENS[-1]
    for bf16 in (False, True):
        for B in SWEEP_BATCHES:
            ins = inputs(B, T, dev, gen)
            cells = []
            for units in (4, 8, 16, 32):
                plan = fused_gru.gru_bwd_mma_plan(H, B, bf16, props, units=units)
                if plan is None:
                    continue
                ms = cuda_ms(lambda: fused_gru.launch_bwd(*ins, bf16, "mma", plan=plan), args.reps)
                cells.append(f"{units}U/{plan.groups}G/{plan.tiles}x{plan.passes} {ms:.4f} ms")
            chosen = fused_gru.gru_bwd_mma_plan(H, B, bf16, props)
            print(f"gru_bwd layouts B={B} {'bf16' if bf16 else 'f32'} H={H} T={T}: "
                  + ", ".join(cells) + f"; plan takes U={chosen.units} [{card}]", flush=True)


def run_sweep(args, card) -> None:
    """Both routes of the shipped build, in turns, over SWEEP_BATCHES."""
    props = _build.card("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for bf16 in (False, True):
        for T in SEQ_LENS:
            for B in SWEEP_BATCHES:
                plan = fused_gru.gru_bwd_mma_plan(H, B, bf16, props)
                if plan is None:
                    continue
                ins = inputs(B, T, dev, gen)

                def mma(ins=ins, plan=plan, bf16=bf16):
                    fused_gru.launch_bwd(*ins, bf16, "mma", plan=plan)

                def direct(ins=ins, bf16=bf16):
                    fused_gru.launch_bwd(*ins, bf16, "direct")
                turns = [cuda_ms(f, args.reps) for f in (mma, direct, direct, mma)]
                m_ms, d_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                print(f"gru_bwd sweep B={B} {'bf16' if bf16 else 'f32'} H={H} T={T}: mma "
                      f"{plan.units}U/{plan.groups}G/{plan.tiles}x{plan.passes} {m_ms:.4f} ms, "
                      f"direct {d_ms:.4f} ms, route "
                      f"{fused_gru.gru_seq_bwd_route(H, B, bf16, props)} [{card}]", flush=True)


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
        ins = {(T, B): inputs(B, T, dev, gen) for T in SEQ_LENS for B in BATCHES}
        run_mma(args, card, ins)
    if args.route in ("layouts", "all"):
        run_layouts(args, card)
    if args.route in ("sweep", "all"):
        run_sweep(args, card)


if __name__ == "__main__":
    main()
