"""Where the per-layer LSTM forward kernel's time goes, route by route.

    python -m s2vt_tpu_torch.tools.lstm_fwd_variants [--route direct|mma|sweep|all]
        [--reps 20] [--only as_built,phase_clock,...]

Builds ``csrc/lstm_seq_fwd.cu`` as it is and in variants that each change
one piece of one route's kernel, and prints for each the ``ptxas``
registers and spills of its entry functions, its largest error against the
plain version (B = 16, T = 80; "timing only" where the variant computes
something else on purpose) and its time per launch and per step at H = 512,
T in {80, 159}, B in {16, 96}, float32 and bf16 (CUDA events, the mean of
``--reps`` launches). Variants of the "direct" route (one cooperative
launch, a grid barrier per step, every block re-reading the whole [B, H] h
from L2, 16 batch rows per pass on the CUDA cores):

- ``no_barrier``: no grid barrier between steps;
- ``own_slice``: each block reads 1/8 of h (the exchange bytes fall 8x);
- ``no_products``: the h tile is staged but no product runs;
- ``one_pass``: only the first 16-row tile of the batch (B = 96: one pass
  in place of 6).

Variants of the "mma" route (batch groups, ``mma.sync`` products, h
exchanged as step-tagged words in place of a grid barrier):

- ``no_poll``: the words are taken as first read, tagged or not (the
  exchange's latency without the wait for its producers);
- ``poll_sleep``: 100 ns of ``__nanosleep`` before each poll round;
- ``late_xp``: x_proj read by each cell as it runs, at every batch;
- ``early_xp``: x_proj loaded before the products (so that it lands during
  them) at every batch, where the shipped kernel does so only for threads
  with several pairs per pass;
- ``cp_async``: x_proj staged by each thread's own ``cp.async`` into shared
  memory one step ahead (issued after the poll of the step before, so that
  it lands during the next poll), at every batch;
- ``tf32x3``: float32 products on the tensor cores as 3xTF32 (big rounded
  to TF32, a fresh partial per k slice joined by a round-to-nearest add), in
  place of fused multiply-adds on the CUDA cores in the direct route's
  order; the next three variants change this path and include it:
- ``group1``: one k slice in flight per warp in place of 4 (float32) or 2
  (bf16);
- ``one_sum``: float32's three TF32 products added into the running sum,
  in place of a fresh partial per k slice joined by a round-to-nearest add;
- ``trunc_split``: float32 operands split with big passed whole (read
  truncated by the tensor cores) in place of big rounded to TF32;
- ``fast_act``: sigmoid by ``__expf`` and tanh(x) as 2 sigmoid(2x) - 1 in
  the cells, in place of ``expf`` and ``tanhf``;
- ``no_stores``: the cells write only the exchange words, not h, the gates,
  c and the finals;
- ``no_products``: the rows are staged but no product runs (on either
  path);
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase
  of a step into words after the exchange (printed per step);

and layouts of the route as it is (launch parameters, not edits):
``units4``, ``units8``, ``units16`` and ``units32`` force U units per block,
with as many batch groups as the card holds (at H = 512 ``units4`` is one
group: every block reads all B rows, as the direct route's blocks do).

``--route sweep`` times the two routes as built, in turns (mma, direct,
direct, mma), at T = 80 and 159 over the batches SWEEP_BATCHES in both
modes, each
with the layout the route takes: where the mma route is faster.

``no_barrier``, ``own_slice``, ``no_products``, ``one_pass``, ``no_poll``,
``no_stores`` and ``phase_clock`` give wrong numbers (or time an instrumented build) and
only time a piece. Needs a card and ``nvcc``; builds into
``build/lstm_fwd_variants/`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from s2vt_tpu_torch.ops import _build, fused_rnn
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "lstm_fwd_variants"
H = 512
SEQ_LENS = (80, 159)
BATCHES = (16, 96)
SWEEP_BATCHES = (1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128)

# The direct route's pieces, by exact text.
_BARRIER = "    if (t + 1 < T) grid.sync();"
_NO_BARRIER = "    if (t + 1 < 0) grid.sync();"
_READ = "        const int n4 = bt * H / 4;"
_OWN_SLICE = "        const int n4 = bt * H / 32;"
_PRODUCTS = "\n        for (int k = lane; k < H; k += 32) {"
_NO_PRODUCTS = "\n        for (int k = lane; k < 0; k += 32) {"
_PASSES = "    for (int b0 = 0; b0 < B; b0 += kBatchTile) {"
_ONE_PASS = "    for (int b0 = 0; b0 < kBatchTile && b0 < B; b0 += kBatchTile) {"

DIRECT_TIMING_ONLY = ("no_barrier", "own_slice", "no_products", "one_pass")

# The mma route's pieces, by exact text.
_POLL = "            if (!stale) break;"
_XV_LOAD = "        xv[s] = xp[((size_t)t * B + b) * G4 + gate * H + j0 + u];\n"
_EARLY = "      const bool early_xp = ppp > 1;"
_SMEM_TAIL = "         (size_t)4 * C::kShares * 16 * tiles * C::kRedStride;"
_RED = ("  float* red = reinterpret_cast<float*>(hs + (size_t)RP * stride);   "
        "// [kShares][RP][kRedStride]\n")
# cp.async staging: step t's x_proj, staged one step earlier, read from shared
# memory; step t + 1's staged now (step 0 read directly).
_CP_ASYNC = """        cp_async_wait<0>();
        xv[s] = t == 0 ? xp[((size_t)t * B + b) * G4 + gate * H + j0 + u]
                       : xps[s * kThreads + tid];
        if (t + 1 < T)
          cp_async4((uint32_t)__cvta_generic_to_shared(xps + s * kThreads + tid),
                    xp + ((size_t)(t + 1) * B + b) * G4 + gate * H + j0 + u);
        cp_async_commit();
"""
_GROUP = "  static constexpr int kGroup = kBf16 ? 2 : 4;"
_SPLITS = ("                  split_tf32(__uint_as_float(bw[u][nt][j]), b_big[u][nt][j], "
           "b_small[u][nt][j]);",
           "                  split_tf32(__uint_as_float(a[u][j]), a_big[u][j], a_small[u][j]);")
_F32_CORES = "constexpr bool kF32OnCores = true;"
_TF32X3 = (_F32_CORES, "constexpr bool kF32OnCores = false;")
_POLL_ROUND = ("__device__ __forceinline__ void poll_round(unsigned long long& start, int step, "
               "int row) {\n")
_PASSES_TF32 = tuple(
    f"mma_tf32(part[u][nt], {a}[u], {b}[u][nt]);"
    for a, b in (("a_small", "b_big"), ("a_big", "b_small"), ("a_big", "b_big")))
_JOIN = "                  for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[u][nt][j];"
_SIGMOID = ("__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + "
            "expf(-x)); }")
_ACT = "        const float act = gate == 2 ? tanhf(pre) : sigmoid_f(pre);"
_TANH_C = "        const float h = og * tanhf(c);\n        carry[s] = c;"
_GATES_STORE = "        gates[row * G4 + (size_t)gate * H + j] = act;"
_H_STORE = "        if (gate == 0) {\n          out[row * H + j] = h;"
_CORE_PRODUCTS = "        for (int item = warp; item < kU / 2 * nbg; item += kWarps) {"
_MMA_PRODUCTS = "        for (int s0 = wk * per; s0 < (wk + 1) * per; s0 += C::kGroup) {"
_TAIL = "(size_t)2 * B * wrow"              # the first word after the exchange
TAIL_WORDS = 512
PHASES = ("poll", "products", "cells")
_PASS = "    for (int ps = 0; ps < npass; ++ps) {\n"
_STEPS = "  for (int t = 0; t < T; ++t) {\n" + _PASS
_STAGED_SYNC = "      __syncthreads();                              // hs holds the pass's rows\n"
_SHARES_SYNC = ("      __syncthreads();                              // every k share of the pass "
                "is written\n")
_KERNEL_END = "  }\n}\n\ntemplate <int kBf16, int kU>\ncudaError_t launch("
# (text, its replacement): block 0's thread 0 sums the clock cycles of each
# of PHASES (the cells of a pass until the next pass starts) and stores them
# after the exchange.
_PHASE_MARKS = (
    (_STEPS, f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = clock64();
  auto mark = [&](int phase) {{
    const long long now = clock64();
    clk[phase] += now - clk0;
    clk0 = now;
  }};
""" + _STEPS + "      mark(2);\n"),
    (_STAGED_SYNC, _STAGED_SYNC + "      mark(0);\n"),
    (_SHARES_SYNC, _SHARES_SYNC + "      mark(1);\n"),
    (_KERNEL_END, f"""  }}
  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph) xch[{_TAIL} + ph] = (unsigned long long)clk[ph];
}}

template <int kBf16, int kU>
cudaError_t launch("""))

MMA_TIMING_ONLY = ("no_poll", "no_stores", "no_products", "phase_clock")
LAYOUTS = ("units4", "units8", "units16", "units32")


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("lstm_seq_fwd")


def direct_variants(src: str) -> dict:
    """{name: source}: the direct route as it is and with one piece changed."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_barrier": sub(src, (_BARRIER, _NO_BARRIER)),
            "own_slice": sub(src, (_READ, _OWN_SLICE)),
            "no_products": sub(src, (_PRODUCTS, _NO_PRODUCTS)),
            "one_pass": sub(src, (_PASSES, _ONE_PASS))}


def mma_variants(src: str) -> dict:
    """{name: source}: the mma route as it is and with one piece changed or
    added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_poll": sub(src, (_POLL, "            if (true) break;")),
            "poll_sleep": sub(src, (_POLL_ROUND, _POLL_ROUND + "  __nanosleep(100);\n")),
            "late_xp": sub(src, (_EARLY, _EARLY.replace("ppp > 1", "false"))),
            "early_xp": sub(src, (_EARLY, _EARLY.replace("ppp > 1", "true"))),
            "cp_async": sub(src, (_EARLY, _EARLY.replace("ppp > 1", "true")),
                            (_SMEM_TAIL, _SMEM_TAIL[:-1] + " + (size_t)4 * kSlots * kThreads;"),
                            (_RED, _RED + "  float* xps = red + (size_t)C::kShares * RP * "
                                          "C::kRedStride;\n"),
                            (_XV_LOAD, _CP_ASYNC)),
            "tf32x3": sub(src, _TF32X3),
            "group1": sub(src, _TF32X3, (_GROUP, "  static constexpr int kGroup = kBf16 ? 1 : 1;")),
            "one_sum": sub(src, _TF32X3, *((p, p.replace("part[u][nt], ", "acc[mt][nt], "))
                                           for p in _PASSES_TF32),
                           (_JOIN, _JOIN.replace("j < 4", "j < 0"))),
            "trunc_split": sub(src, _TF32X3, *((p, p.replace("split_tf32(", "split_trunc("))
                                               for p in _SPLITS)),
            "fast_act": sub(src, (_SIGMOID, _SIGMOID.replace("expf(", "__expf(")),
                            (_ACT, "        const float act = gate == 2 ? 2.0f * "
                                   "sigmoid_f(2.0f * pre) - 1.0f : sigmoid_f(pre);"),
                            (_TANH_C, _TANH_C.replace("tanhf(c)",
                                                      "(2.0f * sigmoid_f(2.0f * c) - 1.0f)"))),
            "no_stores": sub(src, (_GATES_STORE, "        if (T < 0) " + _GATES_STORE.lstrip()),
                             (_H_STORE, _H_STORE.replace("gate == 0", "gate == 0 && T < 0"))),
            "no_products": sub(src, (_MMA_PRODUCTS, _MMA_PRODUCTS.replace(
                "s0 < (wk + 1) * per", "s0 < wk * per")),
                                (_CORE_PRODUCTS,
                                 _CORE_PRODUCTS.replace("item < kU", "item < 0 * kU"))),
            "phase_clock": sub(src, *_PHASE_MARKS)}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fused_rnn.set_fwd_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def inputs(B: int, T: int, device, gen):
    """The forward's inputs: x_proj_t, w_hh, h0, c0 at H."""
    k = 1.0 / H ** 0.5
    x = torch.randn(T, B, 4 * H, device=device, generator=gen)
    w = (torch.rand(4 * H, H, device=device, generator=gen) * 2 - 1) * k
    h0, c0 = (0.5 * torch.randn(B, H, device=device, generator=gen) for _ in range(2))
    return x, w, h0, c0


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


def chosen(variants: dict, only) -> dict:
    return {k: v for k, v in variants.items() if not only or k in only}


def max_err(got, want) -> float:
    outs, gates, cseq, fin = got
    return max((g - w).abs().max().item()
               for g, w in zip((outs, gates, cseq, fin[0], fin[1]), want))


def shapes():
    return [(T, B, bf16) for bf16 in (False, True) for T in SEQ_LENS for B in BATCHES]


def times_line(call, reps) -> str:
    return ", ".join(
        f"T={T} B={B} {'bf16' if bf16 else 'f32'} "
        f"{(ms := cuda_ms(lambda: call(T, B, bf16), reps)):.4f}"
        f" ms ({ms / T * 1e3:.2f} us/step)" for T, B, bf16 in shapes())


def run_direct(args, card, ins) -> None:
    libs = build(chosen(direct_variants(kernel_source()), args.only))
    for name, (lib, report) in libs.items():
        def call(T, B, bf16, lib=lib):
            return fused_rnn.launch_fwd(*ins[(T, B)], bf16, "direct", lib=lib)
        errs = []
        for bf16 in (False, True):
            got = call(80, 16, bf16)
            torch.cuda.synchronize()
            errs.append(max_err(got, fused_rnn.lstm_seq_fwd_reference(*ins[(80, 16)], bf16)))
        note = "timing only" if name in DIRECT_TIMING_ONLY else "checked"
        print(f"lstm_fwd direct variant {name}: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} "
              f"at B=16 T=80 ({note}); ptxas {ptxas_report(report)}; H={H} "
              f"{times_line(call, args.reps)} [{card}]", flush=True)


def launch_mma(lib, args, bf16: bool, plan):
    """One launch of an mma variant's kernel: (h seq, gates, c seq, fin) and
    the exchange with TAIL_WORDS spare words, where the phase_clock build
    writes its clocks at every launch."""
    T, B, G = args[0].shape
    dev = args[0].device
    hid = G // 4
    xch = torch.zeros(2 * B * (hid // 2 if bf16 else hid) + TAIL_WORDS, dtype=torch.int64,
                      device=dev)
    outs = (torch.empty(T, B, hid, device=dev), torch.empty(T, B, G, device=dev),
            torch.empty(T, B, hid, device=dev), torch.empty(2, B, hid, device=dev))
    _build.launch(lib, "lstm_seq_fwd_mma", "lstm_seq_fwd", (*args, *outs, xch),
                  (T, B, hid, plan.units, plan.groups, plan.tiles, int(bf16)))
    return outs, xch


def run_mma(args, card, ins) -> None:
    props = fused_rnn.card_props("cuda")
    libs = build({f"mma_{k}": v
                  for k, v in chosen(mma_variants(kernel_source()), args.only).items()})
    want = {bf16: fused_rnn.lstm_seq_fwd_reference(*ins[(80, 16)], bf16) for bf16 in (False, True)}
    runs = [(name[len("mma_"):], lib, report, None) for name, (lib, report) in libs.items()]
    if "mma_as_built" in libs:
        lib, report = libs["mma_as_built"]
        runs += [(name, lib, report, name) for name in LAYOUTS
                 if not args.only or name in args.only]
    for name, lib, report, layout in runs:
        def plan(B, bf16, layout=layout):
            if layout:
                return fused_rnn.mma_plan(H, B, bf16, props, units=int(layout[len("units"):]))
            return fused_rnn.mma_plan(H, B, bf16, props)

        def call(T, B, bf16, lib=lib):
            p = plan(B, bf16)
            return launch_mma(lib, ins[(T, B)], bf16, p) if p else None

        errs = []
        for bf16 in (False, True):
            got = call(80, 16, bf16)
            torch.cuda.synchronize()
            errs.append(max_err(got[0], want[bf16]) if got else float("nan"))
        note = "timing only" if name in MMA_TIMING_ONLY else "checked"
        served = [(T, B, bf16) for T, B, bf16 in shapes() if plan(B, bf16)]
        times = ", ".join(
            f"T={T} B={B} {'bf16' if bf16 else 'f32'} {plan(B, bf16).units}U/"
            f"{plan(B, bf16).groups}G {(ms := cuda_ms(lambda: call(T, B, bf16), args.reps)):.4f}"
            f" ms ({ms / T * 1e3:.2f} us/step)" for T, B, bf16 in served)
        print(f"lstm_fwd mma variant {name}: max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e} at "
              f"B=16 T=80 ({note}); ptxas {ptxas_report(report)}; H={H} {times} [{card}]",
              flush=True)
        if name == "phase_clock":
            for T, B, bf16 in served:
                xch = call(T, B, bf16)[1]
                torch.cuda.synchronize()
                words = 2 * B * (H // 2 if bf16 else H)
                cyc = [v / T for v in xch[words:words + len(PHASES)].tolist()]
                print(f"lstm_fwd mma phases T={T} B={B} {'bf16' if bf16 else 'f32'} (block 0, "
                      f"thread 0, clock cycles per step): "
                      + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                      + f"; total {sum(cyc):.0f} [{card}]", flush=True)


def run_sweep(args, card) -> None:
    """Both routes of the shipped build, in turns, over SWEEP_BATCHES."""
    props = fused_rnn.card_props("cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for bf16 in (False, True):
        for T in SEQ_LENS:
            for B in SWEEP_BATCHES:
                plan = fused_rnn.mma_plan(H, B, bf16, props)
                if plan is None:
                    continue
                ins = inputs(B, T, dev, gen)

                def mma(ins=ins, plan=plan, bf16=bf16):
                    fused_rnn.launch_fwd(*ins, bf16, "mma", plan=plan)

                def direct(ins=ins, bf16=bf16):
                    fused_rnn.launch_fwd(*ins, bf16, "direct")
                turns = [cuda_ms(f, args.reps) for f in (mma, direct, direct, mma)]
                m_ms, d_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                print(f"lstm_fwd sweep B={B} {'bf16' if bf16 else 'f32'} H={H} T={T}: mma "
                      f"{plan.units}U/{plan.groups}G/{plan.tiles}x{plan.passes} {m_ms:.4f} ms, "
                      f"direct {d_ms:.4f} ms, route "
                      f"{fused_rnn.lstm_seq_fwd_route(H, B, bf16, props)} [{card}]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("direct", "mma", "sweep", "all"), default="all")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed shape")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated variant names to build or run (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = {(T, B): inputs(B, T, dev, gen) for T in SEQ_LENS for B in BATCHES}
    if args.route in ("direct", "all"):
        run_direct(args, card, ins)
    if args.route in ("mma", "all"):
        run_mma(args, card, ins)
    if args.route in ("sweep", "all"):
        run_sweep(args, card)


if __name__ == "__main__":
    main()
