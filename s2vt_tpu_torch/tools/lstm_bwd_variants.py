"""Where the per-layer LSTM backward kernel's time goes, route by route.

    python -m s2vt_tpu_torch.tools.lstm_bwd_variants [--route direct|cluster|all] [--reps 20]
        [--only as_built,phase_clock,...]

Builds ``csrc/lstm_seq_bwd.cu`` as it is and in variants that each change
one piece of one route's kernel, and prints for each the ``ptxas``
registers and spills of its entry functions, its largest error against the
plain version (B = 16, T = 159, float32; "timing only" where the variant
computes something else on purpose) and its time per launch and per
iteration (T + 1 of them) at H = 512, T = 159, float32, B in {16, 96}
(CUDA events, the mean of ``--reps`` launches). Variants of the "direct"
route (one cooperative launch, a grid barrier per iteration, every block
re-reading the whole [B, 4H] exchange from L2, 16 batch rows per pass on
the CUDA cores):

- ``no_barrier``: no grid barrier between iterations;
- ``own_slice``: each block reads 1/8 of ``dxp[t + 1]`` (the exchange bytes
  fall 8x);
- ``no_products``: no exchange read and no products at all;
- ``one_pass``: only the first 16-row tile of the batch (all but B = 16:
  one pass in place of B / 16).

Variants of the "cluster" route (clusters of Q blocks that sum gate-sliced
partials through distributed shared memory, ``mma.sync`` products, the
exchange polled as tagged words in place of a grid barrier):

- ``q16``: 16 blocks per cluster in place of 8 (4 clusters at H = 512; 4
  blocks per cluster would need a slice of 512 gate rows, which the route
  does not hold);
- ``grid_barrier``: a grid-wide barrier (an atomic counter after the
  exchange) every iteration, on top of the polled exchange;
- ``poll_sleep``: 100 ns of ``__nanosleep`` between polls of stale words;
- ``sys_scope``: the exchange words stored and polled by volatile
  (system-scope) accesses, as NCCL's LL protocol does, in place of relaxed
  gpu-scope ones;
- ``group_half``: half the k slices in flight at once per warp (1 in
  float32, 2 in bf16);
- ``rna_split``: the float32 operands split as mma.cuh does (big rounded
  to TF32) in place of big passed whole;
- ``opaque_w``: the float32 W fragments made opaque before each split, so
  that the compiler cannot hoist the split out of the loops (it does, and
  spills a little);
- ``no_products``: the slice is staged but no product runs;
- ``no_poll``: the words are taken as first read, tagged or not (the
  exchange's latency without the wait for its producers);
- ``no_push``: each block stores the partials into its own shared memory
  in place of the owners' (no distributed shared memory);
- ``no_cluster_barrier``: no cluster barrier between the partials and
  their reads;
- ``phase_clock``: block 0's thread 0 sums the clock cycles of each phase
  of an iteration into words after the exchange (printed per iteration).

The cluster variants launch with 512 spare words after the exchange, for
the grid barrier's counter and the phase clocks.

``no_barrier``, ``own_slice``, ``no_products``, ``one_pass``, ``no_poll``,
``no_push``, ``no_cluster_barrier`` and ``phase_clock`` give wrong numbers
(or time an instrumented build) and only time a piece. Needs a card and
``nvcc``; builds into ``build/lstm_bwd_variants/`` at the root of the
checkout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from s2vt_tpu_torch.ops import _build, fused_rnn
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "lstm_bwd_variants"
H, T = 512, 159
BATCHES = (16, 96)

# The direct route's pieces, by exact text.
_BARRIER = "    if (it < T) grid.sync();"
_NO_BARRIER = "    if (it < 0) grid.sync();"
_READ = "        for (int ch = slice; ch < nchunk; ch += kSlices) {"
_OWN_SLICE = "        for (int ch = slice; ch < nchunk / 8; ch += kSlices) {"
_NO_READ = "        for (int ch = slice; ch < 0; ch += kSlices) {"
_PASSES = "    for (int b0 = 0; b0 < B; b0 += kRowTile) {"
_ONE_PASS = "    for (int b0 = 0; b0 < kRowTile && b0 < B; b0 += kRowTile) {"

DIRECT_TIMING_ONLY = ("no_barrier", "own_slice", "no_products", "one_pass")

# The cluster route's pieces, by exact text.
_Q = "constexpr int kQ = 8;"
_SMEM_ATTR = ("      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
              "(int)smem);\n")
_NON_PORTABLE = ("  if (err == cudaSuccess)\n    err = cudaFuncSetAttribute(kernel, "
                 "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")
_GROUP = "  static constexpr int kGroup = kBf16 ? 4 : 2;"
_PRODUCTS = "        for (int s0 = 0; s0 < C::kMaxSlices; s0 += C::kGroup) {"
_POLL = "        if (!stale) break;"
_POLL_TRAP = "        else if (now - start > kSpinLimitNs) poll_trap(now - start, step, b);\n"
_W_SPLIT = "                  uint32_t big[2], small[2];\n"
_ST_WORD = 'asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\\n"'
_LD_WORDS = 'asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\\n"'
_CBARRIER = ("      cluster_barrier();                            "
             "// every partial of the cluster has arrived\n")
_PUSH = "          float* to = cluster.map_shared_rank(recvp, n / kUnits);"
_SPLIT = "  big = __float_as_uint(v);\n  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u));"
_RNA_SPLIT = "  big = tf32_rna(v);\n  small = __float_as_uint(v - __uint_as_float(big));"
_PREFETCH = "    if (t > 0) prefetch(t - 1);                     // lands during the next poll\n"
_TAIL = "(size_t)2 * B * G"                  # the first word after the exchange
TAIL_WORDS = 512
_GRID_BARRIER = f"""    __syncthreads();
    if (tid == 0) {{
      unsigned* count = reinterpret_cast<unsigned*>(xch + {_TAIL});
      __threadfence();
      atomicAdd(count, 1u);
      while (*reinterpret_cast<volatile unsigned*>(count) < gridDim.x * (it + 1)) {{
      }}
    }}
    __syncthreads();
"""
PHASES = ("poll", "other polls", "products", "push", "cluster barrier", "cells", "prefetch")
# (text, code before it, code after it): block 0's thread 0 sums the clock
# cycles of each of PHASES and stores them after the exchange.
_PHASE_MARKS = (
    ("  cluster_barrier();   // every block of the cluster runs before any pushes into it\n",
     f"""  long long clk[{len(PHASES)}] = {{}}, clk0 = 0;
  auto mark = [&](int phase) {{
    const long long now = clock64();
    if (phase >= 0) clk[phase] += now - clk0;
    clk0 = now;
  }};
""", ""),
    ("    float* recvp = recv + (it & 1) * kQ * rows * kUnits;\n", "", "    mark(-1);\n"),
    ("      land(step, 0, 0);\n", "", "      mark(0);\n"),
    ("        __syncthreads();       // tile mt is in its slot; tile mt - 1's products and k "
     "shares are done\n", "", "        if (mt == 0) mark(1);\n"),
    ("      __syncthreads();                              // the last tile's k shares are "
     "written\n", "", "      mark(2);\n"),
    ("      push(MT - 1);\n", "", "      mark(3);\n"),
    (_CBARRIER, "", "      mark(4);\n"),
    (_PREFETCH, "    mark(5);\n", "    mark(6);\n"),
    ("  cluster_barrier();   // no block leaves while another may still push into it\n",
     f"""  if (blockIdx.x == 0 && tid == 0)
    for (int ph = 0; ph < {len(PHASES)}; ++ph) xch[{_TAIL} + ph] = (unsigned long long)clk[ph];
""", ""))

CLUSTER_TIMING_ONLY = ("no_products", "no_poll", "phase_clock", "no_cluster_barrier", "no_push")


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("lstm_seq_bwd")


def direct_variants(src: str) -> dict:
    """{name: source}: the direct route as it is and with one piece changed."""
    sub = _variants.replace_once
    return {"as_built": src,
            "no_barrier": sub(src, (_BARRIER, _NO_BARRIER)),
            "own_slice": sub(src, (_READ, _OWN_SLICE)),
            "no_products": sub(src, (_READ, _NO_READ)),
            "one_pass": sub(src, (_PASSES, _ONE_PASS))}


def cluster_variants(src: str) -> dict:
    """{name: source}: the cluster route as it is and with one piece changed
    or added."""
    sub = _variants.replace_once
    return {"as_built": src,
            "q16": sub(src, (_Q, "constexpr int kQ = 16;"),
                       (_SMEM_ATTR, _SMEM_ATTR + _NON_PORTABLE)),
            "grid_barrier": sub(src, (_PREFETCH, _GRID_BARRIER + _PREFETCH)),
            "poll_sleep": sub(src, (_POLL_TRAP, _POLL_TRAP + "        __nanosleep(100);\n")),
            "group_half": sub(src, (_GROUP, "  static constexpr int kGroup = kBf16 ? 2 : 1;")),
            "opaque_w": sub(src, (_W_SPLIT, _W_SPLIT[:-1] + ' asm volatile("" : "+r"(wf[s0 + u][nt][0]), '
                                                           '"+r"(wf[s0 + u][nt][1]));\n')),
            "no_products": sub(src, (_PRODUCTS, _PRODUCTS.replace("s0 < C::kMaxSlices",
                                                                   "s0 < 0"))),
            "no_poll": sub(src, (_POLL, "        if (true) break;")),
            "phase_clock": sub(src, *((text, before + text + after)
                                      for text, before, after in _PHASE_MARKS)),
            "sys_scope": sub(src, (_ST_WORD, _ST_WORD.replace("relaxed.gpu", "volatile")),
                             (_LD_WORDS, _LD_WORDS.replace("relaxed.gpu", "volatile"))),
            "rna_split": sub(src, (_SPLIT, _RNA_SPLIT)),
            "no_cluster_barrier": sub(src, (_CBARRIER, "      // no cluster barrier\n")),
            "no_push": sub(src, (_PUSH, "          float* to = recvp;"))}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    for lib, _ in libs.values():
        fused_rnn.set_bwd_signatures(lib)
    return libs


def ptxas_report(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report))


def inputs(B: int, device, gen):
    """The backward's inputs from a plain forward run (real LSTM states)."""
    k = 1.0 / H ** 0.5
    x = torch.randn(T, B, 4 * H, device=device, generator=gen)
    w = (torch.rand(4 * H, H, device=device, generator=gen) * 2 - 1) * k
    h0, c0 = (0.5 * torch.randn(B, H, device=device, generator=gen) for _ in range(2))
    outs, gates, cseq, _, _ = fused_rnn.lstm_seq_fwd_reference(x, w, h0, c0, False)
    cprev = torch.cat([c0[None], cseq[:-1]])
    grads = [torch.randn(s, device=device, generator=gen) for s in ((T, B, H), (B, H), (B, H))]
    return (gates, cseq, cprev, w, *grads)


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


def run_direct(args, reps, card) -> None:
    libs = build(chosen(direct_variants(kernel_source()), args.only))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = {B: inputs(B, dev, gen) for B in BATCHES}
    want = fused_rnn.lstm_seq_bwd_reference(*ins[16], False)
    for name, (lib, report) in libs.items():
        def call(B, lib=lib):
            return fused_rnn.launch_bwd(*ins[B], False, "direct", lib=lib)
        got = call(16)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        note = "timing only" if name in DIRECT_TIMING_ONLY else "checked"
        times = ", ".join(f"B={B} {(ms := cuda_ms(lambda: call(B), reps)):.4f} ms "
                          f"({ms / (T + 1) * 1e3:.2f} us per iteration)" for B in BATCHES)
        print(f"lstm_bwd direct variant {name}: max_abs_err {err:.3e} at B=16 ({note}); "
              f"ptxas {ptxas_report(report)}; time H={H} T={T} float32 {times} [{card}]",
              flush=True)


def launch_cluster(lib, args, bf16: bool):
    """One launch of a cluster variant's kernel: (dxp, dh0, dc0) and the
    exchange with its TAIL_WORDS spare words."""
    T_, B, G = args[0].shape
    dev = args[0].device
    xch = torch.zeros(2 * B * G + TAIL_WORDS, dtype=torch.int64, device=dev)
    outs = (torch.empty_like(args[0]), torch.empty(B, G // 4, device=dev),
            torch.empty(B, G // 4, device=dev))
    _build.launch(lib, "lstm_seq_bwd_cluster", "lstm_seq_bwd", (*args, *outs, xch),
                  (T_, B, G // 4, int(bf16)))
    return outs, xch


def run_cluster(args, reps, card) -> None:
    libs = build({f"cluster_{k}": v
                  for k, v in chosen(cluster_variants(kernel_source()), args.only).items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = {B: inputs(B, dev, gen) for B in BATCHES}
    want = {bf16: fused_rnn.lstm_seq_bwd_reference(*ins[16], bf16) for bf16 in (False, True)}
    for name, (lib, report) in libs.items():
        name = name[len("cluster_"):]
        for bf16 in ((False, True) if name in ("as_built", "q16", "phase_clock") else (False,)):
            def call(B, lib=lib, bf16=bf16):
                return launch_cluster(lib, ins[B], bf16)
            got = call(16)[0]
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want[bf16]))
            note = "timing only" if name in CLUSTER_TIMING_ONLY else "checked"
            times = ", ".join(f"B={B} {(ms := cuda_ms(lambda: call(B), reps)):.4f} ms "
                              f"({ms / (T + 1) * 1e3:.2f} us per iteration)" for B in BATCHES)
            print(f"lstm_bwd cluster variant {name} {'bfloat16' if bf16 else 'float32'}: "
                  f"max_abs_err {err:.3e} at B=16 ({note}); time H={H} T={T} {times} [{card}]",
                  flush=True)
            if name == "phase_clock":
                for B in BATCHES:
                    xch = call(B)[1]
                    torch.cuda.synchronize()
                    tail = 2 * B * 4 * H
                    cyc = [v / (T + 1) for v in xch[tail:tail + len(PHASES)].tolist()]
                    print(f"lstm_bwd cluster phases B={B} {'bfloat16' if bf16 else 'float32'}"
                          f" (block 0, thread 0, clock cycles per iteration): "
                          + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, cyc))
                          + f"; total {sum(cyc):.0f} [{card}]", flush=True)
        print(f"lstm_bwd cluster variant {name}: ptxas {ptxas_report(report)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("direct", "cluster", "all"), default="all")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed shape")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated variant names to build (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if args.route in ("direct", "all"):
        run_direct(args, args.reps, card)
    if args.route in ("cluster", "all"):
        run_cluster(args, args.reps, card)


if __name__ == "__main__":
    main()
