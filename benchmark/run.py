"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The cell, its configuration, traffic mix and limits are found by name
through ``BENCHMARK.json`` (see ``benchmark/harness.py``); the mix's
``loop`` names the driver in ``benchmark/loops/`` that sets up, measures
and judges it. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error. Without a card, or with
fewer than the cell asks for, or where JAX or the JAX package got loaded,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is timed from here, before torch is imported

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

from benchmark import harness  # noqa: E402

# Build and kernel caches, at fixed paths inside the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton", "CUDA_CACHE_PATH": "build/nv_cache"}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float = None, files: tuple = None) -> tuple:
    """Run ``workload`` once on ``device``. Returns (result, lines): the
    result object and the lines to print before it. ``files`` stands in
    for the cell's (entry, config, traffic, limits), as tests at a small
    size give them."""
    spec = harness.benchmark_spec()
    cell, cfg, traffic, limits = files or harness.cell_files(spec, workload)
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    workdir = tempfile.mkdtemp(prefix="s2vt-bench-")
    t0 = T0 if t0 is None else t0
    job = types.SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
                                trace=trace, device=device, workdir=workdir, t0=t0,
                                log=lambda msg: print(f"[{time.perf_counter() - t0:9.3f} s] {msg}",
                                                      file=sys.stderr, flush=True))
    try:
        out = loop.run(job)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    import torch
    dev = torch.device(device)
    out["ctx"]["device_type"] = dev.type
    correct, checks = harness.checks_of(out["numbers"], limits)
    lines = list(out["audit"])
    if trace:
        metrics = {}
        for m in harness.metrics_of(spec, workload, "per_layer"):
            value = harness.read_metric(m["name"], out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_of(spec, workload, "end_to_end")}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                         "count": cell["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    span = out["span"]
    if trace and span is not None:
        result["device"].update(busy_s=span.busy_s, window_s=span.window_s)
        result["breakdown"] = {"device_ops": span.top_device_ops(),
                               "idle_gaps": span.idle_gaps()}
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded at start: {bad}", file=sys.stderr)
        return 3
    spec = harness.benchmark_spec()
    cell = harness.cell_files(spec, args.workload)[0]
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(harness.ROOT / rel)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)   # the loops launch from one thread; a pool of idle ones
                               # competes with it for a shared host's cores (PERF.md)
    try:
        import s2vt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test does not import: {e}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded after the window: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
