"""What every loop shares: the cell's files found by name, the import guard,
the per-layer readers, the launch audit and the correctness checks.

Files (all under ``benchmark/``, found by the names in ``BENCHMARK.json``):

- ``configs/<config>.json``: the model's sizes and training settings.
- ``traffic/<traffic>.json``: the mix's parameters; ``loop`` names the
  driver in ``loops/`` that runs it.
- ``limits/<workload>.json``: the limit of each number the cell compares.
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(ctx)``,
  which returns the value or None where the run has nothing to read.
- ``kernels/<op>.json``: one kernel of the program: its launch counter
  (``module:function``, whose ``launches`` the program adds to) and the
  substrings of its device symbols.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
from typing import Dict, List, Optional, Sequence

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that may not be loaded: JAX and the JAX package the
# program was ported from. Compared whole: ``s2vt_tpu_torch`` is not
# ``s2vt_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "s2vt_tpu")


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@contextlib.contextmanager
def quiet_host():
    """No garbage collection inside the block: what set-up made is frozen
    out of the collector's reach and collection is off, then both undone."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(spec: dict, workload: str) -> tuple:
    """(workload entry, config, traffic, limits) of one cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def metrics_of(spec: dict, workload: str, section: str) -> List[dict]:
    """The entries of ``section`` ('end_to_end' or 'per_layer') that this
    cell reports."""
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The value ``metrics/<name>.py`` reads from ``ctx``, or None."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def kernels() -> Dict[str, dict]:
    """op -> {"counter": "module:function", "symbols": [...]}."""
    return {p.stem: load_json(p) for p in sorted((HERE / "kernels").glob("*.json"))}


def kernel(op: str) -> dict:
    return load_json(HERE / "kernels" / f"{op}.json")


def _counter(entry: dict):
    module, fn = entry["counter"].split(":")
    return getattr(importlib.import_module(module), fn)


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches so far, by the program's own counter."""
    return {op: int(_counter(e).launches) for op, e in kernels().items()}


def audit_lines(before: Dict[str, int], after: Dict[str, int], span) -> List[str]:
    """One line per kernel that ran in the traced span: its launches by the
    program's counter beside the records the profiler kept."""
    lines = []
    for op, entry in kernels().items():
        launched = after[op] - before[op]
        kept, _ = span.kernel_stats(entry["symbols"])
        if launched or kept:
            route = dict(getattr(_counter(entry), "route_launches", {}))
            lines.append(f"audit {op}: launches by counter {launched}, records kept {kept}, "
                         f"routes so far {route}")
    return lines


def roofline(ctx: dict, loop: str, op: str, work) -> Optional[float]:
    """The share (%) of kernel ``op``'s roofline in a traced run of ``loop``:
    the least time of one call (``work``, a ``yardstick.Work`` at the cell's
    shapes) over the mean device time of a call the profiler recorded, so
    that a record it drops leaves the share as it is. None where the run
    recorded no call of ``op``."""
    span = ctx["span"]
    if ctx["loop"] != loop or span is None or ctx["device_type"] != "cuda":
        return None
    calls, seconds = span.kernel_stats(kernel(op)["symbols"])
    if not calls:
        return None
    return 100.0 * work.bound_s(ctx["cfg"]["dtype"]) / (seconds / calls)


def device_idle(ctx: dict, loop: str) -> Optional[float]:
    """The share (%) of the untraced window in which the card had nothing to
    do in a traced run of ``loop``: one less the card's busy time per unit
    of work (a step or a request) in the traced span, as the union of its
    intervals, over the window's seconds per unit. The profiler slows the
    host in the traced span, not the card's own times, so the share is the
    untraced window's."""
    span = ctx["span"]
    if (ctx["loop"] != loop or span is None or ctx["device_type"] != "cuda" or not span.device
            or not ctx["span_units"] or not ctx["window_units"]):
        return None
    busy = span.busy_s / ctx["span_units"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / ctx["window_units"]))


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number against its limit;
    a number that is not finite, or has no limit, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), out
