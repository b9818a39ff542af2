"""The readings each cell's limits are set from, on the card at the cell's
own size (the benchmark's runs never run this):

    python3 -m benchmark.calibrate --workload <cell> --seeds 101 102 ... [--control 3]

For every seed it prints one JSON line: the program's numbers, as a run of
the cell compares them. For the first ``--control`` seeds the line also
holds the control's numbers (the reference in TF32 put in the program's
place) and, for a training cell, those of the fault that leaves half of
each batch out and takes the mean over the rest (planted in the reference
put in the program's place), or for an extraction cell those of the
reference with one conv's BatchNorm left out in the program's place and
of the served clips rotated by one. A state left unchanged reads 1 by the
measure of ``benchmark/compare.py`` and needs no run. A training cell runs
its loop with a window of one epoch; a caption or extraction cell serves
``check_requests`` requests and judges them all.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
import types

import torch

from benchmark import harness
from benchmark.loops import caption, extract, train

FAULTS = {"control": {"precision": "tf32"}, "half_batch": {"half_batch": True}}


def train_readings(job, control: bool) -> dict:
    job.faults = list(FAULTS.values()) if control else []
    out = train.run(job)
    return {"program": out["numbers"], **dict(zip(FAULTS, out["faults"]))}


def caption_readings(job, control: bool) -> dict:
    model = caption.build_model(job)
    pool = caption.make_pool(job)
    served = []
    for i in range(job.traffic["check_requests"]):
        idx = torch.from_numpy(caption.request_rows(job, i)).to(job.device, torch.long)
        served.append((i, model.greedy(pool[idx]).cpu().numpy()))
    del model, pool
    out = {"program": {"logit_gap": caption.check_gap(job, served)}}
    if control:
        out["control"] = {"logit_gap": caption.check_gap(job, served, control="tf32")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.benchmark_spec()
    cell, cfg, traffic, _ = harness.cell_files(spec, args.workload)
    readings = {"train": train_readings, "caption": caption_readings,
                "extract": extract.readings}[traffic["loop"]]
    workdir = tempfile.mkdtemp(prefix="s2vt-calibrate-")
    try:
        for k, seed in enumerate(args.seeds):
            t = time.perf_counter()
            job = types.SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, seconds=0,
                                        trace=False, device=torch.device(args.device),
                                        workdir=workdir, t0=t, log=lambda msg: None)
            out = readings(job, k < args.control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "seconds": time.perf_counter() - t, **out}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
