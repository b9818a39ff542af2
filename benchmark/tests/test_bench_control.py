"""The control at a size the CPU tests hold: the reference put in the
program's place and computed in TF32, the precision below the configured
float32, comes out as not correct against each cell's own limits on three
seeds; so do, for the extraction cell, the faults its limit was set
against. (``benchmark/calibrate.py`` reads the same on the card at the
cells' own sizes.)"""

import tempfile
import types

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.loops import extract
from benchmark.tests.tiny import tiny_files

# Caption cells: the cells' widths and vocabulary, a longer decode, so that it
# holds near-ties for TF32 to flip, as the cells' own sizes do.
WIDE = {"length": 40, "dim_hidden": 512, "dim_embed": 512, "vocab_size": 10240}
# What each loop's readings put in the program's place and a run must fail.
CAUGHT = {"train": ("control",), "caption": ("control",),
          "extract": ("control", "bn_left_out", "clips_rotated")}


def _job(workload, seed, cfg=None, **traffic):
    _, tiny, tr, _ = tiny_files(workload)
    return types.SimpleNamespace(cfg=dict(tiny, **(cfg or {})), traffic=dict(tr, **traffic),
                                 seed=seed, seconds=0,
                                 trace=False, device=torch.device("cpu"),
                                 workdir=tempfile.mkdtemp(), t0=0.0, log=lambda m: None)


@pytest.mark.parametrize("workload", ["lstm.train.b16", "gru.train.b16",
                                      "lstm.caption", "gru.caption", "vgg16.extract.n80"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(workload, seed):
    _, _, traffic, limits = tiny_files(workload)
    if "train" in workload:
        out = calibrate.train_readings(_job(workload, seed), control=True)
    elif "caption" in workload:   # more served tokens, for near-ties that TF32 flips
        out = calibrate.caption_readings(_job(workload, seed, WIDE, batch=128,
                                              pool_clips=512, check_requests=2), control=True)
    else:
        out = extract.readings(_job(workload, seed), control=True)
    correct, _ = harness.checks_of(out["program"], limits)
    assert correct, out["program"]
    for name in CAUGHT[traffic["loop"]]:
        bad, _ = harness.checks_of(out[name], limits)
        assert not bad, (name, out[name])
