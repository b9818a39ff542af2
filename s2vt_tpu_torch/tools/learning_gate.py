"""The learning gate: training must generalize, not memorize.

    python -m s2vt_tpu_torch.tools.learning_gate [--device cpu]

The port's copy of ``tests/test_generalization_quality.py`` (the JAX
package's gate), at its shape and with its thresholds. The learnable corpus
(``data/learnable.py``) maps (subject, verb, object) triples to features by
a fixed rule, and the valid split holds unseen triples of seen atoms, so a
model scores there only by learning the feature -> word mapping:

 - random weights (before epoch 0): METEOR < 0.08;
 - after 60 epochs: METEOR > 0.25, CIDEr > 1.2, Bleu_1 > 0.65, and METEOR
   more than 0.2 above the random weights';
 - the negative control, the same training for 30 epochs on features
   shuffled across clips (so the feature -> caption link is noise): METEOR
   < 0.2 and CIDEr < 1.0. It still learns the templates' language model.

S2VT at H = E = 96, F = 64, L = 12, B = 16, lr 3e-3, with ``use_pallas``
(the kernels on the card, their plain versions on the CPU). Runs on the card
unless ``--device cpu``; exits 1 when a threshold fails.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SHAPE = dict(n_train=260, n_valid=60, n_test=24, n_subjects=20, n_verbs=12,
             n_objects=12, feat_len=12, feat_dim=64, seed=0)
EPOCHS = 60
CONTROL_EPOCHS = 30


def make_corpus(root: str) -> dict:
    from s2vt_tpu_torch.data.learnable import make_learnable_corpus
    return make_learnable_corpus(os.path.join(root, "corpus"), **SHAPE)


def shuffle_features(feat_path: str, dest: str, seed: int = 1) -> str:
    """The control's features: clip i's file holds the features of clip
    perm[i]'s name, as the JAX gate's swap does. Returns ``dest``."""
    names = sorted(pathlib.Path(feat_path).glob("*.npy"))
    perm = np.random.default_rng(seed).permutation(len(names))
    os.makedirs(dest, exist_ok=True)
    for i, src in enumerate(names):
        shutil.copy(src, os.path.join(dest, names[perm[i]].name))
    return dest


def train_and_score(root: str, feats_path: str, info: dict, tag: str, epochs: int,
                    device=None, **kw) -> Tuple[dict, dict]:
    """Scores of the valid split with the random initial weights and after
    ``epochs`` epochs: (epoch0, final)."""
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.training import Trainer

    opt = Opt(caption_file=info["captions_file"], feats_path=feats_path,
              gts_file=info["gts_file"], train_length=12, dim_hidden=96, dim_embed=96,
              feat_dim=64, batch_size=16, eval_batch_size=16, lr=3e-3, use_pallas=True,
              save_path=os.path.join(root, f"ckpt_{tag}"),
              log_dir=os.path.join(root, f"runs_{tag}"), model="s2vt", seed=0,
              early_stopping_patience=10000, learning_rate_patience=10000,
              metric_eval_freq=0, **kw)
    tr = Trainer(opt, device=device)
    epoch0 = tr._metric_eval(-1)
    tr.fit(epochs=epochs)
    return epoch0, tr._metric_eval(epochs - 1)


def gate_failures(epoch0: dict, final: dict) -> List[str]:
    """The thresholds a trained model misses (empty: it passes)."""
    checks = [(epoch0["METEOR"] < 0.08, "epoch-0 METEOR < 0.08"),
              (final["METEOR"] > 0.25, "final METEOR > 0.25"),
              (final["CIDEr"] > 1.2, "final CIDEr > 1.2"),
              (final["Bleu_1"] > 0.65, "final Bleu_1 > 0.65"),
              (final["METEOR"] > epoch0["METEOR"] + 0.2, "final METEOR > epoch-0 METEOR + 0.2")]
    return [what for ok, what in checks if not ok]


def control_failures(final: dict) -> List[str]:
    """The thresholds the shuffled-feature control misses (empty: it fails
    the gate, as it must)."""
    checks = [(final["METEOR"] < 0.2, "control METEOR < 0.2"),
              (final["CIDEr"] < 1.0, "control CIDEr < 1.0")]
    return [what for ok, what in checks if not ok]


def run(root: str, device=None, dtypes: Sequence[str] = ("float32", "bfloat16"),
        log=print) -> Dict[str, dict]:
    """The gate in each dtype and the control (float32); returns
    {run: {"epoch0", "final", "failures"}}. A run passes when its failures
    are empty."""
    info = make_corpus(root)
    out: Dict[str, dict] = {}
    for dtype in dtypes:
        epoch0, final = train_and_score(root, info["feat_path"], info, f"real_{dtype}",
                                        EPOCHS, device, compute_dtype=dtype)
        out[dtype] = {"epoch0": epoch0, "final": final, "failures": gate_failures(epoch0, final)}
        log(f"learning gate {dtype}: {json.dumps(out[dtype])}")
    shuf = shuffle_features(info["feat_path"], os.path.join(root, "feats_shuffled"))
    _, final = train_and_score(root, shuf, info, "shuffled", CONTROL_EPOCHS, device)
    out["control"] = {"final": final, "failures": control_failures(final)}
    log(f"learning gate control: {json.dumps(out['control'])}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        out = run(root, args.device)
    return 1 if any(r["failures"] for r in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
