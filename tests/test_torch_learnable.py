"""The port's learnable corpus (``s2vt_tpu_torch/data/learnable.py``) against
s2vt_tpu's: for one seed and shape both write the same captions.json,
gts.json and feature files; and the structure the learning gate relies on."""

import json
import os

import numpy as np
import pytest

from s2vt_tpu_torch.data.dataset import VideoDataset
from s2vt_tpu_torch.data.learnable import make_learnable_corpus

pytest.importorskip("flax", reason="the JAX reference package needs flax")

from s2vt_tpu.data.learnable import make_learnable_corpus as j_make_learnable  # noqa: E402

SHAPES = {
    "tiny": dict(n_train=40, n_valid=10, n_test=5, n_subjects=8, n_verbs=5, n_objects=5,
                 feat_len=9, feat_dim=16, seed=3),
    "gate": dict(n_train=260, n_valid=60, n_test=24, n_subjects=20, n_verbs=12, n_objects=12,
                 feat_len=12, feat_dim=64, seed=0),
    "odd": dict(n_train=30, n_valid=7, n_test=3, n_subjects=6, n_verbs=6, n_objects=4,
                feat_len=5, feat_dim=10, seed=11, noise=0.3, pattern_scale=2.0,
                max_captions_per_clip=3),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_corpus_is_identical_to_jax(tmp_path, shape):
    want = j_make_learnable(str(tmp_path / "jax"), **SHAPES[shape])
    got = make_learnable_corpus(str(tmp_path / "port"), **SHAPES[shape])
    strip = lambda meta: {k: v for k, v in meta.items() if "file" not in k and "path" not in k}
    assert strip(got) == strip(want)
    for name in ("captions.json", "gts.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()))
    names = sorted(os.listdir(tmp_path / "jax" / "feats"))
    assert names == sorted(os.listdir(tmp_path / "port" / "feats"))
    assert len(names) == sum(SHAPES[shape][k] for k in ("n_train", "n_valid", "n_test"))
    for f in names:
        a = np.load(tmp_path / "port" / "feats" / f)
        b = np.load(tmp_path / "jax" / "feats" / f)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_corpus_rejects_what_jax_rejects(tmp_path):
    for kw in (dict(n_train=10, n_valid=5, n_test=5, n_subjects=2, n_verbs=2, n_objects=2),
               dict(n_train=3, n_valid=1, n_test=1, n_subjects=4, n_verbs=4, n_objects=4)):
        with pytest.raises(ValueError) as jerr:
            j_make_learnable(str(tmp_path / "j"), feat_len=2, feat_dim=6, **kw)
        with pytest.raises(ValueError) as perr:
            make_learnable_corpus(str(tmp_path / "p"), feat_len=2, feat_dim=6, **kw)
        assert str(perr.value) == str(jerr.value)


def test_learnable_corpus_structure(tmp_path):
    """Distinct triples, every atom in train, held-out triples unseen, and
    artifacts that VideoDataset reads (the port's copy of
    tests/test_generalization_quality.py::test_learnable_corpus_structure)."""
    info = make_learnable_corpus(str(tmp_path / "c"), **SHAPES["tiny"])
    data = json.load(open(info["captions_file"]))
    splits = data["splits"]
    assert len(splits["train"]) == 40 and len(splits["valid"]) == 10

    gts = json.load(open(info["gts_file"]))["gts"]

    def triple(vid):
        words = gts[vid][0]["caption"].split()
        return tuple(next(w for w in words if w.startswith(p)) for p in ("subj", "verb", "obj"))

    all_triples = {vid: triple(vid) for vid in gts}
    assert len(set(all_triples.values())) == len(all_triples), "dup triples"
    train_triples = {all_triples[v] for v in splits["train"]}
    train_atoms = set().union(*train_triples)
    assert len([a for a in train_atoms if a.startswith("subj")]) == 8
    assert len([a for a in train_atoms if a.startswith("verb")]) == 5
    for v in splits["valid"] + splits["test"]:
        assert all_triples[v] not in train_triples, "held-out triple seen"
        assert set(all_triples[v]) <= train_atoms, "held-out atom unseen"

    ds = VideoDataset(info["captions_file"], info["feat_path"], max_len=9, mode="valid")
    b = next(ds.batches(5))
    assert b.feats.shape == (5, 9, 16)
