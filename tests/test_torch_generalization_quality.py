"""The learning gate for the port: training generalizes on the learnable
corpus, and a model trained on shuffled features fails the gate (the port's
copy of tests/test_generalization_quality.py, at its shape and thresholds;
``s2vt_tpu_torch/tools/learning_gate.py`` holds both). ``slow``, as the JAX
gate is; it runs on the card when one is present, else on the CPU."""

import pytest
import torch

from s2vt_tpu_torch.tools import learning_gate as gate


@pytest.fixture(scope="module")
def device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heldout_generalization(tmp_path, device, dtype):
    info = gate.make_corpus(str(tmp_path))
    # every atom must be trainable: vocab = atoms + template words + specials
    assert info["vocab_size"] >= 20 + 12 + 12 + 3
    epoch0, final = gate.train_and_score(str(tmp_path), info["feat_path"], info,
                                         f"real_{dtype}", gate.EPOCHS, device,
                                         compute_dtype=dtype)
    assert gate.gate_failures(epoch0, final) == [], (epoch0, final)


@pytest.mark.slow
def test_failing_model_fails_the_gate(tmp_path, device):
    info = gate.make_corpus(str(tmp_path))
    shuf = gate.shuffle_features(info["feat_path"], str(tmp_path / "feats_shuffled"))
    _, final = gate.train_and_score(str(tmp_path), shuf, info, "shuffled",
                                    gate.CONTROL_EPOCHS, device)
    assert gate.control_failures(final) == [], final


def test_shuffled_features_match_the_jax_gates_swap(tmp_path):
    """The control's features: the same files under permuted names as the
    JAX gate's swap gives (its seed-1 permutation of the sorted names)."""
    import os

    import numpy as np
    info = gate.make_corpus(str(tmp_path))
    names = sorted(os.listdir(info["feat_path"]))
    perm = np.random.default_rng(1).permutation(len(names))
    shuf = gate.shuffle_features(info["feat_path"], str(tmp_path / "shuf"))
    for i in (0, 7, len(names) - 1):
        np.testing.assert_array_equal(np.load(os.path.join(shuf, names[perm[i]])),
                                      np.load(os.path.join(info["feat_path"], names[i])))
    assert sorted(os.listdir(shuf)) == names


def test_gate_thresholds():
    passing = {"METEOR": 0.39, "CIDEr": 3.1, "Bleu_1": 0.82}
    assert gate.gate_failures({"METEOR": 0.05}, passing) == []
    assert gate.gate_failures({"METEOR": 0.1}, passing) == ["epoch-0 METEOR < 0.08"]
    assert gate.gate_failures({"METEOR": 0.07}, {"METEOR": 0.26, "CIDEr": 1.0,
                                                 "Bleu_1": 0.7}) == [
        "final CIDEr > 1.2", "final METEOR > epoch-0 METEOR + 0.2"]
    assert gate.control_failures({"METEOR": 0.12, "CIDEr": 0.3}) == []
    assert gate.control_failures(passing) == ["control METEOR < 0.2", "control CIDEr < 1.0"]
    assert gate.SHAPE == dict(n_train=260, n_valid=60, n_test=24, n_subjects=20, n_verbs=12,
                              n_objects=12, feat_len=12, feat_dim=64, seed=0)
