"""The port's scoring slice against s2vt_tpu's, on the CPU: the scorer,
``COCOEvalCap``, ``msr_vtt_to_coco_gts``, ``cli/eval.py`` (greedy and beam)
on a checkpoint both packages load, the Trainer's in-training metric eval
(``history["metrics"]``, with and without the feature bank) and a decode
from the feature bank against a streamed one."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.cli import eval as eval_cli
from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset
from s2vt_tpu_torch.data.learnable import make_learnable_corpus
from s2vt_tpu_torch.evaluation import (COCOEvalCap, COCOScorer, CaptionDecoder,
                                       model_from_checkpoint, msr_vtt_to_coco_gts,
                                       score_predictions)
from s2vt_tpu_torch.training import Trainer
from s2vt_tpu_torch.training.checkpoint import load_checkpoint
from s2vt_tpu_torch.utils.weights import params_from_jax

pytest.importorskip("flax", reason="the JAX reference package needs flax")

from s2vt_tpu import evaluation as jevaluation  # noqa: E402

L, F, H, B = 9, 16, 32, 8
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")
SCORE_TOL = 1e-9


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small learnable corpus: 40 train clips (5 batches of 8), 10 valid, 6 test."""
    root = tmp_path_factory.mktemp("corpus")
    return make_learnable_corpus(str(root), n_train=40, n_valid=10, n_test=6, n_subjects=8,
                                 n_verbs=5, n_objects=5, feat_len=L, feat_dim=F, seed=3)


def small_opt(corpus, save_path, **kw):
    base = dict(caption_file=corpus["captions_file"], feats_path=corpus["feat_path"],
                gts_file=corpus["gts_file"], train_length=L, dim_hidden=H, dim_embed=H,
                feat_dim=F, batch_size=B, eval_batch_size=4, vocab_pad_multiple=8, lr=3e-3,
                save_freq=100, seed=0, save_path=str(save_path),
                log_dir=str(save_path) + "_runs")
    base.update(kw)
    return Opt(**base)


@pytest.fixture(scope="module")
def checkpoint(corpus, tmp_path_factory):
    """A port checkpoint after 3 epochs, also written as the JAX package
    writes one (orbax), so that both packages load the same directory."""
    from s2vt_tpu.training.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("trained")
    tr = Trainer(small_opt(corpus, root / "ckpt"), device="cpu")
    tr.fit(epochs=3)
    final = os.path.join(tr.opt.save_path, tr.opt.start_time + "final")
    both = root / "both"
    with open(os.path.join(final, "opt.json"), encoding="utf-8") as f:
        save_checkpoint(str(both), {"params": load_checkpoint(final)}, config_json=f.read())
    shutil.copy(os.path.join(final, "params.npz"), both / "params.npz")
    return str(both)


@pytest.fixture(scope="module")
def gts(corpus):
    with open(corpus["gts_file"], encoding="utf-8") as f:
        return json.load(f)["gts"]


def _prediction_sets(corpus, gts):
    """{vid: caption} sets: each clip's first reference, a shuffled one, and
    seeded random word strings (some clips missing, one unknown clip)."""
    rng = np.random.default_rng(5)
    vids = sorted(gts)
    words = sorted({w for refs in gts.values() for r in refs for w in r["caption"].split()})
    first = {v: gts[v][0]["caption"] for v in vids}
    shuffled = dict(zip(vids, rng.permutation([first[v] for v in vids])))
    noisy = {v: " ".join(rng.choice(words, rng.integers(1, 9))) + rng.choice(["", ".", " !"])
             for v in vids if rng.random() < 0.8}
    noisy["not_a_clip"] = "a subj0 is verb0 a obj0"
    return {"first": first, "shuffled": shuffled, "noisy": noisy}


@pytest.mark.parametrize("which", ["first", "shuffled", "noisy"])
def test_score_predictions_and_scorer_match_jax(corpus, gts, which):
    preds = _prediction_sets(corpus, gts)[which]
    got = score_predictions(preds, gts, verbose=False)
    want = jevaluation.score_predictions(preds, gts, verbose=False)
    assert list(got) == list(want) == list(METRICS)
    np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS],
                               rtol=0, atol=1e-12)
    samples, ids = jevaluation.pred_to_coco_samples_IDs(preds, gts)
    ours, theirs = COCOScorer(verbose=False), jevaluation.COCOScorer(verbose=False)
    ours.score(gts, samples, ids)
    theirs.score(gts, samples, ids)
    assert sorted(ours.imgToEval) == sorted(theirs.imgToEval) == sorted(ids)
    for vid in ids:
        for k in METRICS:
            assert abs(ours.imgToEval[vid][k] - theirs.imgToEval[vid][k]) <= 1e-12, (vid, k)


def test_coco_eval_cap_matches_jax(corpus, gts):
    preds = _prediction_sets(corpus, gts)["noisy"]
    res = {v: [{"caption": c}] for v, c in preds.items()}
    ours, theirs = COCOEvalCap(gts, res), jevaluation.COCOEvalCap(gts, res)
    got, want = ours.evaluate(), theirs.evaluate()
    assert ours.params == theirs.params and list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS],
                               rtol=0, atol=1e-12)
    assert [e["image_id"] for e in ours.evalImgs] == [e["image_id"] for e in theirs.evalImgs]
    for a, b in zip(ours.evalImgs, theirs.evalImgs):
        np.testing.assert_allclose([a[k] for k in METRICS], [b[k] for k in METRICS],
                                   rtol=0, atol=1e-12)


def test_msr_vtt_to_coco_gts_matches_jax(tmp_path):
    """A seeded MSR-VTT-shaped videodatainfo json, sentences interleaved
    across videos."""
    from s2vt_tpu.evaluation.scorer import msr_vtt_to_coco_gts as j_msr_vtt
    rng = np.random.default_rng(9)
    words = ["A", "man", "is", "Playing", "guitar.", "dog,", "runs!", "on;", "the", "road?",
             "cat:", "sits"]
    info = {"videos": [{"video_id": f"video{i}", "id": i} for i in range(7)],
            "sentences": [{"video_id": f"video{int(rng.integers(7))}", "sen_id": s,
                           "caption": " ".join(rng.choice(words, rng.integers(2, 9)))}
                          for s in range(40)]}
    path = tmp_path / "videodatainfo.json"
    path.write_text(json.dumps(info))
    got = msr_vtt_to_coco_gts(str(path))
    assert got == j_msr_vtt(str(path)) and sum(map(len, got.values())) == 40


def _jax_cli_lines(monkeypatch, capsys, argv):
    from s2vt_tpu.cli import eval as j_eval_cli
    monkeypatch.setenv("S2VT_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr("sys.argv", ["eval"] + argv)
    capsys.readouterr()
    j_eval_cli.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_eval_cli_matches_jax_cli(corpus, checkpoint, tmp_path, monkeypatch, capsys, beam):
    args = ["--model_path", checkpoint, "--gts_file", corpus["gts_file"], "--batch_size", "4"]
    if beam:
        args += ["--beam", "--beam_width", "2", "--max_beam_depth", "8"]
    capsys.readouterr()
    scores = eval_cli.main(args + ["--device", "cpu",
                                   "--dump_predictions", str(tmp_path / "port.json")])
    got = capsys.readouterr().out.splitlines()
    want = _jax_cli_lines(monkeypatch, capsys,
                          args + ["--dump_predictions", str(tmp_path / "jax.json")])
    assert got == want and [ln.split(":")[0] for ln in got] == list(METRICS)
    preds = json.loads((tmp_path / "port.json").read_text())
    assert preds == json.loads((tmp_path / "jax.json").read_text()) and len(preds) == 6
    assert any(preds.values())
    assert got == [f"{k}: {v:.4f}" for k, v in scores.items()]


def test_eval_cli_wants_the_card_unless_told(corpus, checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.main(["--model_path", checkpoint, "--gts_file", corpus["gts_file"]])


@pytest.fixture(scope="module")
def jax_training():
    import importlib
    return tuple(importlib.import_module(n) for n in ("jax", "s2vt_tpu.training",
                                                      "s2vt_tpu.config", "s2vt_tpu.parallel"))


@pytest.mark.parametrize("bank", ["on", "off"])
def test_trainer_metrics_match_jax_trainer(corpus, tmp_path, jax_training, bank):
    """metric_eval_freq=1 for 2 epochs from the JAX Trainer's initial
    weights: history["metrics"] has the JAX Trainer's epochs and scores
    (within 1e-9: the greedy tokens are the same)."""
    jax, jtraining, jconfig, jparallel = jax_training
    opt = small_opt(corpus, tmp_path / "port", metric_eval_freq=1, device_feature_bank=bank,
                    learning_rate_patience=100, async_checkpoint=False)
    jopt = jconfig.Opt(**json.loads(small_opt(
        corpus, tmp_path / "jax", metric_eval_freq=1, device_feature_bank=bank,
        learning_rate_patience=100, async_checkpoint=False).to_json()))
    jtr = jtraining.Trainer(jopt, mesh=jparallel.make_mesh((1, 1)), writer=None)
    init = jax.device_get(jtr.params)
    want = jtr.fit(epochs=2)["metrics"]

    tr = Trainer(opt, device="cpu")
    assert tr.use_feature_bank == (bank == "on") == jtr.use_feature_bank
    tr.model.load_state_dict(params_from_jax(init))
    got = tr.fit(epochs=2)["metrics"]
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [0, 1]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["epoch", *METRICS]
        np.testing.assert_allclose([g[k] for k in METRICS], [w[k] for k in METRICS],
                                   rtol=0, atol=SCORE_TOL)
    assert len(tr.metric_eval_ms) == 2 and all(t["decode"] > 0 and t["score"] > 0
                                                for t in tr.metric_eval_ms)
    assert (tr._metric_decoder.bank is not None) == (bank == "on")


def test_metric_eval_every_n_epochs_and_without_gts(corpus, tmp_path):
    tr = Trainer(small_opt(corpus, tmp_path / "a", metric_eval_freq=2), device="cpu")
    assert [m["epoch"] for m in tr.fit(epochs=4)["metrics"]] == [1, 3]
    missing = Trainer(small_opt(corpus, tmp_path / "b", metric_eval_freq=1,
                                gts_file=str(tmp_path / "none.json")), device="cpu")
    assert missing._metric_eval(0) is None
    assert "metrics" not in missing.fit(epochs=1)


def test_feature_bank_decoding_matches_streaming(corpus, checkpoint):
    """CaptionDecoder(feature_bank=...) gathers rows on the device instead of
    reading each batch's features, and decodes the same captions, greedy and
    beam (the port's copy of
    tests/test_evaluation.py::test_feature_bank_decoding_matches_streaming)."""
    ds = VideoDataset(corpus["captions_file"], corpus["feat_path"], max_len=L, mode="test",
                      seed=0)
    _, model = model_from_checkpoint(checkpoint, ds.vocab_size, device="cpu")
    bank = torch.from_numpy(ds.load_all_features())
    plain = CaptionDecoder(model, ds, "cpu", beam_width=2, max_beam_depth=8)
    banked = CaptionDecoder(model, ds, "cpu", beam_width=2, max_beam_depth=8,
                            feature_bank=bank)
    assert banked.greedy(batch_size=4) == plain.greedy(batch_size=4)
    assert banked.beam(batch_size=4) == plain.beam(batch_size=4)
    assert len(plain.greedy(batch_size=4)) == 6
