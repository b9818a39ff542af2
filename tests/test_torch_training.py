"""The port's training slice against s2vt_tpu's, on the CPU.

Losses, callbacks and the Trainer are held to the JAX package on the same
corpus (``make_synthetic_corpus`` writes the same bytes in both packages) and
the same initial weights, carried across by ``utils/weights.py``. Sizes as in
tests/test_pallas_s2vt.py (B=8, H=E=128, F=16, L=6, V=32), so that the JAX
fused route engages (Pallas in interpret mode). Per-epoch losses and the lr
history agree within rtol 1e-4: both sides run float32 with dropout 0, and
only the order of float32 sums differs.

The JAX side is imported by fixtures, so that the card test also collects
where the JAX package cannot be imported.
"""

import importlib
import json
import os
import signal

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
from s2vt_tpu_torch.ops import fused_s2vt, losses
from s2vt_tpu_torch.training import EarlyStopping, ReduceLROnPlateau, Trainer, batch_loss
from s2vt_tpu_torch.training.loop import _dropout_seed
from s2vt_tpu_torch.utils.weights import params_from_jax

B, L, F, H, V = 8, 6, 16, 128, 32
RTOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """32 clips: 16 train (two batches of 8), 8 valid; 24 words padded to 32."""
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(str(root), n_videos=32, vocab_extra=20, feat_len=L,
                                 feat_dim=F, seed=5)


def small_opt(corpus, tmp_path, **kw):
    base = dict(caption_file=corpus["captions_file"], feats_path=corpus["feat_path"],
                gts_file=corpus["gts_file"], train_length=L, dim_hidden=H, dim_embed=H,
                feat_dim=F, batch_size=B, vocab_pad_multiple=V, lr=1e-3, EPOCHS=3,
                save_freq=100, learning_rate_patience=0, seed=0,
                save_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"))
    base.update(kw)
    return Opt(**base)


def port_trainer(corpus, tmp_path, **kw) -> Trainer:
    return Trainer(small_opt(corpus, tmp_path, **kw), device="cpu")


@pytest.fixture(scope="module")
def jax_training():
    """(jax, jax.numpy, s2vt_tpu.training, s2vt_tpu.ops.losses, s2vt_tpu.config,
    s2vt_tpu.parallel)."""
    names = ("jax", "jax.numpy", "s2vt_tpu.training", "s2vt_tpu.ops.losses",
             "s2vt_tpu.config", "s2vt_tpu.parallel")
    return tuple(importlib.import_module(n) for n in names)


def _logits_and_labels(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(B, L - 1, V))).astype(np.float32)
    labels = rng.integers(0, V, size=(B, L)).astype(np.int32)
    mask = (np.arange(L)[None, :] < rng.integers(2, L + 1, size=(B, 1))).astype(np.float32)
    valid = np.array([1.0] * 6 + [0.0] * 2, np.float32)
    return logits, labels, mask, valid


@pytest.mark.parametrize("masked", [True, False])
def test_batch_loss_matches_jax(jax_training, masked):
    jax, jnp, jtraining, *_ = jax_training
    logits, labels, mask, valid = _logits_and_labels(0)
    want = jtraining.loop.batch_loss(*map(jnp.asarray, (logits, labels, mask, valid)),
                                     masked=masked)
    got = batch_loss(*map(torch.from_numpy, (logits, labels, mask, valid)), masked=masked)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["_token_nll", "masked_cross_entropy",
                                  "reference_mean_cross_entropy"])
def test_losses_match_jax(jax_training, name):
    _, jnp, _, jlosses, *_ = jax_training
    logits, labels, mask, _ = _logits_and_labels(1)
    if name == "_token_nll":
        args = (logits, labels[:, 1:])
    else:
        args = (logits, labels, mask)
    want = np.asarray(getattr(jlosses, name)(*map(jnp.asarray, args)))
    got = getattr(losses, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_callbacks_match_jax(jax_training):
    """Plateau and early stopping fed one sequence of validation losses give
    the same lr, stop decision, saves and state as the JAX callbacks."""
    _, _, jtraining, *_ = jax_training
    seq = [1.0, 0.9, 0.9, 0.95, 0.8999, 0.85, 0.86, 0.86, 0.86, 0.5, 0.6, 0.6]
    saves = {"port": 0, "jax": 0}
    ours = (ReduceLROnPlateau(0.1, patience=1),
            EarlyStopping(patience=3, save_fn=lambda: saves.__setitem__("port", saves["port"] + 1)))
    theirs = (jtraining.ReduceLROnPlateau(0.1, patience=1),
              jtraining.EarlyStopping(patience=3, save_fn=lambda: saves.__setitem__(
                  "jax", saves["jax"] + 1)))
    for loss in seq:
        assert ours[0].step(loss) == theirs[0].step(loss)
        assert ours[1](loss) == theirs[1](loss)
        assert ours[0].state_dict() == theirs[0].state_dict()
        assert ours[1].state_dict() == theirs[1].state_dict()
    assert saves["port"] == saves["jax"] > 0
    restored = ReduceLROnPlateau(1.0)
    restored.load_state_dict(theirs[0].state_dict())
    assert restored.state_dict() == theirs[0].state_dict()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("route", ["scan", "fused", "per_layer", "gru"])
def test_trainer_follows_jax_trainer(jax_training, corpus, tmp_path, route, masked):
    """Three epochs from the JAX Trainer's initial weights: per-epoch train
    and valid losses and the lr history within rtol 1e-4. ``per_layer`` is a
    2-layer S2VT with use_pallas: the fused kernels refuse it, so each layer
    runs through the sequence op (the Pallas kernels of pallas_rnn.py on the
    JAX side). ``gru`` is a GRU S2VT with use_pallas: both RNNs run through
    the GRU sequence op (pallas_gru.py on the JAX side)."""
    jax, _, jtraining, _, jconfig, jparallel = jax_training
    kw = dict(use_pallas=route != "scan", masked_loss=masked, async_checkpoint=False,
              num_layers=2 if route == "per_layer" else 1,
              rnn_type="gru" if route == "gru" else "lstm")
    jopt = jconfig.Opt(**json.loads(small_opt(corpus, tmp_path / "jax", **kw).to_json()))
    jtr = jtraining.Trainer(jopt.replace(mesh_shape=(1, 1)),
                            mesh=jparallel.make_mesh((1, 1)), writer=None)
    init = jax.device_get(jtr.params)
    want = jtr.fit(epochs=3)

    tr = port_trainer(corpus, tmp_path / "port", **kw)
    tr.model.load_state_dict(params_from_jax(init))
    got = tr.fit(epochs=3)
    assert tr.model._fused_ok() == (route == "fused")
    for key in ("train_loss", "valid_loss", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert got["train_loss"][-1] < got["train_loss"][0]


def test_feature_bank_matches_streaming(corpus, tmp_path):
    bank = port_trainer(corpus, tmp_path / "a", device_feature_bank="on")
    stream = port_trainer(corpus, tmp_path / "b", device_feature_bank="off")
    assert bank.use_feature_bank and not stream.use_feature_bank
    assert tuple(bank._bank["train"].shape) == (16, L, F)
    np.testing.assert_array_equal(bank.fit(epochs=2)["train_loss"],
                                  stream.fit(epochs=2)["train_loss"])
    np.testing.assert_array_equal(bank.history["valid_loss"], stream.history["valid_loss"])


def test_feature_bank_auto_follows_budget(corpus, tmp_path):
    assert port_trainer(corpus, tmp_path, device_feature_bank="auto").use_feature_bank
    assert not port_trainer(corpus, tmp_path, device_feature_bank="auto",
                            feature_bank_max_bytes=100).use_feature_bank
    bf16 = port_trainer(corpus, tmp_path, device_feature_bank="on", compute_dtype="bfloat16")
    assert bf16._bank["valid"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bank_dtype"):
        port_trainer(corpus, tmp_path, bank_dtype="fp16")


def test_batches_without_features_sample_the_same_labels(corpus):
    ds = VideoDataset(corpus["captions_file"], corpus["feat_path"], max_len=L, seed=3)
    bank = ds.load_all_features()
    assert bank.shape == (len(ds), L, F) and ds.nbytes() == bank.nbytes
    with_f = list(ds.batches(5, epoch=2))
    without = list(ds.batches(5, epoch=2, include_feats=False))
    assert len(with_f) == len(without) == 4
    for a, b in zip(with_f, without):
        assert b.feats is None
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.feats[a.valid > 0], bank[a.rows[a.valid > 0]])
    assert len(list(ds.batches(5, epoch=2, drop_last=True))) == 3


def test_resume_continues_an_uninterrupted_run(corpus, tmp_path):
    """Two epochs, save, restore into a fresh Trainer (through
    Opt.resume_path) and two more epochs: the same losses and lr as four
    epochs in one run. The resumed run continues the epoch count, so it draws
    the same shuffles."""
    full = port_trainer(corpus, tmp_path / "full", use_pallas=True).fit(epochs=4)
    first = port_trainer(corpus, tmp_path / "part", use_pallas=True)
    first.fit(epochs=2)
    path = first.save("mid")
    assert sorted(os.listdir(path)) == ["opt.json", "optimizer.npz", "params.npz",
                                       "trainer.json"]
    second = port_trainer(corpus, tmp_path / "resumed", use_pallas=True, resume_path=path)
    rest = second.fit(epochs=4)
    assert second.epochs_done == 4
    for key in ("train_loss", "valid_loss", "lr"):
        np.testing.assert_allclose(rest[key], full[key][2:], rtol=1e-6, err_msg=key)
    assert second.optimizer.state[next(second.model.parameters())]["step"] == 8


def test_save_tags_and_restore_round_trip(corpus, tmp_path):
    tr = port_trainer(corpus, tmp_path, save_freq=1)
    tr.fit(epochs=2)
    names = os.listdir(tmp_path / "ckpt")
    stamp = tr.opt.start_time
    assert {stamp + t for t in ("0", "1", "stop", "final", "opt.json")} <= set(names)
    fresh = port_trainer(corpus, tmp_path / "other")
    before = fresh.valid_epoch(0)
    fresh.restore(os.path.join(tmp_path / "ckpt", stamp + "final"))
    assert fresh.valid_epoch(0) == tr.valid_epoch(0) != before
    assert fresh.plateau.state_dict() == tr.plateau.state_dict()
    assert fresh.early.state_dict() == tr.early.state_dict()
    assert fresh.optimizer.param_groups[0]["lr"] == tr.optimizer.param_groups[0]["lr"]


def test_sigterm_stops_after_the_epoch_and_resumes(corpus, tmp_path):
    """SIGTERM during epoch 1 ends the run after that epoch with the 'final'
    checkpoint; resuming from it gives the uninterrupted run's later epochs."""
    full = port_trainer(corpus, tmp_path / "full").fit(epochs=4)

    def kill_at_1(trainer, epoch):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    tr = port_trainer(corpus, tmp_path / "cut")
    got = tr.fit(epochs=4, on_epoch_end=kill_at_1)
    assert len(got["train_loss"]) == 2 and signal.getsignal(signal.SIGTERM) is before
    final = os.path.join(tmp_path / "cut" / "ckpt", tr.opt.start_time + "final")
    rest = port_trainer(corpus, tmp_path / "resumed", resume_path=final).fit(epochs=4)
    np.testing.assert_allclose(rest["train_loss"], full["train_loss"][2:], rtol=1e-6)


@pytest.mark.parametrize("field, value", [
    ("metric_eval_freq", 1), ("glove_path", "glove.txt"), ("profile", True),
    ("mesh_shape", (2, 1))])
def test_unported_options_raise(corpus, tmp_path, field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        port_trainer(corpus, tmp_path, **{field: value})


def test_trainer_checks_feature_shape(corpus, tmp_path):
    with pytest.raises(ValueError, match="train_length"):
        port_trainer(corpus, tmp_path, train_length=L + 1)
    with pytest.raises(ValueError, match="feat_dim"):
        port_trainer(corpus, tmp_path, feat_dim=F + 1)


def test_trainer_reads_special_tokens_and_pads_vocab(corpus, tmp_path):
    tr = port_trainer(corpus, tmp_path, sos_ix=9, eos_ix=9)
    ds = tr.train_ds
    assert (tr.opt.sos_ix, tr.opt.eos_ix) == (ds.specials["sos_ix"], ds.specials["eos_ix"])
    assert tr.vocab_size == V and tr.model.valid_vocab == ds.vocab_size < V


def test_weight_decay_is_passed_to_adamw(corpus, tmp_path):
    """Opt.weight_decay reaches AdamW (torch's own default is 0.01)."""
    assert port_trainer(corpus, tmp_path).optimizer.param_groups[0]["weight_decay"] == 0.0
    a = port_trainer(corpus, tmp_path / "a").fit(epochs=1)
    b = port_trainer(corpus, tmp_path / "b", weight_decay=10.0).fit(epochs=1)
    assert abs(a["valid_loss"][0] - b["valid_loss"][0]) > 1e-6


def test_dropout_is_seeded_by_seed_epoch_and_step(corpus, tmp_path):
    """Dropout masks come from (seed, epoch, step): two runs with dropout on
    agree exactly, and differ from the run without dropout."""
    runs = [port_trainer(corpus, tmp_path / str(i), feat_dropout=rate, out_dropout=rate)
            .fit(epochs=1)["train_loss"] for i, rate in enumerate((0.5, 0.5, 0.0))]
    assert runs[0] == runs[1] != runs[2]
    seeds = {_dropout_seed(s, e, i) for s in range(2) for e in range(3) for i in range(3)}
    assert len(seeds) == 18 and all(0 <= x < 2 ** 63 for x in seeds)


def test_cli_train_on_cpu(corpus, tmp_path, capsys):
    from s2vt_tpu_torch.cli.train import main
    from s2vt_tpu_torch.evaluation.decode import greedy_eval
    cfg = tmp_path / "opt.json"
    cfg.write_text(small_opt(corpus, tmp_path, dim_hidden=16, dim_embed=16).to_json())
    tr = main(["--config", str(cfg), "--device", "cpu", "--EPOCHS", "2", "--use_pallas",
               "true", "--lr", "0.01"])
    assert tr.opt.use_pallas and tr.opt.dim_hidden == 16 and tr.device.type == "cpu"
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "finished after 2 epochs" in out
    final = os.path.join(tr.opt.save_path, tr.opt.start_time + "final")
    preds = greedy_eval(final, batch_size=B, device="cpu")
    assert preds and all(isinstance(s, str) for s in preds.values())


def test_cli_train_gru_on_cpu(corpus, tmp_path, monkeypatch):
    """cli.train --rnn_type gru with use_pallas: every train and validation
    step runs both RNNs through the GRU sequence op (its plain versions on
    the CPU), and the final checkpoint decodes through greedy_eval and
    beam_eval."""
    from s2vt_tpu_torch.cli.train import main
    from s2vt_tpu_torch.evaluation.decode import beam_eval, greedy_eval
    from s2vt_tpu_torch.ops import fused_gru
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "gru_seq_fwd"), ("bwd", "gru_seq_bwd")):
        plain = getattr(fused_gru, name)
        monkeypatch.setattr(fused_gru, name, lambda *a, _k=key, _p=plain: (
            calls.__setitem__(_k, calls[_k] + 1), _p(*a))[1])
    cfg = tmp_path / "opt.json"
    cfg.write_text(small_opt(corpus, tmp_path, dim_hidden=16, dim_embed=16).to_json())
    tr = main(["--config", str(cfg), "--device", "cpu", "--EPOCHS", "2", "--use_pallas",
               "true", "--rnn_type", "gru", "--lr", "0.01"])
    assert tr.opt.rnn_type == "gru" and not tr.model._fused_ok()
    assert tr.model.vid_rnn.l0["w_hh"].shape == (48, 16)
    # 2 epochs of 2 train and 1 validation steps, two RNNs each
    assert calls == {"fwd": 2 * 2 * 3, "bwd": 2 * 2 * 2}
    final = os.path.join(tr.opt.save_path, tr.opt.start_time + "final")
    n_test = len(tr.train_ds.splits["test"])
    for preds in (greedy_eval(final, batch_size=B, device="cpu"),
                  beam_eval(final, batch_size=B, device="cpu", max_beam_depth=5)):
        assert len(preds) == n_test and all(isinstance(s, str) for s in preds.values())
    assert calls["fwd"] == 2 * 2 * 3 + 2 * 2 * -(-n_test // B)    # + 2 per decode request


@pytest.mark.cuda
def test_trainer_step_on_card_launches_each_kernel_once(corpus, tmp_path):
    """One train step on the card runs the fused forward and backward kernels
    once each and gives the CPU (plain) route's loss and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trainers = {dev: Trainer(small_opt(corpus, tmp_path / dev, use_pallas=True), device=dev)
                for dev in ("cpu", "cuda")}
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    batch = next(trainers["cpu"].train_ds.batches(B, epoch=0))
    results = {}
    for dev, tr in trainers.items():
        fwd, bwd = fused_s2vt.fused_s2vt_fwd.launches, fused_s2vt.fused_s2vt_bwd.launches
        loss = tr.train_step(*tr._put(batch, "train"))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused_s2vt.fused_s2vt_fwd.launches == fwd + 1
            assert fused_s2vt.fused_s2vt_bwd.launches == bwd + 1
        results[dev] = (loss.item(), {k: p.grad.cpu() for k, p in tr.model.named_parameters()})
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    for k, g in results["cpu"][1].items():
        np.testing.assert_allclose(results["cuda"][1][k].numpy(), g.numpy(), atol=2e-3,
                                   rtol=2e-3, err_msg=k)
