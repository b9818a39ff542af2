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


def port_trainer(corpus, tmp_path, writer="auto", **kw) -> Trainer:
    return Trainer(small_opt(corpus, tmp_path, **kw), device="cpu", writer=writer)


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
    path = first.save("mid", blocking=True)   # Opt.async_checkpoint is on by default
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


@pytest.mark.parametrize("field, value", [("mesh_shape", (2, 1))])
def test_unported_options_raise(corpus, tmp_path, field, value):
    """A mesh_shape other than (1, 1) builds that mesh (as the JAX CLI and
    greedy_eval do): in a process with no process group, make_mesh raises
    because the world is one process."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        port_trainer(corpus, tmp_path, **{field: value})


def _events(log_dir):
    """(scalars {tag: [(step, value)]}, histogram tags) of a TensorBoard log."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    return scalars, set(tags["histograms"])


def test_writer_logs_the_jax_trainers_tags(jax_training, corpus, tmp_path):
    """The port's TensorBoard log against the JAX Trainer's on the same corpus
    and initial weights: the same scalar tags (train_loss, valid_loss, lr,
    clips_per_sec, valid/<metric>) at the same steps, losses within RTOL and
    lr equal, and the same histogram names (every epoch here)."""
    jax, _, jtraining, _, jconfig, jparallel = jax_training
    kw = dict(histogram_freq=1, metric_eval_freq=2, async_checkpoint=False, dim_hidden=16,
              dim_embed=16)
    jopt = jconfig.Opt(**json.loads(small_opt(corpus, tmp_path / "jax", **kw).to_json()))
    jtr = jtraining.Trainer(jopt.replace(mesh_shape=(1, 1)), mesh=jparallel.make_mesh((1, 1)))
    init = jax.device_get(jtr.params)
    jtr.fit(epochs=2)
    # tensorboardX's flush() leaves the events still queued for its writer
    # thread unwritten; close() writes them. The JAX Trainer only flushes.
    jtr.writer.close()
    tr = port_trainer(corpus, tmp_path / "port", **kw)
    assert tr.writer is not None
    tr.model.load_state_dict(params_from_jax(init))
    tr.fit(epochs=2)                  # closes the writer it opened
    got, got_hist = _events(tmp_path / "port" / "runs")
    want, want_hist = _events(tmp_path / "jax" / "runs")
    assert set(got) == set(want) and {"train_loss", "valid_loss", "lr", "clips_per_sec",
                                      "valid/CIDEr", "valid/Bleu_4"} <= set(got)
    assert got_hist == want_hist and "vid_rnn/l0/w_ih" in got_hist and len(got_hist) > 10
    for tag in got:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
    for tag in ("train_loss", "valid_loss", "lr"):
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   rtol=RTOL, err_msg=tag)
    assert [s for s, _ in got["valid/CIDEr"]] == [1]
    silent = port_trainer(corpus, tmp_path / "silent", writer=None)
    silent.fit(epochs=1)
    assert silent.writer is None and not os.path.exists(tmp_path / "silent" / "runs")


def test_profile_traces_the_first_train_epoch(corpus, tmp_path):
    """Opt.profile writes a Chrome trace of epoch 0's train epoch into
    log_dir/profile, with the train step's operators in it."""
    from s2vt_tpu_torch.utils import profiling
    tr = port_trainer(corpus, tmp_path, profile=True, writer=None)
    tr.fit(epochs=2)
    traces = list((tmp_path / "runs" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"aten::mm", "Optimizer.step#AdamW.step"} & names
    with profiling.trace(str(tmp_path / "mine")):
        with profiling.annotate("my_region"):
            torch.ones(3).sum()
    (mine,) = (tmp_path / "mine").glob("*.pt.trace.json")
    assert "my_region" in mine.read_text()


def _gate_writes(monkeypatch, gate=None, error=None):
    """Make every params.npz write wait for ``gate`` or raise ``error``."""
    from s2vt_tpu_torch.training import checkpoint
    real = checkpoint.save_params_npz

    def gated(path, tree):
        if error is not None:
            raise error
        assert gate.wait(60)
        real(path, tree)

    monkeypatch.setattr(checkpoint, "save_params_npz", gated)


def _checkpoint_files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            with open(os.path.join(path, name), encoding="utf-8") as f:
                out[name] = f.read()
    return out


def test_async_save_snapshots_the_state_and_lands_later(corpus, tmp_path, monkeypatch):
    """An async save returns before its files exist; the directory it writes
    later equals a blocking save of the same moment, although the Trainer
    trains on meanwhile (AdamW updates in place); restore waits for it."""
    import threading
    from s2vt_tpu_torch.training import wait_for_saves
    tr = port_trainer(corpus, tmp_path, async_checkpoint=True, writer=None)
    tr.fit(epochs=1)
    want = tr.save("blocking", blocking=True)
    gate = threading.Event()
    _gate_writes(monkeypatch, gate)
    path = tr.save("async")
    assert not os.path.exists(path)
    tr.train_epoch(7)                     # changes params and moments in place
    gate.set()
    wait_for_saves()
    assert not [n for n in os.listdir(tmp_path / "ckpt") if ".tmp" in n]
    got_files, want_files = _checkpoint_files(path), _checkpoint_files(want)
    assert got_files.keys() == want_files.keys() == {"opt.json", "optimizer.npz", "params.npz",
                                                     "trainer.json"}
    for name, want_val in want_files.items():
        if name.endswith(".npz"):
            assert got_files[name].keys() == want_val.keys()
            for k, v in want_val.items():
                np.testing.assert_array_equal(got_files[name][k], v, err_msg=k)
        else:
            assert got_files[name] == want_val, name
    fresh = port_trainer(corpus, tmp_path / "fresh", writer=None)
    gate.clear()
    again = tr.save("again")
    threading.Timer(0.5, gate.set).start()
    fresh.restore(again)                  # waits for the write first
    assert fresh.epochs_done == 1


def test_final_save_waits_for_async_saves(corpus, tmp_path, monkeypatch):
    """fit's 'final' save blocks until every periodic save has landed."""
    import threading
    gate = threading.Event()
    _gate_writes(monkeypatch, gate)
    threading.Timer(1.0, gate.set).start()
    tr = port_trainer(corpus, tmp_path, async_checkpoint=True, save_freq=1, writer=None)
    tr.fit(epochs=2)
    stamp = tr.opt.start_time
    names = set(os.listdir(tmp_path / "ckpt"))
    assert {stamp + t for t in ("0", "1", "stop", "final")} <= names
    assert not [n for n in names if ".tmp" in n]
    for t in ("0", "1", "final"):
        assert len(os.listdir(tmp_path / "ckpt" / (stamp + t))) == 4


@pytest.mark.parametrize("where", ["next_save", "fit_end"])
def test_async_write_errors_surface(corpus, tmp_path, monkeypatch, where):
    """A failed background write raises at the next save, or at fit's end."""
    tr = port_trainer(corpus, tmp_path, async_checkpoint=True, save_freq=1, writer=None)
    _gate_writes(monkeypatch, error=OSError("disk full"))
    if where == "next_save":
        tr.save("a")
        with pytest.raises(RuntimeError, match="async checkpoint write.*disk full"):
            tr.save("b", blocking=True)
    else:
        with pytest.raises(RuntimeError, match="async checkpoint write.*disk full"):
            tr.fit(epochs=1)


def test_bank_cache_reuses_and_evicts(tmp_path, monkeypatch):
    """Opt.feature_bank_cache: a second Trainer over the same files takes the
    first one's bank tensors; after a feature file changes it misses, and the
    stale entries go."""
    from s2vt_tpu_torch.training import loop
    monkeypatch.setattr(loop, "_BANK_CACHE", {})
    data = make_synthetic_corpus(str(tmp_path / "c"), n_videos=32, vocab_extra=20, feat_len=L,
                                 feat_dim=F, seed=5)
    kw = dict(device_feature_bank="on", feature_bank_cache=True, writer=None)
    a, b = (port_trainer(data, tmp_path / n, **kw) for n in "ab")
    assert a._bank["train"] is b._bank["train"] and a._bank["valid"] is b._bank["valid"]
    assert len(loop._BANK_CACHE) == 2
    off = port_trainer(data, tmp_path / "off", device_feature_bank="on", writer=None)
    assert off._bank["train"] is not a._bank["train"]
    victim = a.train_ds.feat_paths[3]
    np.save(victim, np.full((L, F), 7.0, np.float32))
    st = os.stat(victim)
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    c = port_trainer(data, tmp_path / "c2", **kw)
    assert c._bank["train"] is not a._bank["train"]
    np.testing.assert_array_equal(c._bank["train"][3].numpy(), 7.0)
    assert torch.equal(c._bank["valid"], a._bank["valid"])
    assert len(loop._BANK_CACHE) == 2    # both old entries held the changed file's stats


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_with_prefetch_matches_the_bank(corpus, tmp_path, depth):
    """Streaming through the native loader with prefetch_depth 1-3 gives
    the feature bank's losses bit for bit."""
    bank = port_trainer(corpus, tmp_path / "bank", device_feature_bank="on", writer=None)
    stream = port_trainer(corpus, tmp_path / "stream", device_feature_bank="off",
                          prefetch_depth=depth, writer=None)
    assert stream.train_ds.effective_backend() == "native" and not stream.use_feature_bank
    want, got = bank.fit(epochs=2), stream.fit(epochs=2)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


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


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_on_card_matches_the_bank(corpus, tmp_path, depth):
    """On the card, batches streamed into pinned memory and copied on the
    Trainer's copy stream give the bank run's losses and weights bit for
    bit; an async save of the result equals a blocking one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from s2vt_tpu_torch.training import wait_for_saves
    runs = {}
    for name, kw in (("bank", dict(device_feature_bank="on")),
                     ("stream", dict(device_feature_bank="off", prefetch_depth=depth))):
        tr = Trainer(small_opt(corpus, tmp_path / name, use_pallas=True, **kw), device="cuda",
                     writer=None)
        assert tr._copy_stream is not None
        runs[name] = (tr, tr.fit(epochs=2))
    (bank, want), (stream, got) = runs["bank"], runs["stream"]
    assert stream.train_ds.effective_backend() == "native"
    for key in ("train_loss", "valid_loss"):
        assert got[key] == want[key], key
    for (k, a), b in zip(bank.model.state_dict().items(), stream.model.state_dict().values()):
        assert torch.equal(a, b), k
    batch = next(stream.train_ds.batches(B, epoch=0, feats_alloc=stream._pinned_feats))
    assert isinstance(batch.feats.base, torch.Tensor) and batch.feats.base.is_pinned()
    path = stream.save("async", blocking=False)
    wait_for_saves()
    with np.load(os.path.join(path, "params.npz")) as z:
        for k, v in stream.model.state_dict().items():
            np.testing.assert_array_equal(z[k.replace(".", "//")], v.cpu().numpy(), err_msg=k)
