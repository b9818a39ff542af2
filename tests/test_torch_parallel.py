"""Data- and vocab-parallel training, decode and extraction of the port,
against its one-rank run and the JAX package's mesh.

Four gloo processes (``spawn_gloo`` of tests/test_torch_parallel_mesh.py)
run every multi-rank case of this file in one spawn, and two more run the
two-process cases; the JAX side runs here on its 8 virtual CPU devices
(tests/conftest.py). Tolerances:

 - the vocab-parallel loss and every gradient against the port's unsharded
   ones: within 1e-6 relative (float32 sums taken in another order, nothing
   more): the loss, and the gradients of the three vocab leaves, each
   within 1e-6 of its own largest magnitude; the replicated leaves, whose
   gradients come through the summed dh, within 1e-6 of the model's
   largest gradient magnitude (a leaf whose gradient is a cancellation,
   such as the attention baseline's att_enc.bias at ~3e-6 beside ~1e-2
   elsewhere, keeps the absolute float32 error of the terms it sums);
 - ``Trainer.fit``: per-epoch losses and lr within rtol 1e-4 of the JAX
   Trainer at the same mesh (dropout 0; tests/test_torch_training.py's
   bound), within rtol 1e-5 of the port's one-rank run at the same global
   batch (dropout included: the masks are drawn for the global batch);
 - decode: tokens equal; beam scores within rtol 1e-5, atol 1e-6
   (tests/test_tp_decode.py:68-89);
 - the two-process train step of tests/dist_worker.py: within 1e-6
   relative of one process.
"""

import importlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
from s2vt_tpu_torch.evaluation.decode import CaptionDecoder, beam_eval, greedy_eval
from s2vt_tpu_torch.parallel import distributed
from s2vt_tpu_torch.parallel import mesh as mesh_lib
from s2vt_tpu_torch.parallel.vocab import shard_model_
from s2vt_tpu_torch.training import Trainer
from s2vt_tpu_torch.training.checkpoint import load_training_state
from s2vt_tpu_torch.training.loop import batch_loss, build_model
from s2vt_tpu_torch.utils.weights import flatten_params, params_from_jax

from test_torch_parallel_mesh import spawn_gloo

L, F, H, B = 6, 16, 16, 8                 # the training corpus (test_torch_training's)
DL, DD = 8, 12                            # the decode corpus (tests/test_tp_decode.py's)
FIT_MESHES = ((2, 2), (4, 1))
GRAD_CASES = (("s2vt", (1, 4)), ("s2vt", (2, 2)), ("att_baseline", (2, 2)))
MSRVTT_VOCAB = 29056                      # tests/test_training.py:238


def _model(opt_kw, vocab, valid, state) -> torch.nn.Module:
    """A whole model of ``opt_kw`` with the weights ``state`` (a JAX-layout
    tree of numpy arrays or a state_dict)."""
    model = build_model(Opt(**opt_kw), vocab, valid_vocab=valid)
    if "embedding" in state:
        state = params_from_jax(state)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return model


# ---------------------------------------------------------------------------
# What each rank runs
# ---------------------------------------------------------------------------

def _grads(spec, mesh=None) -> dict:
    """Loss and every gradient (whole tensors) of one forward and backward on
    the global batch ``spec["batch"]``: with a mesh this rank's rows and
    vocab shard, then summed over the data group and gathered."""
    import torch.distributed as dist
    model = _model(spec["opt"], spec["vocab"], spec["valid"], spec["state"])
    feats, labels, mask, valid = (torch.from_numpy(a) for a in spec["batch"])
    group = None
    if mesh is not None:
        shard_model_(model, mesh)
        lo, hi = mesh_lib.batch_rows(len(feats), mesh)
        feats, labels, mask, valid = feats[lo:hi], labels[lo:hi], mask[lo:hi], valid[lo:hi]
        group = mesh.get_group("data")
    logits = model(feats, labels[:, :-1], mode="train", deterministic=True)
    loss = batch_loss(logits, labels.long(), mask, valid, masked=True,
                      shard=model.vocab_shard if mesh is not None else None, data_group=group)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    loss = loss.detach()
    if mesh is not None:
        for g in list(grads.values()) + [loss]:
            dist.all_reduce(g, group=group)
        grads = mesh_lib.gather_state_dict(grads, mesh, spec["vocab"])
    return {"loss": float(loss), "grads": {k: g.numpy() for k, g in grads.items()}}


def _fit(p, shape, drop, mesh=None) -> dict:
    """Trainer.fit for 2 epochs from the JAX Trainer's initial weights; with
    ``drop`` dropout, the metric eval, async saves and streamed features
    (each rank reads its rows' files) too."""
    kw = dict(p["fit_opt"], save_path=os.path.join(p["root"], f"fit{shape}{drop}", "ckpt"),
              mesh_shape=shape if mesh is not None else (1, 1))
    if drop:
        kw.update(feat_dropout=0.3, out_dropout=0.2, metric_eval_freq=1, save_freq=1,
                  async_checkpoint=True, device_feature_bank="off", prefetch_depth=2)
    model = _model(kw, p["fit_vocab"], p["fit_valid"], p["fit_init"])
    tr = Trainer(Opt(**kw), mesh=mesh, model=model, device="cpu", writer=None)
    hist = tr.fit(epochs=2)
    final = os.path.join(kw["save_path"], tr.opt.start_time + "final")
    return {"hist": {k: hist[k] for k in ("train_loss", "valid_loss", "lr", "metrics")
                     if k in hist}, "final": final}


def _decode(p, mesh=None) -> dict:
    """Greedy and beam over the decode corpus's test split, and one batch's
    beam tokens and scores, with S2VT (plain and kernel pick) and the
    attention baseline."""
    ds = VideoDataset(p["dec_caps"], p["dec_feats"], max_len=DL, mode="test")
    out = {}
    for name, kw in (("s2vt", {}), ("s2vt_pallas", {"use_pallas": True}),
                     ("att", {"model": "att_baseline"})):
        state = p["dec_state_att"] if name == "att" else p["dec_state"]
        model = _model(dict(p["dec_opt"], **kw), p["dec_vocab"], p["dec_valid"], state)
        dec = CaptionDecoder(model, ds, "cpu", mesh=mesh)
        out[name] = {"greedy": dec.greedy(4), "beam": dec.beam(4)}
    model = _model(p["dec_opt"], p["dec_vocab"], p["dec_valid"], p["dec_state"])
    if mesh is not None:
        shard_model_(model, mesh)
    res = model.beam(torch.from_numpy(p["dec_batch"]), 3, 6)
    out["beam_batch"] = (res.tokens.numpy(), res.scores.numpy())
    return out


def _tp_checkpoint(p) -> dict:
    """tests/test_tp_decode.py's full loop: train with opt.mesh_shape (2, 2)
    (the Trainer builds the mesh), checkpoint, then caption through
    greedy_eval and beam_eval, whose mesh comes from the checkpoint."""
    opt = Opt(**p["tp_opt"])
    tr = Trainer(opt, device="cpu", writer=None)
    tr.fit(epochs=2)
    path = tr.save("tp_ckpt", blocking=True)
    args = (path, p["tp_caps"], p["tp_feats"])
    return {"path": path, "greedy": greedy_eval(*args, batch_size=4, device="cpu"),
            "beam": beam_eval(*args, batch_size=4, device="cpu"),
            "vocab_rows": tuple(tr.model.embedding.weight.shape)}


def _cases4(rank, p) -> dict:
    out = {}
    for kind, shape in GRAD_CASES:
        out[("grads", kind, shape)] = _grads(p["grads"][kind], mesh_lib.make_mesh(shape, "cpu"))
    out["msrvtt"] = _grads(p["msrvtt"], mesh_lib.make_mesh((2, 2), "cpu"))
    for shape in FIT_MESHES:
        for drop in (False, True):
            out[("fit", shape, drop)] = _fit(p, shape, drop, mesh_lib.make_mesh(shape, "cpu"))
    out["decode"] = _decode(p, mesh_lib.make_mesh((2, 2), "cpu"))
    out["tp_ckpt"] = _tp_checkpoint(p)
    return out


def _dist_step(p, mesh=None) -> tuple:
    """tests/dist_worker.py's computation: two Adam(1e-2) steps of a tiny
    S2VT on a deterministic global batch of 16; each process takes its
    rows (``host_local_batch``) and the gradients are summed over them.
    Returns (loss0, loss1, the parameters' l2 norm)."""
    import torch.distributed as dist
    model = _model(p["dist_opt"], 40, None, p["dist_init"])
    arrays = [torch.from_numpy(a) for a in p["dist_batch"]]
    group = None
    if mesh is not None:
        arrays = list(distributed.host_local_batch(*arrays))
        group = mesh.get_group("data")
    f, lab, mk, vd = arrays
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(2):
        logits = model(f, lab[:, :-1].long(), mode="train", deterministic=True)
        loss = batch_loss(logits, lab.long(), mk, vd, data_group=group)
        opt.zero_grad()
        loss.backward()
        loss = loss.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
            for q in model.parameters():
                dist.all_reduce(q.grad, group=group)
        opt.step()
        losses.append(float(loss))
    norm = torch.sqrt(sum((q.detach() ** 2).sum() for q in model.parameters()))
    return losses[0], losses[1], float(norm)


def _extract(p, mesh=None) -> np.ndarray:
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    return FeatureExtractor("tiny", device="cpu", mesh=mesh)(p["frames"])


def _cases2(rank, p) -> dict:
    mesh = mesh_lib.make_mesh((2, 1), "cpu")
    return {"dist": _dist_step(p, mesh), "extract": _extract(p, mesh)}


# ---------------------------------------------------------------------------
# The parent: inputs, the JAX side and the one-rank references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    names = ("jax", "s2vt_tpu.config", "s2vt_tpu.training", "s2vt_tpu.parallel.mesh",
             "s2vt_tpu.evaluation.decode", "s2vt_tpu.models", "s2vt_tpu.data.dataset")
    return dict(zip(("jax", "config", "training", "mesh", "decode", "models", "dataset"),
                    (importlib.import_module(n) for n in names)))


def _fit_opt(corpus, root) -> dict:
    return dict(caption_file=corpus["captions_file"], feats_path=corpus["feat_path"],
                gts_file=corpus["gts_file"], train_length=L, dim_hidden=H, dim_embed=H,
                feat_dim=F, batch_size=B, vocab_pad_multiple=32, lr=1e-3, EPOCHS=2,
                save_freq=100, learning_rate_patience=0, seed=0, use_pallas=True,
                async_checkpoint=False, log_dir=os.path.join(root, "runs"),
                save_path=os.path.join(root, "ckpt"))


def _batch(rng, n, length, feat, vocab, lo=1):
    feats = rng.normal(size=(n, length, feat)).astype(np.float32)
    labels = rng.integers(lo, vocab, size=(n, length)).astype(np.int64)
    mask = (rng.random((n, length)) < 0.8).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[-1] = 0.0
    return feats, labels, mask, valid


def _jax_fit(jx, fit_opt, shape, root):
    jopt = jx["config"].Opt(**dict(json.loads(Opt(**fit_opt).to_json()), mesh_shape=shape,
                                   use_pallas=False,
                                   save_path=os.path.join(root, f"jax{shape}")))
    jtr = jx["training"].Trainer(jopt, mesh=jx["mesh"].make_mesh(shape), writer=None)
    init = jx["jax"].device_get(jtr.params)
    return init, jtr.fit(epochs=2)


@pytest.fixture(scope="module")
def setup(jx, tmp_path_factory):
    """Every rank's inputs, and the JAX side's results."""
    root = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    corpus = make_synthetic_corpus(os.path.join(root, "train"), n_videos=32, vocab_extra=20,
                                   feat_len=L, feat_dim=F, seed=5)
    fit_opt = _fit_opt(corpus, root)
    jax_fits = {shape: _jax_fit(jx, fit_opt, shape, root) for shape in FIT_MESHES}
    init = jax_fits[FIT_MESHES[0]][0]
    vocab_real = VideoDataset(corpus["captions_file"], corpus["feat_path"], max_len=L).vocab_size
    p = {"root": root, "fit_opt": fit_opt, "fit_init": init, "fit_vocab": 32,
         "fit_valid": vocab_real}

    # Gradients: S2VT and the attention baseline (padding row 0) at V = 32.
    p["grads"] = {}
    for kind in ("s2vt", "att_baseline"):
        opt_kw = dict(model=kind, train_length=L, dim_hidden=H, dim_embed=H, feat_dim=F,
                      use_pallas=True)
        m = build_model(Opt(**opt_kw), 32, valid_vocab=30)
        m.reset_parameters(torch.Generator().manual_seed(3))
        p["grads"][kind] = {"opt": opt_kw, "vocab": 32, "valid": 30,
                            "state": {k: v.detach().numpy() for k, v in m.state_dict().items()},
                            "batch": _batch(rng, 8, L, F, 32, lo=0)}
    opt_kw = dict(train_length=DL, dim_hidden=16, dim_embed=16, feat_dim=DD)
    m = build_model(Opt(**opt_kw), MSRVTT_VOCAB)
    m.reset_parameters(torch.Generator().manual_seed(4))
    p["msrvtt"] = {"opt": opt_kw, "vocab": MSRVTT_VOCAB, "valid": None,
                   "state": {k: v.detach().numpy() for k, v in m.state_dict().items()},
                   "batch": _batch(rng, 16, DL, DD, MSRVTT_VOCAB)}

    # Decode: tests/test_tp_decode.py's corpus and JAX-initialised weights.
    dmeta = make_synthetic_corpus(os.path.join(root, "dec"), n_videos=10, vocab_extra=27,
                                  feat_len=DL, feat_dim=DD, seed=7)
    dds = VideoDataset(dmeta["captions_file"], dmeta["feat_path"], max_len=DL, mode="test")
    dvocab = mesh_lib.pad_to_multiple(dds.vocab_size, 8)
    dec_opt = dict(train_length=DL, dim_hidden=16, dim_embed=16, feat_dim=DD,
                   sos_ix=dds.specials["sos_ix"], eos_ix=dds.specials["eos_ix"])
    jmodel = jx["models"].S2VT(vocab_size=dvocab, feat_dim=DD, length=DL, dim_hid=16,
                               dim_embed=16, sos_ix=dec_opt["sos_ix"],
                               eos_ix=dec_opt["eos_ix"], valid_vocab=dds.vocab_size)
    jax = jx["jax"]
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), np.zeros((2, DL, DD), np.float32), mode="test")["params"])
    att = build_model(Opt(model="att_baseline", **dec_opt), dvocab, valid_vocab=dds.vocab_size)
    att.reset_parameters(torch.Generator().manual_seed(6))
    p.update(dec_caps=dmeta["captions_file"], dec_feats=dmeta["feat_path"], dec_opt=dec_opt,
             dec_vocab=dvocab, dec_valid=dds.vocab_size, dec_state=jparams,
             dec_state_att={k: v.detach().numpy() for k, v in att.state_dict().items()},
             dec_batch=next(dds.batches(4, shuffle=False)).feats)
    jds = jx["dataset"].VideoDataset(dmeta["captions_file"], dmeta["feat_path"], max_len=DL,
                                     mode="test")
    jdec = jx["decode"].CaptionDecoder(jmodel, jparams, jds, mesh=jx["mesh"].make_mesh((2, 2)))
    jm = jx["mesh"].make_mesh((2, 2))
    jp = jax.device_put(jparams, jx["mesh"].param_shardings(jm, jparams))
    jf = jax.device_put(p["dec_batch"], jx["mesh"].batch_sharding(jm))
    jres = jax.jit(lambda q, f: jmodel.apply({"params": q}, f, mode="beam_search",
                                             beam_width=3, max_beam_depth=6))(jp, jf)
    jax_decode = {"greedy": jdec.greedy(batch_size=4), "beam": jdec.beam(batch_size=4),
                  "beam_batch": (np.asarray(jres.tokens), np.asarray(jres.scores))}

    # A checkpoint trained with tensor parallelism (tests/test_tp_decode.py:92-132).
    tmeta = make_synthetic_corpus(os.path.join(root, "tp"), n_videos=10, feat_len=DL,
                                  feat_dim=DD, seed=11)
    p.update(tp_caps=tmeta["captions_file"], tp_feats=tmeta["feat_path"],
             tp_opt=dict(caption_file=tmeta["captions_file"], feats_path=tmeta["feat_path"],
                         gts_file=tmeta["gts_file"], train_length=DL, dim_hidden=16,
                         dim_embed=16, feat_dim=DD, batch_size=8, lr=1e-2, mesh_shape=(2, 2),
                         vocab_pad_multiple=8, seed=0, async_checkpoint=False,
                         save_path=os.path.join(root, "tp_ckpt"),
                         log_dir=os.path.join(root, "tp_runs")))

    # tests/dist_worker.py's model and batch, JAX-initialised.
    dist_opt = dict(train_length=8, dim_hidden=32, dim_embed=32, feat_dim=16, sos_ix=3, eos_ix=4)
    jd = jx["models"].S2VT(vocab_size=40, feat_dim=16, length=8, dim_hid=32, dim_embed=32,
                           sos_ix=3, eos_ix=4, use_pallas=False)
    dist_init = jax.tree_util.tree_map(np.asarray, jd.init(
        jax.random.PRNGKey(0), np.zeros((2, 8, 16), np.float32), np.zeros((2, 7), np.int32),
        mode="train", deterministic=True)["params"])
    drng = np.random.default_rng(0)
    p.update(dist_opt=dist_opt, dist_init=dist_init,
             dist_batch=(drng.normal(size=(16, 8, 16)).astype(np.float32),
                         drng.integers(1, 40, size=(16, 8)).astype(np.int64),
                         np.ones((16, 8), np.float32), np.ones((16,), np.float32)),
             frames=np.random.default_rng(1).integers(0, 256, (8, 40, 48, 3), dtype=np.uint8))
    return p, {"fits": jax_fits, "decode": jax_decode}


@pytest.fixture(scope="module")
def ranks4(setup):
    return spawn_gloo(_cases4, (setup[0],), world=4)


@pytest.fixture(scope="module")
def ranks2(setup):
    return spawn_gloo(_cases2, (setup[0],), world=2)


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's one-rank results on the same inputs, with no process group."""
    p, _ = setup
    return {"fits": {drop: _fit(p, "one", drop) for drop in (False, True)},
            "decode": _decode(p)}


def _norm_close(got, want, tol=1e-6, what="", scale=None):
    """|got - want| <= tol * scale, scale by default the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max() if scale is None else scale, 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        f"{what}: {np.abs(got - want).max() / scale:.3g} of the largest magnitude"


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind, shape", GRAD_CASES)
def test_vocab_parallel_loss_and_gradients(setup, ranks4, kind, shape):
    """Vocab-parallel CE, embedding (its padding row included) and the
    out-projection's input at (1, 4) and (2, 2): the loss and every
    gradient of the whole model equal the unsharded port's."""
    p, _ = setup
    want = _grads(p["grads"][kind])
    model_scale = max(np.abs(g).max() for g in want["grads"].values())
    for r in ranks4:
        got = r[("grads", kind, shape)]
        _norm_close(got["loss"], want["loss"], what="loss")
        assert set(got["grads"]) == set(want["grads"])
        for k in want["grads"]:
            replicated = mesh_lib.vocab_dim(k) is None
            _norm_close(got["grads"][k], want["grads"][k], what=k,
                        scale=model_scale if replicated else None)


def test_msrvtt_vocab_step(setup, ranks4):
    """One train step's loss and gradients at MSR-VTT's vocab (29056 rows,
    tests/test_training.py:238) at (2, 2), against the unsharded port."""
    p, _ = setup
    want = _grads(p["msrvtt"])
    for r in ranks4:
        got = r["msrvtt"]
        assert np.isfinite(got["loss"])
        _norm_close(got["loss"], want["loss"], what="loss")
        for k in ("embedding.weight", "out_linear.weight", "out_linear.bias", "vid_rnn.l0.w_ih"):
            _norm_close(got["grads"][k], want["grads"][k], what=k)


@pytest.mark.parametrize("shape", FIT_MESHES)
def test_fit_matches_the_jax_trainer_and_one_rank(setup, ranks4, one_rank, shape):
    """Dropout 0: per-epoch losses and lr within rtol 1e-4 of the JAX
    Trainer at make_mesh(shape), and within 1e-5 of the port's one rank."""
    _, jside = setup
    want_jax = jside["fits"][shape][1]
    want_one = one_rank["fits"][False]["hist"]
    for r in ranks4:
        got = r[("fit", shape, False)]["hist"]
        for key in ("train_loss", "valid_loss", "lr"):
            np.testing.assert_allclose(got[key], want_jax[key], rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(got[key], want_one[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("shape", FIT_MESHES)
def test_fit_with_dropout_matches_one_rank(ranks4, one_rank, shape):
    """Dropout 0.3 / 0.2, features streamed: masks drawn for the global
    batch and sliced, so the losses, lr and the metric eval's scores
    (decoded over the ranks, scored on rank 0, broadcast) follow the
    one-rank run."""
    want = one_rank["fits"][True]["hist"]
    for r in ranks4:
        got = r[("fit", shape, True)]["hist"]
        for key in ("train_loss", "valid_loss", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
        assert [m["epoch"] for m in got["metrics"]] == [0, 1]
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose([g[k] for k in sorted(w)], [w[k] for k in sorted(w)],
                                       rtol=1e-5)


@pytest.mark.parametrize("shape", FIT_MESHES)
@pytest.mark.parametrize("drop", [False, True])
def test_final_checkpoint_matches_one_rank(ranks4, one_rank, shape, drop):
    """Rank 0's final checkpoint holds whole tensors in the one-rank layout:
    parameters, AdamW's moments and step, lr and epochs as the one-rank
    run's (the async periodic save of the dropout run landed too)."""
    paths = {r[("fit", shape, drop)]["final"] for r in ranks4}
    assert len(paths) == 1
    params, optim, state = load_training_state(paths.pop())
    want_p, want_o, want_s = load_training_state(one_rank["fits"][drop]["final"])
    assert state["epochs_done"] == want_s["epochs_done"] == 2 and state["lr"] == want_s["lr"]
    for cb in ("plateau", "early"):        # best valid losses: the fits' tolerance
        assert state[cb].keys() == want_s[cb].keys()
        for k, v in want_s[cb].items():
            if isinstance(v, float):
                np.testing.assert_allclose(state[cb][k], v, rtol=1e-5, err_msg=k)
            else:
                assert state[cb][k] == v, k
    for got_t, want_t in ((params, want_p), (optim["exp_avg"], want_o["exp_avg"]),
                          (optim["exp_avg_sq"], want_o["exp_avg_sq"])):
        got_f, want_f = flatten_params(got_t), flatten_params(want_t)
        assert set(got_f) == set(want_f)
        for k in want_f:
            assert got_f[k].shape == want_f[k].shape, k
            _norm_close(got_f[k], want_f[k], tol=1e-5, what=k)
    assert float(optim["step"]) == float(want_o["step"]) == 4.0


def test_greedy_and_beam_with_tensor_parallelism(setup, ranks4, one_rank):
    """(2, 2): the captions of S2VT (plain and kernel pick) and of the
    attention baseline equal the replicated port's on every rank, and
    S2VT's equal JAX's tensor-parallel decode."""
    _, jside = setup
    want = one_rank["decode"]
    for r in ranks4:
        got = r["decode"]
        for name in ("s2vt", "s2vt_pallas", "att"):
            assert got[name]["greedy"] and got[name]["greedy"] == want[name]["greedy"], name
            assert got[name]["beam"] and got[name]["beam"] == want[name]["beam"], name
        assert got["s2vt"]["greedy"] == jside["decode"]["greedy"]
        assert got["s2vt"]["beam"] == jside["decode"]["beam"]


def test_beam_scores_with_tensor_parallelism(setup, ranks4, one_rank):
    _, jside = setup
    for want_tok, want_score in (one_rank["decode"]["beam_batch"],
                                 jside["decode"]["beam_batch"]):
        for r in ranks4:
            tok, score = r["decode"]["beam_batch"]
            np.testing.assert_array_equal(tok, want_tok)
            np.testing.assert_allclose(score, want_score, rtol=1e-5, atol=1e-6)


def test_tp_trained_checkpoint_captions_and_exports(setup, ranks4, tmp_path):
    """The Trainer builds its (2, 2) mesh from opt.mesh_shape; its checkpoint
    captions through greedy_eval and beam_eval from its own opt.json (the
    mesh from there) as the replicated decode of the same checkpoint does,
    and exports and replays through cli.export_serving like any other."""
    p, _ = setup
    res = [r["tp_ckpt"] for r in ranks4]
    assert len({r["path"] for r in res}) == 1
    vocab = VideoDataset(p["tp_caps"], p["tp_feats"], max_len=DL).vocab_size
    assert {r["vocab_rows"][0] for r in res} == {mesh_lib.pad_to_multiple(vocab, 8) // 2}
    rep = tmp_path / "rep"
    shutil.copytree(res[0]["path"], rep)
    cfg = json.loads((rep / "opt.json").read_text())
    assert cfg["mesh_shape"] == [2, 2]
    cfg["mesh_shape"] = [1, 1]
    (rep / "opt.json").write_text(json.dumps(cfg))
    args = (str(rep), p["tp_caps"], p["tp_feats"])
    want_greedy = greedy_eval(*args, batch_size=4, device="cpu")
    want_beam = beam_eval(*args, batch_size=4, device="cpu")
    for r in res:
        assert r["greedy"] and r["greedy"] == want_greedy
        assert r["beam"] and r["beam"] == want_beam

    from s2vt_tpu_torch.cli import export_serving
    from s2vt_tpu_torch.evaluation.decode import model_from_checkpoint
    from s2vt_tpu_torch.serving import ServingCaptioner
    out = export_serving.main(["--model_path", res[0]["path"], "--out", str(tmp_path / "art"),
                               "--batch", "4", "--device", "cpu"])
    ds = VideoDataset(p["tp_caps"], p["tp_feats"], max_len=DL, mode="test")
    _, model = model_from_checkpoint(str(rep), ds.vocab_size, device="cpu")
    feats = next(ds.batches(4, shuffle=False)).feats
    np.testing.assert_array_equal(ServingCaptioner(out).decode_tokens(feats),
                                  model.greedy(torch.from_numpy(feats)).numpy())


def test_two_process_train_step_matches_one_process(setup, ranks2, jx):
    """tests/dist_worker.py's check in the port: two processes, each on its
    rows, against one process, within 1e-6 relative; and against the JAX
    computation of the same step from the same weights, within 1e-5."""
    p, _ = setup
    one = _dist_step(p)
    for r in ranks2:
        assert r["dist"] == ranks2[0]["dist"]
        for got, want in zip(r["dist"], one):
            assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (r["dist"], one)
    import optax
    jax, jnp = jx["jax"], importlib.import_module("jax.numpy")
    from s2vt_tpu.training.loop import batch_loss as jloss
    jm = jx["models"].S2VT(vocab_size=40, feat_dim=16, length=8, dim_hid=32, dim_embed=32,
                           sos_ix=3, eos_ix=4, use_pallas=False)
    f, lab, mk, vd = (jnp.asarray(a) for a in p["dist_batch"])
    lab = lab.astype(jnp.int32)
    tx = optax.adam(1e-2)

    @jax.jit
    def step(params, state):
        loss, g = jax.value_and_grad(lambda q: jloss(jm.apply(
            {"params": q}, f, lab[:, :-1], mode="train", deterministic=True), lab, mk, vd))(params)
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss

    params, losses = p["dist_init"], []
    state = tx.init(params)
    for _ in range(2):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    norm = float(jnp.sqrt(sum(jnp.sum(x ** 2) for x in jax.tree_util.tree_leaves(params))))
    for got, want in zip(ranks2[0]["dist"], (*losses, norm)):
        assert abs(got - want) <= 1e-5 * abs(want)


def test_data_parallel_extraction(setup, ranks2):
    """FeatureExtractor(mesh=(2, 1)): each rank forwards half the frames and
    the features, gathered in order, equal the one-device extraction."""
    p, _ = setup
    want = _extract(p)
    for r in ranks2:
        np.testing.assert_array_equal(r["extract"], want)
