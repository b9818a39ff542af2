"""The port's S2VT against s2vt_tpu's, on the same numpy weights and inputs.

Sizes as in tests/test_pallas_s2vt.py (B=8, H=E=128, F=16, L=6, V=32), so
that the JAX fused route engages (Pallas in interpret mode on the CPU).
Tolerances are the JAX package's own: teacher-forced logits 5e-5 on the scan
route (tests/test_s2vt_parity.py:92), 1e-4 on the fused route
(tests/test_pallas_s2vt.py:103); greedy tokens exact in float32; bf16
encode states 2e-2.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax
import jax.numpy as jnp

from s2vt_tpu.models import S2VT as JS2VT
from s2vt_tpu.ops import pallas_s2vt as jfused
from s2vt_tpu_torch.models import S2VT as TS2VT
from s2vt_tpu_torch.ops import fused_s2vt as tfused
from s2vt_tpu_torch.utils.weights import flatten_params, params_from_jax

B, L, F, H, V = 8, 6, 16, 128, 32
E = H
KW = dict(vocab_size=V, feat_dim=F, length=L, dim_hid=H, dim_embed=E, sos_ix=3, eos_ix=4)


def make_params(seed, vocab=V, feat=F, hid=H, emb=E):
    """A JAX-layout parameter tree drawn with numpy (torch-style init)."""
    rng = np.random.default_rng(seed)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def rnn(in_size):
        k = 1.0 / np.sqrt(hid)
        return {"l0": {"w_ih": u(k, 4 * hid, in_size), "w_hh": u(k, 4 * hid, hid),
                       "b_ih": u(k, 4 * hid), "b_hh": u(k, 4 * hid)}}

    kf, kh = 1.0 / np.sqrt(feat), 1.0 / np.sqrt(hid)
    return {"vid_rnn": rnn(hid), "word_rnn": rnn(hid + emb),
            "feat_linear": {"weight": u(kf, hid, feat), "bias": u(kf, hid)},
            "out_linear": {"weight": u(kh, vocab, hid), "bias": u(kh, vocab)},
            "embedding": {"weight": rng.normal(size=(vocab, emb)).astype(np.float32)}}


def port_model(params, **kw):
    m = TS2VT(**{**KW, **kw})
    m.load_state_dict(params_from_jax(params))
    return m.eval()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(B, L, F)).astype(np.float32)
    targets = rng.integers(0, V, size=(B, L - 1)).astype(np.int32)
    return make_params(10), feats, targets


def test_param_tree_matches_jax(data):
    params, feats, targets = data
    tree = jax.eval_shape(lambda: JS2VT(**KW).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(targets), mode="train",
        deterministic=True))["params"]
    tree = jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32), tree)
    want = {k: tuple(v.shape) for k, v in flatten_params(tree).items()}
    assert {k: v.shape for k, v in flatten_params(params).items()} == want
    got = {k.replace(".", "//"): tuple(v.shape) for k, v in TS2VT(**KW).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_teacher_forced_logits_match_jax(data, route):
    params, feats, targets = data
    fused = route == "fused"
    want = JS2VT(use_pallas=fused, **KW).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(targets), mode="train",
        deterministic=True)
    with torch.no_grad():
        got = port_model(params, use_pallas=fused)(
            torch.from_numpy(feats), torch.from_numpy(targets).long(), mode="train")
    assert tuple(got.shape) == (B, L - 1, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5 if route == "scan"
                               else 1e-4, rtol=0)


def _port_grads(params, feats, targets, **kw):
    """Gradients of sum(logits^2) * 1e-3 (tests/test_pallas_s2vt.py:106-123)
    for every parameter and the features, as {JAX path: array}."""
    m = port_model(params, **kw)
    f = torch.from_numpy(feats).requires_grad_()
    logits = m(f, torch.from_numpy(targets).long(), mode="train", deterministic=True)
    ((logits ** 2).sum() * 1e-3).backward()
    grads = {k.replace(".", "//"): p.grad.numpy() for k, p in m.named_parameters()}
    return grads, f.grad.numpy()


def test_fused_teacher_forced_gradients_match_jax(data):
    """The fused route's parameter and feature gradients against jax.grad of
    the JAX model's fused route (Pallas backward in interpret mode) and
    against the port's scan route, at 2e-3 (tests/test_pallas_s2vt.py:122)."""
    params, feats, targets = data

    def loss(p, f):
        logits = JS2VT(use_pallas=True, **KW).apply(
            {"params": p}, f, jnp.asarray(targets), mode="train", deterministic=True)
        return jnp.sum(logits ** 2) * 1e-3

    jp, jf = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
    got, got_f = _port_grads(params, feats, targets, use_pallas=True)
    scan, scan_f = _port_grads(params, feats, targets)
    assert set(got) == set(want) == set(scan)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(got[k], scan[k], atol=2e-3, rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(got_f, np.asarray(jf), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got_f, scan_f, atol=2e-3, rtol=2e-3)


def test_scan_teacher_forced_is_differentiable(data):
    params, feats, targets = data
    m = port_model(params)
    m(torch.from_numpy(feats), torch.from_numpy(targets).long(), mode="train").sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("route", ["scan", "fused"])
def test_greedy_tokens_match_jax(data, route, early_stop):
    params, feats, _ = data
    fused = route == "fused"
    want = np.asarray(JS2VT(use_pallas=fused, **KW).apply(
        {"params": params}, jnp.asarray(feats), mode="test", early_stop=early_stop))
    got = port_model(params, use_pallas=fused)(torch.from_numpy(feats), mode="test",
                                               early_stop=early_stop)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_early_stop_fills_with_eos(data):
    """Trained-looking rows stop early: make <eos> the argmax everywhere and
    every token after the first must be <eos> on both sides."""
    params, feats, _ = data
    params = {**params, "out_linear": {**params["out_linear"],
                                       "bias": np.where(np.arange(V) == 4, 50.0, 0.0)
                                       .astype(np.float32)}}
    want = np.asarray(JS2VT(**KW).apply({"params": params}, jnp.asarray(feats), mode="test",
                                        early_stop=True))
    got = port_model(params)(torch.from_numpy(feats), mode="test", early_stop=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 4).all()


def test_bf16_greedy_encode_states_match_jax(data):
    """bf16: the encode (fused route) within 2e-2 of JAX's; the greedy
    tokens' match share is reported, since a bf16 near-tie may flip an
    argmax and every later token of that row with it."""
    params, feats, _ = data
    jm = JS2VT(use_pallas=True, compute_dtype=jnp.bfloat16, **KW)
    tm = port_model(params, use_pallas=True, compute_dtype=torch.bfloat16)
    T = 2 * L - 1
    jproj = jm.apply({"params": params}, jnp.asarray(feats), True, method=JS2VT._project_feats)
    jin = jm.apply({"params": params}, jproj, jnp.zeros((B, T, E)), method=JS2VT._fused_inputs)
    want = jfused.s2vt_fused_infer(*jin, snap_idx=L - 1, compute_bf16=True)
    with torch.no_grad():
        tproj = tm._project_feats(torch.from_numpy(feats), True)
        np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=2e-2, rtol=0)
        tin = tm._fused_inputs(tproj, torch.zeros(B, T, E))
        got = tfused.s2vt_fused_infer(*tin, snap_idx=L - 1, compute_bf16=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-2, rtol=0)
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2, rtol=0)

    jt = np.asarray(jm.apply({"params": params}, jnp.asarray(feats), mode="test"))
    tt = tm(torch.from_numpy(feats), mode="test").numpy()
    share = float((jt == tt).mean())
    print(f"bf16 greedy token match share vs JAX: {share:.4f}")
    assert tt.shape == jt.shape and 0.0 <= share <= 1.0


def test_beam_search_raises(data):
    """Beam search runs (tests/test_torch_beam.py holds it to JAX); it raises
    only for a score mode it does not have, and forward for an unknown mode."""
    params, feats, _ = data
    model = port_model(params)
    res = model(torch.from_numpy(feats), mode="beam_search", max_beam_depth=3)
    assert tuple(res.tokens.shape) == (B, 3, 4)
    with pytest.raises(ValueError, match="score_mode"):
        model(torch.from_numpy(feats), mode="beam_search", beam_score_mode="last")
    with pytest.raises(ValueError, match="unknown mode"):
        model(torch.from_numpy(feats), mode="beam")
