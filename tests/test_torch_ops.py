"""The port's cells and layers against s2vt_tpu.ops, on the same numpy inputs.

Tolerances: float32 at atol 1e-5 (the two frameworks sum the same float32
products in another order); bf16 at 2e-2 (operands are rounded to bf16 on
both sides, so only an operand that lands on the other side of a rounding
boundary differs, by one bf16 ulp of the operand).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax.numpy as jnp

from s2vt_tpu.ops import layers as jlayers
from s2vt_tpu.ops import rnn as jrnn
from s2vt_tpu_torch.ops import layers as tlayers
from s2vt_tpu_torch.ops import rnn as trnn

DTYPES = {"f32": (None, None, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, T, IN, H = 4, 7, 24, 32


def _params(rng, rnn_type, in_size, hidden):
    g = (4 if rnn_type == "lstm" else 3) * hidden
    k = 1.0 / np.sqrt(hidden)
    shapes = {"w_ih": (g, in_size), "w_hh": (g, hidden), "b_ih": (g,), "b_hh": (g,)}
    return {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in shapes.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_step_matches_jax(dtype, rnn_type):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    p = _params(rng, rnn_type, IN, H)
    x = rng.normal(size=(B, IN)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    jstep = {"lstm": jrnn.lstm_step, "gru": jrnn.gru_step}[rnn_type]
    tstep = {"lstm": trnn.lstm_step, "gru": trnn.gru_step}[rnn_type]
    jxp = jrnn.input_projection(jnp.asarray(x), _j(p), jdt)
    txp = trnn.input_projection(torch.from_numpy(x), _t(p), tdt)
    _close(txp, jxp, atol)
    jst, jout = jstep(jrnn.LSTMState(jnp.asarray(h), jnp.asarray(c)), jxp, _j(p), jdt)
    tst, tout = tstep(trnn.LSTMState(torch.from_numpy(h), torch.from_numpy(c)), txp,
                      _t(p), tdt)
    _close(tout, jout, atol)
    _close(tst.c, jst.c, atol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rnn_sequence_matches_jax(dtype, rnn_type, reverse):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    p = _params(rng, rnn_type, IN, H)
    xs = rng.normal(size=(B, T, IN)).astype(np.float32)
    jout, jfin = jrnn.rnn_sequence(jnp.asarray(xs), _j(p), None, rnn_type, reverse, jdt)
    tout, tfin = trnn.rnn_sequence(torch.from_numpy(xs), _t(p), None, rnn_type, reverse, tdt)
    _close(tout, jout, atol)
    _close(tfin.h, jfin.h, atol)
    _close(tfin.c, jfin.c, atol)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multilayer_matches_jax(dtype, rnn_type):
    """Two stacked layers: the sequence form and one decode step."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    layers = [_params(rng, rnn_type, IN, H), _params(rng, rnn_type, H, H)]
    xs = rng.normal(size=(B, T, IN)).astype(np.float32)
    jout, jfins = jrnn.multilayer_rnn(jnp.asarray(xs), [_j(p) for p in layers],
                                      rnn_type=rnn_type, compute_dtype=jdt)
    tout, tfins = trnn.multilayer_rnn(torch.from_numpy(xs), [_t(p) for p in layers],
                                      rnn_type=rnn_type, compute_dtype=tdt)
    _close(tout, jout, atol)
    jst, jh = jrnn.multilayer_step(jfins, jnp.asarray(xs[:, 0]), [_j(p) for p in layers],
                                   rnn_type, jdt)
    tst, th = trnn.multilayer_step(tfins, torch.from_numpy(xs[:, 0]),
                                   [_t(p) for p in layers], rnn_type, tdt)
    _close(th, jh, atol)
    for a, b in zip(tst, jst):
        _close(a.h, b.h, atol)
        _close(a.c, b.c, atol)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bidirectional_multilayer_matches_jax(dtype, rnn_type):
    """Two bidirectional layers: the reverse direction flips time, the
    second layer reads both directions' outputs."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    layers = [(_params(rng, rnn_type, IN, H), _params(rng, rnn_type, IN, H)),
              (_params(rng, rnn_type, 2 * H, H), _params(rng, rnn_type, 2 * H, H))]
    xs = rng.normal(size=(B, T, IN)).astype(np.float32)
    jout, jfins = jrnn.multilayer_rnn(jnp.asarray(xs), [(_j(f), _j(b)) for f, b in layers],
                                      rnn_type=rnn_type, bidirectional=True, compute_dtype=jdt)
    tout, tfins = trnn.multilayer_rnn(torch.from_numpy(xs), [(_t(f), _t(b)) for f, b in layers],
                                      rnn_type=rnn_type, bidirectional=True, compute_dtype=tdt)
    assert tuple(tout.shape) == (B, T, 2 * H)
    _close(tout, jout, atol)
    for (tf, tb), (jf, jb) in zip(tfins, jfins):
        _close(tf.h, jf.h, atol)
        _close(tb.h, jb.h, atol)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_linear_matches_jax(dtype, with_bias):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, IN)).astype(np.float32)
    w = rng.normal(size=(H, IN)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32) if with_bias else None
    want = jlayers.apply_linear(jnp.asarray(x), jnp.asarray(w),
                                None if b is None else jnp.asarray(b), jdt)
    got = tlayers.apply_linear(torch.from_numpy(x), torch.from_numpy(w),
                               None if b is None else torch.from_numpy(b), tdt)
    assert got.dtype == torch.float32
    _close(got, want, atol)


@pytest.mark.parametrize("valid_vocab", [None, 5, 12, 20])
def test_mask_invalid_vocab_matches_jax(valid_vocab):
    logits = np.random.default_rng(4).normal(size=(3, 12)).astype(np.float32)
    want = np.asarray(jlayers.mask_invalid_vocab(jnp.asarray(logits), valid_vocab))
    got = tlayers.mask_invalid_vocab(torch.from_numpy(logits), valid_vocab).numpy()
    np.testing.assert_array_equal(got, want)
    assert tlayers.NEG_INF == jlayers.NEG_INF


def test_dropout_draws_from_generator():
    x = torch.ones(64, 64)
    a = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(7), deterministic=False)
    b = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(7), deterministic=False)
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert tlayers.dropout(x, 0.5, None, deterministic=True) is x
