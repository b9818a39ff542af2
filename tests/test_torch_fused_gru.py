"""The port's per-layer GRU sequence op and GRU S2VT against s2vt_tpu's
ops/pallas_gru.py.

On the CPU the port runs the plain versions of its kernels and JAX runs the
Pallas kernels in interpret mode (as tests/test_pallas_gru.py does), on the
same numpy inputs. Tolerances: plain versions against ``_run_forward`` /
``_run_backward`` 1e-5 in float32 (the same products, summed in another
order) and 2e-2 in bf16 (one bf16 ulp of a product operand); gradients of
``gru_sequence`` against ``jax.grad`` of ``gru_sequence_pallas`` atol and
rtol 1e-4 (tests/test_pallas_gru.py:65); ``TorchRNN`` outputs and finals
1e-5 at B=8, H=128, where JAX's ``pallas_shapes_ok`` routes to its kernel
(tests/test_pallas_gru.py:89); GRU S2VT logits 1e-4, greedy tokens, beam
tokens and lengths exact, beam scores 1e-5 and gradients 2e-3
(tests/test_pallas_gru.py:101-122, tests/test_pallas_s2vt.py:122).

The JAX side is imported by fixtures, so that the card tests also collect
where the JAX package cannot be imported. The kernels themselves need a
card: the ``cuda``-marked tests skip elsewhere.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_gru
from s2vt_tpu_torch.ops.rnn import LSTMState, TorchRNN, rnn_sequence
from s2vt_tpu_torch.utils.weights import params_from_jax

ATOL = {"f32": 1e-5, "bf16": 2e-2}
SHAPES = [(4, 6, 8), (5, 7, 20)]          # (B, T, H): tests/test_pallas_gru.py's, and odd
S2VT_KW = dict(vocab_size=32, feat_dim=16, length=6, dim_hid=128, dim_embed=128,
               rnn_type="gru", sos_ix=3, eos_ix=4)


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy, s2vt_tpu.ops.pallas_gru, s2vt_tpu.ops.rnn)."""
    return tuple(importlib.import_module(n) for n in
                 ("jax", "jax.numpy", "s2vt_tpu.ops.pallas_gru", "s2vt_tpu.ops.rnn"))


def _fwd_inputs(seed, b, t, h, zero_init=False):
    """(x_proj_t [T, B, 3H], w_hh [3H, H], b_hh [3H], h0 [B, H]) as float32 numpy."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    xp = rng.normal(size=(t, b, 3 * h)).astype(np.float32)
    w = np.ascontiguousarray(rng.uniform(-k, k, (h, 3 * h)).astype(np.float32).T)
    bhh = rng.uniform(-k, k, 3 * h).astype(np.float32)
    h0 = (np.zeros((b, h), np.float32) if zero_init else
          (0.5 * rng.normal(size=(b, h))).astype(np.float32))
    return xp, w, bhh, h0


def _bwd_inputs(seed, bf16, b, t, h, device="cpu"):
    """(gates, ghn, hprev, w_hh, dout, dhT) from a forward run of the plain
    version, so that the gates and gh_n are real GRU states."""
    xp, w, bhh, h0 = (torch.from_numpy(a).to(device) for a in _fwd_inputs(seed, b, t, h))
    outs, gates, ghn, _ = fused_gru.gru_seq_fwd_reference(xp, w, bhh, h0, bf16)
    hprev = torch.cat([h0[None], outs[:-1]])
    rng = np.random.default_rng(seed + 100)
    dout, dhT = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
                 for s in ((t, b, h), (b, h)))
    return gates, ghn, hprev, w, dout, dhT


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_reference_matches_jax_run_forward(jax_side, shape, dtype, zero_init):
    _, jnp, jgru, _ = jax_side
    bf16 = dtype == "bf16"
    args = _fwd_inputs(0, *shape, zero_init=zero_init)
    xp, w, bhh, h0 = map(jnp.asarray, args)
    want = jgru._run_forward(xp, w.T, bhh, h0, compute_bf16=bf16)     # JAX takes W_hh^T
    got = fused_gru.gru_seq_fwd(*map(torch.from_numpy, args), bf16)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        _close(g, w, ATOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_jax_run_backward(jax_side, shape, dtype):
    _, jnp, jgru, _ = jax_side
    bf16 = dtype == "bf16"
    args = _bwd_inputs(1, bf16, *shape)
    want = jgru._run_backward(*(jnp.asarray(a.numpy()) for a in args), compute_bf16=bf16)
    got = fused_gru.gru_seq_bwd(*args, bf16)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        _close(g, w, ATOL[dtype])


def _jax_gru_params(jax_side, seed, in_size, h):
    jax, _, _, jrnn_ops = jax_side
    return jax.tree_util.tree_map(
        np.array, jrnn_ops.init_gru_params(jax.random.PRNGKey(seed), in_size, h))


@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_sequence_matches_jax_forward_and_gradients(jax_side, with_h0):
    """Outputs and final h within 1e-5, the untouched c carried through;
    gradients of one loss in w_ih, w_hh, b_ih, b_hh, the inputs and (given)
    h0 within atol/rtol 1e-4 (tests/test_pallas_gru.py:44-66)."""
    jax, jnp, jgru, jrnn_ops = jax_side
    b, t, n_in, h = 4, 6, 5, 8
    params = _jax_gru_params(jax_side, 2, n_in, h)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(b, t, n_in)).astype(np.float32)
    tgt = rng.normal(size=(b, t, h)).astype(np.float32)
    h0 = (0.3 * rng.normal(size=(b, h))).astype(np.float32)
    c0 = rng.normal(size=(b, h)).astype(np.float32)

    def jloss(p, x, h_init):
        init = jrnn_ops.LSTMState(h_init, jnp.asarray(c0)) if with_h0 else None
        out, st = jgru.gru_sequence_pallas(x, p, init)
        return jnp.sum((out - tgt) ** 2) + jnp.sum(st.h), (out, st)

    (_, (jout, jst)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(xs), jnp.asarray(h0))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(xs).requires_grad_()
    th0 = torch.from_numpy(h0).requires_grad_()
    out, st = fused_gru.gru_sequence(
        tx, tp, LSTMState(th0, torch.from_numpy(c0)) if with_h0 else None)
    _close(out.detach(), jout, 1e-5)
    _close(st.h.detach(), jst.h, 1e-5)
    np.testing.assert_array_equal(st.c.numpy(), np.asarray(jst.c))
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum() + st.h.sum()
    loss.backward()
    assert set(params) == {"w_ih", "w_hh", "b_ih", "b_hh"}
    for k in params:
        _close(tp[k].grad, jgrads[0][k], 1e-4, 1e-4)
    _close(tx.grad, jgrads[1], 1e-4, 1e-4)
    if with_h0:
        _close(th0.grad, jgrads[2], 1e-4, 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_gru_sequence_gradients_match_torch_autograd_of_the_scan(bf16):
    """An independent check of the hand-written backward: torch autograd
    through the op-by-op scan gives the same outputs and gradients (in bf16
    both round the same product operands, so the recurrent gradients differ
    only where a rounded operand differs)."""
    rng = np.random.default_rng(4)
    k = 1.0 / np.sqrt(8)
    params = {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in
              (("w_ih", (24, 5)), ("w_hh", (24, 8)), ("b_ih", (24,)), ("b_hh", (24,)))}
    xs = rng.normal(size=(3, 7, 5)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(3, 8))).astype(np.float32)
    dout = rng.normal(size=(3, 7, 8)).astype(np.float32)
    cdt = torch.bfloat16 if bf16 else None
    results = []
    for run in (fused_gru.gru_sequence,
                lambda x, p, s, c: rnn_sequence(x, p, s, "gru", False, c)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (*params.values(), xs, h0)]
        out, st = run(leaves[4], dict(zip(params, leaves[:4])),
                      LSTMState(leaves[5], torch.zeros(3, 8)), cdt)
        ((out * torch.from_numpy(dout)).sum() - st.h.sum()).backward()
        results.append([out.detach()] + [a.grad for a in leaves])
    for g, w in zip(*results):
        _close(g, w, 2e-2 if bf16 else 1e-5)


def _final_states(finals, per_layer: bool) -> list:
    """Every h and c of a TorchRNN's finals: one state per layer, or a
    (forward, reverse) pair per layer."""
    dirs = [(f,) if per_layer else f for f in finals]
    return [x for pair in dirs for state in pair for x in state]


@pytest.mark.parametrize("layout", ["two_layers", "bidirectional"])
def test_torchrnn_kernel_route_matches_jax(jax_side, layout, monkeypatch):
    """TorchRNN(rnn_type='gru', use_pallas=True) runs each layer and
    direction through the GRU sequence op (its plain versions on the CPU) and
    matches JAX's (the Pallas kernels in interpret mode): outputs and every
    final state within 1e-5."""
    jax, jnp, _, jrnn_ops = jax_side
    b, t, h = 8, 6, 128
    two = layout == "two_layers"
    kw = dict(hidden_size=h, input_size=h, num_layers=2 if two else 1, bidirectional=not two,
              rnn_type="gru")
    xs = np.random.default_rng(5).normal(size=(b, t, h)).astype(np.float32)
    jm = jrnn_ops.TorchRNN(use_pallas=True, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(6), jnp.asarray(xs)))
    jout, jfin = jm.apply(params, jnp.asarray(xs))

    calls = []
    plain_fwd = fused_gru.gru_seq_fwd
    monkeypatch.setattr(fused_gru, "gru_seq_fwd", lambda *a: calls.append(1) or plain_fwd(*a))
    tm = TorchRNN(use_pallas=True, **kw)
    tm.load_state_dict(params_from_jax(params["params"]))
    with torch.no_grad():
        out, fin = tm(torch.from_numpy(xs))
    assert len(calls) == 2
    _close(out, jout, 1e-5)
    got, want = _final_states(fin, two), _final_states(jfin, two)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_torchrnn_kernel_route_equals_scan_route_with_dropout():
    """Two GRU layers with inter-layer dropout, training mode: the kernel
    route and the scan route draw the same masks from one generator seed and
    give the same outputs and gradients."""
    xs = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 5, 16)).astype(np.float32))
    results = []
    for use_pallas in (True, False):
        m = TorchRNN(16, 16, num_layers=2, rnn_type="gru", dropout=0.5, use_pallas=use_pallas)
        m.reset_parameters(torch.Generator().manual_seed(8))
        out, _ = m(xs, deterministic=False, generator=torch.Generator().manual_seed(9))
        out.square().sum().backward()
        results.append([out.detach()] + [p.grad for p in m.parameters()])
    with torch.no_grad():
        assert not torch.allclose(m(xs)[0], results[1][0])     # the masks did act
    for g, w in zip(*results):
        _close(g, w, 1e-5)


def test_wrappers_validate_inputs():
    xp, w, bhh, h0 = map(torch.from_numpy, _fwd_inputs(9, 2, 3, 8))
    with pytest.raises(ValueError, match="w_hh"):
        fused_gru.gru_seq_fwd(xp, w.T, bhh, h0, False)
    with pytest.raises(ValueError, match="b_hh"):
        fused_gru.gru_seq_fwd(xp, w, bhh[:8], h0, False)
    with pytest.raises(TypeError, match="h0"):
        fused_gru.gru_seq_fwd(xp, w, bhh, h0.double(), False)
    with pytest.raises(ValueError, match="x_proj_t"):
        fused_gru.gru_seq_fwd(xp[..., :23], w, bhh, h0, False)
    args = list(_bwd_inputs(10, False, 2, 3, 8))
    with pytest.raises(ValueError, match="hprev"):
        fused_gru.gru_seq_bwd(*args[:2], args[2][:2], *args[3:], False)
    with pytest.raises(ValueError, match="ghn"):
        fused_gru.gru_seq_bwd(args[0], args[1][..., :4], *args[2:], False)
    with pytest.raises(TypeError, match="dout"):
        fused_gru.gru_seq_bwd(*args[:4], args[4].bfloat16(), *args[5:], False)
    with pytest.raises(ValueError, match="gates"):
        fused_gru.gru_seq_bwd(args[0][..., :20], *args[1:], False)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_non_cpu_tensor_never_takes_the_plain_version(which):
    """Only CPU tensors run the plain versions: anything else reaches the
    kernel or raises (here: meta tensors, which no kernel serves)."""
    if which == "fwd":
        fn, args = fused_gru.gru_seq_fwd, [torch.from_numpy(a) for a in _fwd_inputs(11, 2, 3, 8)]
    else:
        fn, args = fused_gru.gru_seq_bwd, list(_bwd_inputs(11, False, 2, 3, 8))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*(a.to("meta") for a in args), False)
    assert fn.launches == before


def test_shapes_ok_on_cpu_serves_any_width():
    assert fused_gru.gru_seq_shapes_ok(2048) and fused_gru.gru_seq_shapes_ok(7, "cpu")


# ---------------------------------------------------------------------------
# GRU S2VT against JAX's (the fused dual kernel is LSTM-only, so both RNNs
# run through the GRU sequence op on the port's kernel route and through
# pallas_gru.py on JAX's).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gru_s2vt(jax_side):
    """(JAX S2VT class, numpy params of a GRU S2VT, feats [8, 6, 16], targets [8, 5])."""
    jax, jnp, _, _ = jax_side
    js2vt = importlib.import_module("s2vt_tpu.models").S2VT
    rng = np.random.default_rng(20)
    feats = rng.normal(size=(8, 6, 16)).astype(np.float32)
    targets = rng.integers(0, 32, size=(8, 5)).astype(np.int32)
    params = js2vt(**S2VT_KW).init(jax.random.PRNGKey(21), jnp.asarray(feats),
                                   jnp.asarray(targets), mode="train", deterministic=True)
    return js2vt, jax.tree_util.tree_map(np.array, params["params"]), feats, targets


def _port_s2vt(params, **kw):
    from s2vt_tpu_torch.models import S2VT
    m = S2VT(**{**S2VT_KW, **kw})
    m.load_state_dict(params_from_jax(params))
    return m.eval()


def _counting_fwd(monkeypatch):
    calls = []
    plain = fused_gru.gru_seq_fwd
    monkeypatch.setattr(fused_gru, "gru_seq_fwd", lambda *a: calls.append(a[0].shape[0])
                        or plain(*a))
    return calls


def test_gru_s2vt_teacher_forced_logits_match_jax(jax_side, gru_s2vt, monkeypatch):
    """Logits within 1e-4 (tests/test_pallas_gru.py:118); both RNNs run the
    sequence op over T = 2L - 1 steps."""
    _, jnp, _, _ = jax_side
    js2vt, params, feats, targets = gru_s2vt
    want = js2vt(use_pallas=True, **S2VT_KW).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(targets), mode="train",
        deterministic=True)
    calls = _counting_fwd(monkeypatch)
    model = _port_s2vt(params, use_pallas=True)
    assert not model._fused_ok()
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(targets).long(), mode="train")
    assert calls == [11, 11]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_gru_s2vt_gradients_match_jax(jax_side, gru_s2vt):
    """Every parameter's and the features' gradient of sum(logits^2) * 1e-3
    against jax.grad of JAX's kernel route (Pallas backward in interpret
    mode), at 2e-3 (tests/test_pallas_s2vt.py:122)."""
    jax, jnp, _, _ = jax_side
    from s2vt_tpu_torch.utils.weights import flatten_params
    js2vt, params, feats, targets = gru_s2vt

    def loss(p, f):
        logits = js2vt(use_pallas=True, **S2VT_KW).apply(
            {"params": p}, f, jnp.asarray(targets), mode="train", deterministic=True)
        return jnp.sum(logits ** 2) * 1e-3

    jp, jf = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
    model = _port_s2vt(params, use_pallas=True)
    f = torch.from_numpy(feats).requires_grad_()
    logits = model(f, torch.from_numpy(targets).long(), mode="train", deterministic=True)
    ((logits ** 2).sum() * 1e-3).backward()
    got = {k.replace(".", "//"): p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jf), atol=2e-3, rtol=2e-3)


def test_gru_s2vt_greedy_tokens_match_jax(jax_side, gru_s2vt, monkeypatch):
    """Greedy tokens exact (tests/test_pallas_gru.py:122): vid_rnn over
    2L - 1 steps and word_rnn's encode over L through the sequence op, then
    the GRU decode steps with the untouched c."""
    _, jnp, _, _ = jax_side
    js2vt, params, feats, _ = gru_s2vt
    want = np.asarray(js2vt(use_pallas=True, **S2VT_KW).apply(
        {"params": params}, jnp.asarray(feats), mode="test"))
    calls = _counting_fwd(monkeypatch)
    got = _port_s2vt(params, use_pallas=True)(torch.from_numpy(feats), mode="test")
    assert calls == [11, 6]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("score_mode", ["cumulative", "reference"])
def test_gru_s2vt_beam_matches_jax(jax_side, gru_s2vt, score_mode, monkeypatch):
    """Beam tokens and lengths exact, scores within 1e-5; the encode runs
    the sequence op once per RNN over the raw L steps."""
    _, jnp, _, _ = jax_side
    js2vt, params, feats, _ = gru_s2vt
    kw = dict(beam_width=3, max_beam_depth=8, beam_score_mode=score_mode)
    want = js2vt(use_pallas=True, **S2VT_KW).apply(
        {"params": params}, jnp.asarray(feats), mode="beam_search", **kw)
    calls = _counting_fwd(monkeypatch)
    got = _port_s2vt(params, use_pallas=True)(torch.from_numpy(feats), mode="beam_search", **kw)
    assert calls == [6, 6]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernels_match_plain_on_card(dtype):
    """Both CUDA kernels against their plain versions on the card: tiny, the
    MSVD width at the beam encode's and training's lengths with small and
    large batches, the S2VT paper's 1000 hidden units (8 units per block in
    both kernels) and a width that is not a multiple of 4 (single-float
    loads). Bounds as in chip_smoke.py: 1e-4 in float32, 1.5e-3 in bf16
    (every value is stored float32, so only a flipped bf16 rounding of a
    product operand shows)."""
    _card()
    bf16 = dtype == "bf16"
    atol = 1.5e-3 if bf16 else 1e-4
    for b, t, h in ((1, 6, 8), (16, 80, 512), (200, 159, 512), (16, 20, 1000), (5, 7, 130)):
        fargs = [torch.from_numpy(a).cuda() for a in _fwd_inputs(12, b, t, h)]
        bargs = _bwd_inputs(12, bf16, b, t, h, device="cuda")
        for fn, ref, args in ((fused_gru.gru_seq_fwd, fused_gru.gru_seq_fwd_reference, fargs),
                              (fused_gru.gru_seq_bwd, fused_gru.gru_seq_bwd_reference, bargs)):
            before = fn.launches
            got = fn(*args, bf16)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            for g, w in zip(got, ref(*args, bf16)):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert (g - w).abs().max().item() <= atol, (fn.__name__, b, t, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stream_route_matches_plain_on_card(dtype):
    """The stream route of both kernels (one launch per step, W_hh read from
    global memory) against their plain versions on the card: asked for by
    name at widths the resident routes serve (the MSVD width; a width and a
    batch that leave a block's units and rows part empty), and taken by the
    ops themselves at widths whose weights do not fit shared memory (2048;
    at 1100 the backward's, whose direct route would need more blocks than
    the card has SMs). Bounds as test_kernels_match_plain_on_card."""
    _card()
    bf16 = dtype == "bf16"
    atol = 1.5e-3 if bf16 else 1e-4
    for b, t, h in ((16, 20, 512), (37, 5, 130), (3, 4, 1100), (16, 12, 2048)):
        assert fused_gru.gru_seq_shapes_ok(h, "cuda") == (h < 1100)
        card = fused_gru._build.card("cuda")
        fargs = [torch.from_numpy(a).cuda() for a in _fwd_inputs(12, b, t, h)]
        bargs = _bwd_inputs(12, bf16, b, t, h, device="cuda")
        for fn, launch, ref, args, fits in (
                (fused_gru.gru_seq_fwd, fused_gru.launch_fwd, fused_gru.gru_seq_fwd_reference, fargs,
                 fused_gru.fwd_direct_fits),
                (fused_gru.gru_seq_bwd, fused_gru.launch_bwd, fused_gru.gru_seq_bwd_reference, bargs,
                 fused_gru.bwd_direct_fits)):
            forced = fits(h, card)
            before = fn.route_launches["stream"]
            got = launch(*args, bf16, "stream") if forced else fn(*args, bf16)
            torch.cuda.synchronize()
            assert fn.route_launches["stream"] == before + 1
            for g, w in zip(got, ref(*args, bf16)):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert (g - w).abs().max().item() <= atol, (fn.__name__, b, t, h)


@pytest.mark.cuda
def test_torchrnn_on_card_streams_where_the_weights_do_not_fit():
    """A width whose weights do not fit the resident routes' shared memory
    (2048) still runs the GRU sequence kernels on the card, on their stream
    route, as the JAX module runs its Pallas kernels at that width: one
    launch of each kernel, outputs and gradients within the card bounds of
    the CPU (plain) module's on the same weights."""
    _card()
    assert fused_gru.gru_seq_shapes_ok(1000, "cuda")
    assert not fused_gru.gru_seq_shapes_ok(2048, "cuda")
    m = TorchRNN(2048, 8, rnn_type="gru", use_pallas=True)
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 8)).astype(np.float32))
    before = [dict(f.route_launches) for f in (fused_gru.gru_seq_fwd, fused_gru.gru_seq_bwd)]
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(2048, 8, rnn_type="gru", use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    torch.cuda.synchronize()
    for f, was in zip((fused_gru.gru_seq_fwd, fused_gru.gru_seq_bwd), before):
        assert f.route_launches == {**was, "stream": was["stream"] + 1}
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.cuda
def test_two_layer_torchrnn_on_card_launches_the_kernels():
    """A 2-layer GRU TorchRNN forward and backward on the card: two forward
    and two backward launches, and the CPU (plain) route's outputs and
    gradients."""
    _card()
    xs = torch.from_numpy(np.random.default_rng(13).normal(size=(8, 6, 128)).astype(np.float32))
    m = TorchRNN(128, 128, num_layers=2, rnn_type="gru", use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(14))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(128, 128, num_layers=2, rnn_type="gru", use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = (fused_gru.gru_seq_fwd.launches, fused_gru.gru_seq_bwd.launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (fused_gru.gru_seq_fwd.launches, fused_gru.gru_seq_bwd.launches) == \
                (before[0] + 2, before[1] + 2)
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_gru_s2vt_decode_on_card_goes_through_the_kernel():
    """GRU S2VT.greedy and .beam on the card launch the forward sequence
    kernel twice per request each (vid_rnn and word_rnn) and give the CPU
    (plain) route's tokens."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    model = S2VT(**{**S2VT_KW, "use_pallas": True})
    model.reset_parameters(torch.Generator().manual_seed(16))
    feats = torch.from_numpy(np.random.default_rng(17).normal(size=(8, 6, 16)).astype(np.float32))
    want_greedy = model.eval().greedy(feats)
    want_beam = model.beam(feats, 3, 8)
    model = model.cuda()
    before = fused_gru.gru_seq_fwd.launches
    got_greedy = model.greedy(feats.cuda())
    assert fused_gru.gru_seq_fwd.launches == before + 2
    got_beam = model.beam(feats.cuda(), 3, 8)
    assert fused_gru.gru_seq_fwd.launches == before + 4
    np.testing.assert_array_equal(got_greedy.cpu().numpy(), want_greedy.numpy())
    np.testing.assert_array_equal(got_beam.tokens.cpu().numpy(), want_beam.tokens.numpy())
    np.testing.assert_array_equal(got_beam.lengths.cpu().numpy(), want_beam.lengths.numpy())
    np.testing.assert_allclose(got_beam.scores.cpu().numpy(), want_beam.scores.numpy(), atol=1e-4)
