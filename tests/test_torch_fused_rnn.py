"""The port's per-layer LSTM sequence op against s2vt_tpu/ops/pallas_rnn.py.

On the CPU the port runs the plain versions of its kernels and JAX runs the
Pallas kernels in interpret mode (as tests/test_pallas_rnn.py does), on the
same numpy inputs, at B=8, H=128 so that JAX's ``pallas_shapes_ok`` routes
``TorchRNN`` to its kernel too. Tolerances: plain versions against
``_run_forward`` / ``_run_backward`` 1e-5 in float32 (the same products,
summed in another order) and 2e-2 in bf16 (one bf16 ulp of a product
operand); gradients of ``lstm_sequence`` against ``jax.grad`` of
``lstm_sequence_pallas`` atol and rtol 1e-4 (tests/test_pallas_rnn.py:62);
``TorchRNN`` outputs and finals 1e-5 (tests/test_pallas_rnn.py:100-112).

The JAX side is imported by a fixture, so that the card tests also collect
where the JAX package cannot be imported. The kernels themselves need a
card: the ``cuda``-marked tests skip elsewhere.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_rnn
from s2vt_tpu_torch.ops.rnn import LSTMState, TorchRNN, rnn_sequence
from s2vt_tpu_torch.utils.weights import params_from_jax

B, T, H = 8, 6, 128
ATOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy, s2vt_tpu.ops.pallas_rnn, s2vt_tpu.ops.rnn)."""
    return tuple(importlib.import_module(n) for n in
                 ("jax", "jax.numpy", "s2vt_tpu.ops.pallas_rnn", "s2vt_tpu.ops.rnn"))


def _fwd_inputs(seed, b=B, t=T, h=H, zero_init=False):
    """(x_proj_t [T, B, 4H], w_hh [4H, H], h0, c0 [B, H]) as float32 numpy."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    xp = rng.normal(size=(t, b, 4 * h)).astype(np.float32)
    w = np.ascontiguousarray(rng.uniform(-k, k, (h, 4 * h)).astype(np.float32).T)
    h0, c0 = (np.zeros((b, h), np.float32) if zero_init else
              (0.5 * rng.normal(size=(b, h))).astype(np.float32) for _ in range(2))
    return xp, w, h0, c0


def _bwd_inputs(seed, bf16, b=B, t=T, h=H, device="cpu"):
    """(gates, cseq, cprev, w_hh, dout, dhT, dcT) from a forward run of the
    plain version, so that the gates and c are real LSTM states."""
    xp, w, h0, c0 = (torch.from_numpy(a).to(device) for a in _fwd_inputs(seed, b, t, h))
    _, gates, cseq, _, _ = fused_rnn.lstm_seq_fwd_reference(xp, w, h0, c0, bf16)
    cprev = torch.cat([c0[None], cseq[:-1]])
    rng = np.random.default_rng(seed + 100)
    dout, dhT, dcT = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
                      for s in ((t, b, h), (b, h), (b, h)))
    return gates, cseq, cprev, w, dout, dhT, dcT


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_reference_matches_jax_run_forward(jax_side, dtype, zero_init):
    _, jnp, jrnn, _ = jax_side
    bf16 = dtype == "bf16"
    args = _fwd_inputs(0, zero_init=zero_init)
    xp, w, h0, c0 = map(jnp.asarray, args)
    want = jrnn._run_forward(xp, w.T, h0, c0, compute_bf16=bf16)     # JAX takes W_hh^T
    got = fused_rnn.lstm_seq_fwd(*map(torch.from_numpy, args), bf16)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        _close(g, w, ATOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_reference_matches_jax_run_backward(jax_side, dtype):
    _, jnp, jrnn, _ = jax_side
    bf16 = dtype == "bf16"
    args = _bwd_inputs(1, bf16)
    want = jrnn._run_backward(*(jnp.asarray(a.numpy()) for a in args), compute_bf16=bf16)
    got = fused_rnn.lstm_seq_bwd(*args, bf16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        _close(g, w, ATOL[dtype])


def _jax_lstm_params(jax_side, seed, in_size, h):
    jax, _, _, jrnn_ops = jax_side
    return jax.tree_util.tree_map(
        np.array, jrnn_ops.init_lstm_params(jax.random.PRNGKey(seed), in_size, h))


@pytest.mark.parametrize("with_h0", [False, True])
def test_lstm_sequence_matches_jax_forward_and_gradients(jax_side, with_h0):
    """Outputs and finals within 1e-5; gradients of one loss in the weights,
    the inputs and (given) the initial state within atol/rtol 1e-4."""
    jax, jnp, jrnn, jrnn_ops = jax_side
    n_in = 20
    params = _jax_lstm_params(jax_side, 2, n_in, H)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(B, T, n_in)).astype(np.float32)
    tgt = rng.normal(size=(B, T, H)).astype(np.float32)
    h0 = tuple((0.3 * rng.normal(size=(B, H))).astype(np.float32) for _ in range(2))

    def jloss(p, x, hc):
        init = jrnn_ops.LSTMState(*hc) if with_h0 else None
        out, st = jrnn.lstm_sequence_pallas(x, p, init)
        return jnp.sum((out - tgt) ** 2) + jnp.sum(st.h) + 0.5 * jnp.sum(st.c), (out, st)

    (_, (jout, jst)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(xs), tuple(map(jnp.asarray, h0)))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(xs).requires_grad_()
    th0 = [torch.from_numpy(a).requires_grad_() for a in h0]
    out, st = fused_rnn.lstm_sequence(tx, tp, LSTMState(*th0) if with_h0 else None)
    _close(out.detach(), jout, 1e-5)
    _close(st.h.detach(), jst.h, 1e-5)
    _close(st.c.detach(), jst.c, 1e-5)
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum() + st.h.sum() + 0.5 * st.c.sum()
    loss.backward()
    for k in params:
        _close(tp[k].grad, jgrads[0][k], 1e-4, 1e-4)
    _close(tx.grad, jgrads[1], 1e-4, 1e-4)
    if with_h0:
        for a, w in zip(th0, jgrads[2]):
            _close(a.grad, w, 1e-4, 1e-4)


def test_lstm_sequence_gradients_match_torch_autograd_of_the_scan():
    """An independent check of the hand-written backward: torch autograd
    through the op-by-op scan gives the same gradients."""
    rng = np.random.default_rng(4)
    k = 1.0 / np.sqrt(8)
    params = {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in
              (("w_ih", (32, 5)), ("w_hh", (32, 8)), ("b_ih", (32,)), ("b_hh", (32,)))}
    xs = rng.normal(size=(3, 7, 5)).astype(np.float32)
    h0 = [(0.5 * rng.normal(size=(3, 8))).astype(np.float32) for _ in range(2)]
    dout = rng.normal(size=(3, 7, 8)).astype(np.float32)
    grads = []
    for run in (fused_rnn.lstm_sequence, rnn_sequence):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (*params.values(), xs, *h0)]
        out, st = run(leaves[4], dict(zip(params, leaves[:4])), LSTMState(*leaves[5:]))
        ((out * torch.from_numpy(dout)).sum() + st.h.sum() - st.c.sum()).backward()
        grads.append([a.grad for a in leaves])
    for g, w in zip(*grads):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("layout", ["two_layers", "bidirectional"])
def test_torchrnn_kernel_route_matches_jax(jax_side, layout, monkeypatch):
    """TorchRNN(use_pallas=True) runs each layer and direction through the
    sequence op (its plain versions on the CPU) and matches JAX's
    TorchRNN(use_pallas=True) (the Pallas kernels in interpret mode):
    outputs and every final state within 1e-5."""
    jax, jnp, _, jrnn_ops = jax_side
    two = layout == "two_layers"
    kw = dict(hidden_size=H, input_size=H, num_layers=2 if two else 1, bidirectional=not two)
    xs = np.random.default_rng(5).normal(size=(B, T, H)).astype(np.float32)
    jm = jrnn_ops.TorchRNN(use_pallas=True, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(6), jnp.asarray(xs)))
    jout, jfin = jm.apply(params, jnp.asarray(xs))

    calls = []
    plain_fwd = fused_rnn.lstm_seq_fwd
    monkeypatch.setattr(fused_rnn, "lstm_seq_fwd", lambda *a: calls.append(1) or plain_fwd(*a))
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


def _final_states(finals, per_layer: bool) -> list:
    """Every h and c of a TorchRNN's finals: one state per layer, or a
    (forward, reverse) pair per layer."""
    dirs = [(f,) if per_layer else f for f in finals]
    return [x for pair in dirs for state in pair for x in state]


def test_torchrnn_kernel_route_equals_scan_route_with_dropout():
    """Two layers with inter-layer dropout, training mode: the kernel route
    and the scan route draw the same masks from one generator seed and give
    the same outputs and gradients."""
    xs = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 5, 16)).astype(np.float32))
    results = []
    for use_pallas in (True, False):
        m = TorchRNN(16, 16, num_layers=2, dropout=0.5, use_pallas=use_pallas)
        m.reset_parameters(torch.Generator().manual_seed(8))
        out, _ = m(xs, deterministic=False, generator=torch.Generator().manual_seed(9))
        out.square().sum().backward()
        results.append([out.detach()] + [p.grad for p in m.parameters()])
    with torch.no_grad():
        assert not torch.allclose(m(xs)[0], results[1][0])     # the masks did act
    for g, w in zip(*results):
        _close(g, w, 1e-5)


def test_gru_takes_the_gru_sequence_op_on_cpu_and_shapes_ok_on_cpu(monkeypatch):
    from s2vt_tpu_torch.ops import fused_gru
    assert fused_rnn.lstm_seq_shapes_ok(100) and fused_rnn.lstm_seq_shapes_ok(6, "cpu")
    calls = []
    plain = fused_gru.gru_seq_fwd
    monkeypatch.setattr(fused_gru, "gru_seq_fwd", lambda *a: calls.append(1) or plain(*a))
    m = TorchRNN(8, 4, rnn_type="gru", use_pallas=True)
    out, fin = m(torch.zeros(2, 3, 4))
    assert tuple(out.shape) == (2, 3, 8) and tuple(fin[0].h.shape) == (2, 8)
    assert len(calls) == 1


def test_wrappers_validate_inputs():
    xp, w, h0, c0 = map(torch.from_numpy, _fwd_inputs(9, b=2, t=3, h=8))
    with pytest.raises(ValueError, match="w_hh"):
        fused_rnn.lstm_seq_fwd(xp, w.T, h0, c0, False)
    with pytest.raises(TypeError, match="h0"):
        fused_rnn.lstm_seq_fwd(xp, w, h0.double(), c0, False)
    with pytest.raises(ValueError, match="x_proj_t"):
        fused_rnn.lstm_seq_fwd(xp[..., :30], w, h0, c0, False)
    args = list(_bwd_inputs(10, False, b=2, t=3, h=8))
    with pytest.raises(ValueError, match="cprev"):
        fused_rnn.lstm_seq_bwd(*args[:2], args[2][:2], *args[3:], False)
    with pytest.raises(TypeError, match="dout"):
        fused_rnn.lstm_seq_bwd(*args[:4], args[4].bfloat16(), *args[5:], False)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_non_cpu_tensor_never_takes_the_plain_version(which):
    """Only CPU tensors run the plain versions: anything else reaches the
    kernel or raises (here: meta tensors, which no kernel serves)."""
    if which == "fwd":
        fn, args = fused_rnn.lstm_seq_fwd, [torch.from_numpy(a) for a in
                                            _fwd_inputs(11, b=2, t=3, h=8)]
    else:
        fn, args = fused_rnn.lstm_seq_bwd, list(_bwd_inputs(11, False, b=2, t=3, h=8))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*(a.to("meta") for a in args), False)
    assert fn.launches == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernels_match_plain_on_card(dtype):
    """Both CUDA kernels against their plain versions on the card, at the
    test width and at the MSVD width, for small and large batches and both
    sequence lengths of the main paths; at the S2VT paper's 1000 hidden units
    (8 units per block in both kernels) and at a width that is not a multiple
    of 4. Bounds as in chip_smoke.py: 1e-4 in float32, 1.5e-3 in bf16 (every
    value is stored float32, so only a flipped bf16 rounding of a product
    operand shows; a value stored in bf16 would be off by ~4e-3)."""
    _card()
    bf16 = dtype == "bf16"
    atol = 1.5e-3 if bf16 else 1e-4
    for b, t, h in ((1, T, H), (B, T, H), (16, 80, 512), (200, 159, 512), (16, 20, 1000),
                    (5, 7, 130)):
        fargs = [torch.from_numpy(a).cuda() for a in _fwd_inputs(12, b, t, h)]
        bargs = _bwd_inputs(12, bf16, b, t, h, device="cuda")
        for fn, ref, args in ((fused_rnn.lstm_seq_fwd, fused_rnn.lstm_seq_fwd_reference, fargs),
                              (fused_rnn.lstm_seq_bwd, fused_rnn.lstm_seq_bwd_reference, bargs)):
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
        assert fused_rnn.lstm_seq_shapes_ok(h, "cuda") == (h < 1100)
        card = fused_rnn._build.card("cuda")
        fargs = [torch.from_numpy(a).cuda() for a in _fwd_inputs(12, b, t, h)]
        bargs = _bwd_inputs(12, bf16, b, t, h, device="cuda")
        for fn, launch, ref, args, fits in (
                (fused_rnn.lstm_seq_fwd, fused_rnn.launch_fwd, fused_rnn.lstm_seq_fwd_reference, fargs,
                 fused_rnn.fwd_direct_fits),
                (fused_rnn.lstm_seq_bwd, fused_rnn.launch_bwd, fused_rnn.lstm_seq_bwd_reference, bargs,
                 fused_rnn.bwd_direct_fits)):
            forced = fits(h, card)
            before = fn.route_launches["stream"]
            got = launch(*args, bf16, "stream") if forced else fn(*args, bf16)
            torch.cuda.synchronize()
            assert fn.route_launches["stream"] == before + 1
            if forced and fn is fused_rnn.lstm_seq_fwd:
                got = got[:3] + (got[3][0], got[3][1])
            for g, w in zip(got, ref(*args, bf16)):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert (g - w).abs().max().item() <= atol, (fn.__name__, b, t, h)


@pytest.mark.cuda
def test_torchrnn_on_card_streams_where_the_weights_do_not_fit():
    """A width whose weights do not fit the resident routes' shared memory
    (2048) still runs the LSTM sequence kernels on the card, on their stream
    route, as the JAX module runs its Pallas kernels at that width: one
    launch of each kernel, outputs and gradients within the card bounds of
    the CPU (plain) module's on the same weights."""
    _card()
    assert fused_rnn.lstm_seq_shapes_ok(1000, "cuda")
    assert not fused_rnn.lstm_seq_shapes_ok(2048, "cuda")
    m = TorchRNN(2048, 8, use_pallas=True)
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 8)).astype(np.float32))
    before = [dict(f.route_launches) for f in (fused_rnn.lstm_seq_fwd, fused_rnn.lstm_seq_bwd)]
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(2048, 8, use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    torch.cuda.synchronize()
    for f, was in zip((fused_rnn.lstm_seq_fwd, fused_rnn.lstm_seq_bwd), before):
        assert f.route_launches == {**was, "stream": was["stream"] + 1}
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.cuda
def test_two_layer_torchrnn_on_card_launches_the_kernels():
    """A 2-layer TorchRNN forward and backward on the card: two forward and
    two backward launches, and the CPU (plain) route's outputs and gradients."""
    _card()
    xs = torch.from_numpy(np.random.default_rng(13).normal(size=(B, T, H)).astype(np.float32))
    m = TorchRNN(H, H, num_layers=2, use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(14))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(H, H, num_layers=2, use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = (fused_rnn.lstm_seq_fwd.launches, fused_rnn.lstm_seq_bwd.launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (fused_rnn.lstm_seq_fwd.launches, fused_rnn.lstm_seq_bwd.launches) == \
                (before[0] + 2, before[1] + 2)
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_beam_on_card_goes_through_the_kernel():
    """S2VT.beam on the card launches the forward sequence kernel twice per
    request (vid_rnn and word_rnn over the raw L steps) and gives the CPU
    (plain) route's beams."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    model = S2VT(vocab_size=32, feat_dim=16, length=T, dim_hid=H, dim_embed=H, use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(16))
    feats = torch.from_numpy(np.random.default_rng(17).normal(size=(B, T, 16)).astype(np.float32))
    want = model.eval().beam(feats, 3, 8)
    before = fused_rnn.lstm_seq_fwd.launches
    got = model.cuda().beam(feats.cuda(), 3, 8)
    assert fused_rnn.lstm_seq_fwd.launches == before + 2
    np.testing.assert_array_equal(got.tokens.cpu().numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.cpu().numpy(), want.lengths.numpy())
    np.testing.assert_allclose(got.scores.cpu().numpy(), want.scores.numpy(), atol=1e-4)
