"""The port's greedy-step out-projection and argmax (ops/fused_decode.py)
against s2vt_tpu's ops/pallas_decode.py, and the greedy decodes that run it.

On the CPU ``argmax_linear`` runs its plain version and JAX runs the Pallas
kernel in interpret mode (as tests/test_pallas_decode.py does), on the same
numpy inputs. Tokens must be equal exactly, ties included: integer-valued h
and W make every logit exact in float32 and bf16, so both sides see the
same ties and the lowest index must win, within a vocab block and across
blocks. Greedy decodes with the op wired in (``use_pallas``) give JAX's
greedy tokens exactly on carried weights.

The JAX side is imported by fixtures, so that the card tests also collect
where the JAX package cannot be imported; the ``cuda``-marked tests skip
without a card.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_decode
from s2vt_tpu_torch.utils.weights import params_from_jax


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy, s2vt_tpu.ops.pallas_decode, s2vt_tpu.ops.layers)."""
    return tuple(importlib.import_module(n) for n in
                 ("jax", "jax.numpy", "s2vt_tpu.ops.pallas_decode", "s2vt_tpu.ops.layers"))


def _inputs(seed, b, h, v, integer=False):
    rng = np.random.default_rng(seed)
    if integer:    # exact logits: ties are ties on both sides, in f32 and bf16
        return (rng.integers(-3, 4, (b, h)).astype(np.float32),
                rng.integers(-2, 3, (v, h)).astype(np.float32),
                rng.integers(-2, 3, v).astype(np.float32))
    return (rng.normal(size=(b, h)).astype(np.float32),
            (rng.normal(size=(v, h)) * 0.1).astype(np.float32),
            rng.normal(size=v).astype(np.float32))


def _port(h, w, b, valid, bf16):
    return fused_decode.argmax_linear(*(torch.from_numpy(a) for a in (h, w, b)), valid,
                                      bf16).numpy()


# (B, H, V): the TPU test's shape (2 vocab blocks of 1024 there), and the MSVD
# vocab at a narrow width (10 blocks).
@pytest.mark.parametrize("bhv", [(8, 128, 2048), (8, 128, 10240)])
@pytest.mark.parametrize("valid_off", [None, 100])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_version_matches_jax_kernel_and_jnp_path(jax_side, bhv, valid_off, bf16):
    jax, jnp, jdec, jlayers = jax_side
    B, H, V = bhv
    h, w, b = _inputs(0, B, H, V)
    valid = None if valid_off is None else V - valid_off
    cdt = jnp.bfloat16 if bf16 else None
    got = _port(h, w, b, valid, bf16)
    kernel = np.asarray(jdec.argmax_linear(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                           valid, cdt))
    logits = jlayers.mask_invalid_vocab(jlayers.apply_linear(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), cdt), valid)
    jnp_path = np.asarray(jnp.argmax(logits, axis=-1))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, jnp_path)
    assert got.dtype == np.int64 and (valid is None or got.max() < valid)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ties_break_to_the_lowest_index_within_and_across_blocks(jax_side, bf16):
    """Integer inputs with many exact ties, and one winning column planted
    in vocab block 0, again later in block 0 and in block 1 (the TPU
    kernel's blocks of 1024 here): every side picks the lowest index."""
    jax, jnp, jdec, _ = jax_side
    B, H, V = 8, 128, 2048
    h, w, b = _inputs(1, B, H, V, integer=True)
    for col in (37, 600, 1024 + 512):      # equal columns that beat every other one
        w[col] = 1.0
        b[col] = 5000.0
    got = _port(h, w, b, None, bf16)
    want = np.asarray(jdec.argmax_linear(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), None,
                                         jnp.bfloat16 if bf16 else None))
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {37}
    # many exact ties without a planted column
    h2, w2, b2 = _inputs(2, B, 4, 300, integer=True)
    got2 = _port(h2, w2, b2, 250, bf16)
    logits = h2 @ w2.T + b2
    logits[:, 250:] = -1e30
    np.testing.assert_array_equal(got2, logits.argmax(axis=1))


def test_gate_is_the_ports_own():
    """On the CPU every shape is served (the TPU gate's B % 8, H % 128 and
    128-multiple vocab blocks do not carry over); empty shapes are not."""
    assert fused_decode.argmax_linear_ok(7, 100, 2000, "cpu")
    assert fused_decode.argmax_linear_ok(4096, 512, 10240)
    assert not fused_decode.argmax_linear_ok(8, 0, 2048)
    assert not fused_decode.argmax_linear_ok(8, 128, 0)


def test_argmax_linear_is_an_operator_with_shapes_for_export():
    """The op is registered with torch.library and has a fake
    implementation, so torch.export holds it as one node."""
    op = torch.ops.s2vt_tpu_torch.argmax_linear.default
    h, w, b = (torch.from_numpy(a) for a in _inputs(3, 5, 16, 40))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        out = op(mode.from_tensor(h), mode.from_tensor(w), mode.from_tensor(b), 30, False)
    assert tuple(out.shape) == (5,) and out.dtype == torch.int64


def test_greedy_pick_raises_where_the_gate_refuses(monkeypatch):
    """With use_pallas a width the gate refuses raises rather than running
    the plain picker (on a card that would bypass the kernel); without
    use_pallas the plain picker serves and the op is never called."""
    h, w, b = (torch.from_numpy(a) for a in _inputs(11, 6, 16, 40))
    calls = []
    plain = fused_decode.argmax_linear
    monkeypatch.setattr(fused_decode, "argmax_linear", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(fused_decode, "argmax_linear_ok", lambda *a: False)
    with pytest.raises(NotImplementedError, match="hidden size 16"):
        fused_decode.greedy_pick(w, b, 30, None, True)
    got = fused_decode.greedy_pick(w, b, 30, None, False)(h)
    assert torch.equal(got, fused_decode.argmax_linear_reference(h, w, b, 30))
    assert calls == []


# ---------------------------------------------------------------------------
# Greedy decodes with the op wired in, against JAX's greedy on carried weights
# ---------------------------------------------------------------------------

S2VT_KW = dict(vocab_size=40, feat_dim=12, length=6, dim_hid=16, dim_embed=16, sos_ix=3,
               eos_ix=4)


@pytest.mark.parametrize("cfg", [dict(), dict(num_layers=2), dict(rnn_type="gru"),
                                 dict(valid_vocab=33), dict(compute="bf16")],
                         ids=["lstm1", "lstm2", "gru", "padded_vocab", "bf16"])
def test_s2vt_greedy_with_the_op_matches_jax(jax_side, cfg, monkeypatch):
    jax, jnp = jax_side[:2]
    from s2vt_tpu.models import S2VT as JS2VT
    from s2vt_tpu_torch.models import S2VT as TS2VT
    cfg = dict(cfg)
    bf16 = cfg.pop("compute", None) == "bf16"
    kw = {**S2VT_KW, **cfg}
    feats = np.random.default_rng(4).normal(size=(5, 6, 12)).astype(np.float32)
    jmodel = JS2VT(**kw, compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(feats), mode="test")["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats), mode="test"))
    model = TS2VT(**kw, use_pallas=True, compute_dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    plain = fused_decode.argmax_linear
    monkeypatch.setattr(fused_decode, "argmax_linear", lambda *a: calls.append(1) or plain(*a))
    got = model.eval().greedy(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(calls) == kw["length"] - 1           # one launch per decode step


def test_attention_greedy_with_the_op_matches_jax(jax_side, monkeypatch):
    jax, jnp = jax_side[:2]
    from s2vt_tpu.models import AttBaseline as JAtt
    from s2vt_tpu_torch.models import AttBaseline as TAtt
    kw = dict(vocab_size=40, dim_feat=12, length=6, dim_hid=16, dim_embed=16, sos_ix=3,
              eos_ix=4)
    feats = np.random.default_rng(6).normal(size=(4, 6, 12)).astype(np.float32)
    jmodel = JAtt(**kw)
    params = jmodel.init(jax.random.PRNGKey(7), jnp.asarray(feats), mode="test")["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats), mode="test"))
    model = TAtt(**kw, use_pallas=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    plain = fused_decode.argmax_linear
    monkeypatch.setattr(fused_decode, "argmax_linear", lambda *a: calls.append(1) or plain(*a))
    got = model.eval().greedy(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(calls) == kw["length"]               # L steps from <sos>


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(bf16):
    """The CUDA kernel against its plain version on the card: one and many
    row tiles (16- and 32-row variants), the MSVD width and vocab and a vocab
    that is not a multiple of the 64-column tile, a padded vocab, and
    integer inputs full of exact ties (where every row must agree). Random
    rows may differ only where the top two logits (float64) are within 1e-5
    relative."""
    _card()
    for b, h, v, valid, integer in ((1, 8, 40, None, False), (16, 512, 10240, 10000, False),
                                    (96, 512, 10240, None, False), (200, 512, 10001, 9000, False),
                                    (33, 130, 777, None, False), (40, 64, 3000, 2500, True)):
        args = [torch.from_numpy(a).cuda() for a in _inputs(8, b, h, v, integer)]
        before = fused_decode.argmax_linear.launches
        got = fused_decode.argmax_linear(*args, valid, bf16)
        torch.cuda.synchronize()
        assert fused_decode.argmax_linear.launches == before + 1
        want = fused_decode.argmax_linear_reference(*args, valid, bf16)
        diff = (got != want).cpu().numpy()
        if integer:
            assert not diff.any(), (b, h, v)
            continue
        hh, ww, bb = (a.double() for a in args)
        if bf16:
            hh, ww = hh.to(torch.bfloat16).double(), ww.to(torch.bfloat16).double()
        logits = (hh @ ww.T + bb)
        if valid is not None:
            logits[:, valid:] = -1e30
        top2 = logits.topk(2, dim=1).values.cpu().numpy()
        near = (top2[:, 0] - top2[:, 1]) <= 1e-5 * np.abs(top2[:, 0])
        assert not (diff & ~near).any(), (b, h, v, np.nonzero(diff)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_both_routes_serve_wide_rows_on_card(bf16):
    """Widths past one 1792-value chunk of h (the direct route stages h in
    chunks of k; the mma route's shared memory does not grow with H): the
    gate serves them, and each route matches the plain version, exactly on
    integer inputs full of ties and up to near-ties (top two within 1e-5
    relative) on random ones; a 2048-wide S2VT's decode shape among them."""
    _card()
    for b, h, v, integer in ((16, 2048, 10240, False), (40, 1800, 3000, False),
                             (5, 4000, 777, False), (33, 2050, 2500, True)):
        assert fused_decode.argmax_linear_ok(b, h, v, "cuda")
        args = [torch.from_numpy(a).cuda() for a in _inputs(8, b, h, v, integer)]
        want = fused_decode.argmax_linear_reference(*args, None, bf16)
        hh, ww, bb = (a.double() for a in args)
        if bf16:
            hh, ww = hh.to(torch.bfloat16).double(), ww.to(torch.bfloat16).double()
        top2 = (hh @ ww.T + bb).topk(2, dim=1).values.cpu().numpy()
        near = (top2[:, 0] - top2[:, 1]) <= 1e-5 * np.abs(top2[:, 0])
        for route in ("direct", "mma"):
            w = args[1].to(torch.bfloat16) if bf16 and route == "mma" else args[1]
            if route == "mma" and fused_decode.argmax_linear_route(
                    h, w.dtype, bf16, (args[0].data_ptr(), w.data_ptr())) != "mma":
                continue
            got = fused_decode._launch(args[0], w, args[2], None, bf16, route)
            torch.cuda.synchronize()
            diff = (got != want).cpu().numpy()
            assert not (diff & ~(near & (not integer))).any(), (route, b, h, v)


@pytest.mark.cuda
def test_greedy_on_card_launches_the_kernel_once_per_step():
    """S2VT.greedy with use_pallas on the card: the fused forward once and
    the argmax kernel once per decode step, the CPU (plain) route's tokens."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    from s2vt_tpu_torch.ops import fused_s2vt
    model = S2VT(**{**S2VT_KW, "dim_hid": 128, "dim_embed": 128}, use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(9))
    feats = torch.from_numpy(np.random.default_rng(10).normal(size=(8, 6, 12)).astype(np.float32))
    want = model.eval().greedy(feats)
    model = model.cuda()
    before = (fused_decode.argmax_linear.launches, fused_s2vt.fused_s2vt_fwd.launches)
    got = model.greedy(feats.cuda())
    torch.cuda.synchronize()
    assert (fused_decode.argmax_linear.launches, fused_s2vt.fused_s2vt_fwd.launches) == \
        (before[0] + 5, before[1] + 1)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_streams_keep_their_own_tile_counters():
    """Launches on two streams of one card, in flight together, each count
    their tiles in their own buffer and give the plain version's tokens."""
    _card()
    args = [torch.from_numpy(a).cuda() for a in _inputs(12, 96, 512, 10240, True)]
    want = fused_decode.argmax_linear_reference(*args)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_decode.argmax_linear(*args) for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for per_stream in outs for o in per_stream)
    dev = args[0].device
    bufs = {fused_decode._counters[(dev, s.cuda_stream)].data_ptr() for s in streams}
    assert len(bufs) == 2


@pytest.mark.cuda
def test_greedy_on_card_raises_where_the_kernel_does_not_fit(monkeypatch):
    """A card whose shared memory the gate refuses for the hidden size makes
    a use_pallas greedy decode raise instead of bypassing the kernel."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    model = S2VT(**{**S2VT_KW, "dim_hid": 128, "dim_embed": 128}, use_pallas=True).cuda()
    monkeypatch.setattr(fused_decode._build, "smem_optin", lambda device: 1024)
    feats = torch.zeros(8, 6, 12, device="cuda")
    with pytest.raises(NotImplementedError, match="hidden size 128"):
        model.eval().greedy(feats)
