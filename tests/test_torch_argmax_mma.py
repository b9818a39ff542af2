"""The two routes of the port's greedy out-projection and argmax
(ops/fused_decode.py, csrc/argmax_linear.cu).

``argmax_linear_route(H, weight dtype, compute_bf16, pointers)`` sends a
weight in the mode's operand type (float32, or bf16 with ``compute_bf16``)
whose rows, and h's, are whole aligned 16-byte chunks to the "mma" kernel
(tensor cores) and every other call to the "direct" kernel (CUDA cores). In
bf16 the mma route reads W as bf16, so ``greedy_pick`` rounds the weight to
bf16 once per decode: the plain version gives the same tokens for that
weight as for the float32 one, and greedy decodes with the op stay
token-equal to JAX.

The ``cuda``-marked tests hold the mma route to the plain version on the
card: tokens equal outside near-ties (top two float64 logits within 1e-5
relative, chip_smoke.py's ARGMAX_TIE_RTOL) and on every row of integer
inputs, whose logits are exact in both modes, so that only the index order
decides a tie.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_decode
from s2vt_tpu_torch.utils.weights import params_from_jax

TIE_RTOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("hidden,dtype,bf16,pointers,route", [
    (512, F32, False, (), "mma"), (1000, F32, False, (), "mma"), (1816, F32, False, (), "mma"),
    (8, F32, False, (), "mma"), (12, F32, False, (), "mma"), (130, F32, False, (), "direct"),
    (6, F32, False, (), "direct"),
    (512, BF16, True, (), "mma"), (1000, BF16, True, (), "mma"), (1816, BF16, True, (), "mma"),
    (8, BF16, True, (), "mma"), (12, BF16, True, (), "direct"), (130, BF16, True, (), "direct"),
    (512, F32, True, (), "direct"), (512, BF16, False, (), "direct"),
    (512, F32, False, (64, 4096), "mma"), (512, F32, False, (4, 4096), "direct"),
    (512, BF16, True, (16, 8), "direct"), (512, BF16, True, (256, 2 ** 40), "mma")],
    ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_route_by_width_dtype_and_alignment(hidden, dtype, bf16, pointers, route):
    """16-byte copies need rows of whole chunks in h (float32, H % 4) and in
    W (H % 4 in float32, H % 8 in bf16), aligned addresses, and the weight in
    the mode's operand type: a float32 W in bf16 mode (rounded in registers)
    and a bf16 W in float32 mode go to the direct kernel."""
    assert fused_decode.argmax_linear_route(hidden, dtype, bf16, pointers) == route


def test_route_of_an_unaligned_view():
    """A view one float past its storage's start is not 16-byte aligned."""
    base = torch.zeros(16 * 512 + 1)
    h = base[1:].view(16, 512)
    w = torch.zeros(64, 512)
    assert w.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 4
    route = fused_decode.argmax_linear_route
    assert route(512, F32, False, (base[:-1].data_ptr(), w.data_ptr())) == "mma"
    assert route(512, F32, False, (h.data_ptr(), w.data_ptr())) == "direct"


def _inputs(seed, b, h, v, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        arrs = (rng.integers(-3, 4, (b, h)), rng.integers(-2, 3, (v, h)), rng.integers(-2, 3, v))
    else:
        arrs = (rng.normal(size=(b, h)), rng.normal(size=(v, h)) * 0.1, rng.normal(size=v))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrs]


@pytest.mark.parametrize("seed,b,h,v,valid", [(0, 8, 128, 2048, None), (1, 5, 16, 300, 250),
                                              (2, 16, 512, 1000, 990)])
def test_reference_takes_a_bf16_weight(seed, b, h, v, valid):
    """In bf16 mode a bf16 W is the float32 W rounded ahead: the same tokens
    as that W in float32 and as the original float32 W. In float32 mode a
    bf16 W counts as its (exact) float32 values."""
    x, w, bias = _inputs(seed, b, h, v)
    wb = w.to(BF16)
    ref = fused_decode.argmax_linear_reference
    got = ref(x, wb, bias, valid, True)
    assert got.dtype == torch.int64
    assert torch.equal(got, ref(x, wb.float(), bias, valid, True))
    assert torch.equal(got, ref(x, w, bias, valid, True))
    assert torch.equal(ref(x, wb, bias, valid, False), ref(x, wb.float(), bias, valid, False))


def test_op_takes_a_bf16_weight_on_cpu_and_counts_no_launch():
    x, w, bias = _inputs(3, 6, 32, 100)
    fn = fused_decode.argmax_linear
    before = (fn.launches, dict(fn.route_launches))
    got = fn(x, w.to(BF16), bias, 90, True)
    assert torch.equal(got, fused_decode.argmax_linear_reference(x, w, bias, 90, True))
    assert (fn.launches, fn.route_launches) == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(x, w.half(), bias, None, True)


@pytest.mark.parametrize("hidden,dtype,want", [(16, BF16, BF16), (12, BF16, F32),
                                               (16, None, F32)],
                         ids=["bf16_mma_width", "bf16_direct_width", "f32"])
def test_greedy_pick_rounds_the_weight_once_per_decode(hidden, dtype, want, monkeypatch):
    """With use_pallas in bf16, where the mma route would take the width,
    the picker hands every step one bf16 weight made when the picker was
    made (a new picker makes a new one); elsewhere the float32 weight goes
    as it is. Its tokens are the plain picker's."""
    x, w, bias = _inputs(4, 6, hidden, 40)
    seen = []
    op = fused_decode.argmax_linear
    monkeypatch.setattr(fused_decode, "argmax_linear",
                        lambda h, weight, *a: seen.append(weight) or op(h, weight, *a))
    picks = [fused_decode.greedy_pick(w, bias, 35, dtype, True) for _ in range(2)]
    plain = fused_decode.greedy_pick(w, bias, 35, dtype, False)
    for pick in picks:
        for step in range(3):
            assert torch.equal(pick(x + step), plain(x + step))
    assert len(seen) == 6 and all(t.dtype == want for t in seen)
    assert all(t is seen[0] for t in seen[:3]) and all(t is seen[3] for t in seen[3:])
    assert (seen[0] is not seen[3]) == (want == BF16)
    if want == F32:
        assert seen[0] is w


# ---------------------------------------------------------------------------
# bf16 greedy decodes with the op wired in, against JAX's on carried weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy)."""
    return tuple(importlib.import_module(n) for n in ("jax", "jax.numpy"))


def _record_weights(monkeypatch):
    seen = []
    op = fused_decode.argmax_linear
    monkeypatch.setattr(fused_decode, "argmax_linear",
                        lambda h, weight, *a: seen.append(weight.dtype) or op(h, weight, *a))
    return seen


@pytest.mark.parametrize("cfg", [dict(), dict(rnn_type="gru"), dict(valid_vocab=33)],
                         ids=["lstm1", "gru", "padded_vocab"])
def test_s2vt_bf16_greedy_with_the_op_matches_jax(jax_side, cfg, monkeypatch):
    jax, jnp = jax_side
    from s2vt_tpu.models import S2VT as JS2VT
    from s2vt_tpu_torch.models import S2VT as TS2VT
    kw = dict(vocab_size=40, feat_dim=12, length=6, dim_hid=16, dim_embed=16, sos_ix=3,
              eos_ix=4, **cfg)
    feats = np.random.default_rng(14).normal(size=(5, 6, 12)).astype(np.float32)
    jmodel = JS2VT(**kw, compute_dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(15), jnp.asarray(feats), mode="test")["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats), mode="test"))
    model = TS2VT(**kw, use_pallas=True, compute_dtype=BF16)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    seen = _record_weights(monkeypatch)
    got = model.eval().greedy(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert seen == [BF16] * (kw["length"] - 1)      # one launch per step, W read as bf16


def test_attention_bf16_greedy_with_the_op_matches_jax(jax_side, monkeypatch):
    jax, jnp = jax_side
    from s2vt_tpu.models import AttBaseline as JAtt
    from s2vt_tpu_torch.models import AttBaseline as TAtt
    kw = dict(vocab_size=40, dim_feat=12, length=6, dim_hid=16, dim_embed=16, sos_ix=3,
              eos_ix=4)
    feats = np.random.default_rng(16).normal(size=(4, 6, 12)).astype(np.float32)
    jmodel = JAtt(**kw, compute_dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(17), jnp.asarray(feats), mode="test")["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(feats), mode="test"))
    model = TAtt(**kw, use_pallas=True, compute_dtype=BF16)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    seen = _record_weights(monkeypatch)
    got = model.eval().greedy(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert seen == [BF16] * kw["length"]            # L steps from <sos>


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, h, v, integer=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if integer:
        return [torch.randint(lo, hi, shape, device="cuda", generator=gen).float()
                for lo, hi, shape in ((-3, 4, (b, h)), (-2, 3, (v, h)), (-2, 3, (v,)))]
    return [torch.randn(b, h, device="cuda", generator=gen),
            0.05 * torch.randn(v, h, device="cuda", generator=gen),
            torch.randn(v, device="cuda", generator=gen)]


def _bad_rows(got, want, args, valid, bf16):
    """Rows that differ outside a near-tie of the top two float64 logits."""
    h, w, b = (a.double() for a in args)
    if bf16:
        h, w = h.to(BF16).double(), w.to(BF16).double()
    logits = h @ w.T + b
    if valid is not None:
        logits[:, valid:] = -1e30
    top2 = logits.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= TIE_RTOL * top2[:, 0].abs()
    return torch.nonzero((got != want) & ~near).flatten().tolist()


def _call(args, valid, bf16, route):
    """One op call with W in the mode's operand type; checks its route and
    that it launched once, on that route."""
    h, w, b = args
    w = w.to(BF16) if bf16 else w
    assert fused_decode.argmax_linear_route(h.shape[1], w.dtype, bf16,
                                            (h.data_ptr(), w.data_ptr())) == route
    fn = fused_decode.argmax_linear
    before = dict(fn.route_launches)
    got = fn(h, w, b, valid, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, route: 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("V", [10240, 10001, 205])
@pytest.mark.parametrize("H", [512, 1000, 1816])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 96, 200])
def test_mma_route_matches_plain_on_card(B, H, V):
    """Both modes on the tensor cores: one and several m16 tiles per block,
    row tiles past 64 rows, ragged vocab tiles and k steps, a padded vocab
    (10001 and 205: valid = V - 40)."""
    _card()
    args = _card_inputs(B * 7 + H + V, B, H, V)
    valid = None if V == 10240 else V - 40
    for bf16 in (False, True):
        got = _call(args, valid, bf16, "mma")
        want = fused_decode.argmax_linear_reference(*args, valid, bf16)
        assert got.shape == (B,) and got.dtype == torch.int64
        assert _bad_rows(got, want, args, valid, bf16) == [], (B, H, V, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_unaligned_view_takes_the_direct_route(bf16):
    _card()
    h, w, b = _card_inputs(21, 16, 512, 10240)
    store = torch.empty(h.numel() + 1, device="cuda")
    view = store[1:].view_as(h)
    view.copy_(h)
    got = _call([view, w, b], None, bf16, "direct")
    want = fused_decode.argmax_linear_reference(h, w, b, None, bf16)
    assert _bad_rows(got, want, [h, w, b], None, bf16) == []


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 96])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_exact_ties_on_the_mma_route(B, bf16):
    """Integer inputs: every row equals the plain version. Then two equal
    winning columns planted across the two columns of a thread, the lanes
    of a quad, two n8 tiles, two warps, two blocks and far apart: the lower
    index wins on every row, on both routes."""
    _card()
    args = _card_inputs(31 + B, B, 512, 10240, integer=True)
    got = _call(args, 10000, bf16, "mma")
    assert torch.equal(got, fused_decode.argmax_linear_reference(*args, 10000, bf16))
    for lo, hi in ((64, 65), (66, 68), (8, 16), (16, 32), (63, 64), (37, 1536), (9000, 9999)):
        h, w, b = (a.clone() for a in args)
        for col in (hi, lo):
            w[col] = 1.0
            b[col] = 5000.0
        assert torch.equal(_call([h, w, b], None, bf16, "mma").cpu(),
                           torch.full((B,), lo, dtype=torch.int64)), (lo, hi)
        direct = fused_decode._launch(h, w.to(BF16) if bf16 else w, b, None, bf16, "direct")
        assert torch.equal(direct.cpu(), torch.full((B,), lo, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_two_streams_on_the_mma_route(bf16):
    """Launches in flight on two streams, each with its own tile counters,
    give the plain version's tokens on exact-tie inputs."""
    _card()
    h, w, b = _card_inputs(41, 96, 512, 10240, integer=True)
    w = w.to(BF16) if bf16 else w
    want = fused_decode.argmax_linear_reference(h, w, b, None, bf16)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_decode.argmax_linear(h, w, b, None, bf16) for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for per_stream in outs for o in per_stream)


@pytest.mark.cuda
def test_bf16_greedy_on_card_reads_a_bf16_weight(monkeypatch):
    """S2VT.greedy in bf16 with use_pallas on the card: the argmax kernel
    once per decode step, all on the mma route, and the tokens of the same
    decode with the plain version in the kernel's place."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    kw = dict(vocab_size=40, feat_dim=12, length=6, dim_hid=128, dim_embed=128, sos_ix=3,
              eos_ix=4)
    model = S2VT(**kw, use_pallas=True, compute_dtype=BF16)
    model.reset_parameters(torch.Generator().manual_seed(9))
    model = model.cuda().eval()
    feats = torch.from_numpy(np.random.default_rng(10).normal(size=(8, 6, 12)).astype(np.float32))
    fn = fused_decode.argmax_linear
    before = dict(fn.route_launches)
    got = model.greedy(feats.cuda())
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == {"mma": 5, "direct": 0}
    monkeypatch.setattr(fused_decode, "argmax_linear", fused_decode.argmax_linear_reference)
    np.testing.assert_array_equal(got.cpu().numpy(), model.greedy(feats.cuda()).cpu().numpy())


def test_bf16_greedy_artifact_rounds_the_weight_in_one_node(tmp_path):
    """An exported bf16 greedy decode holds the weight's rounding to bf16 as
    one node, which every step's operator node reads; the artifact's tokens
    are the model's."""
    from s2vt_tpu_torch.models import S2VT
    from s2vt_tpu_torch.serving import ServingCaptioner, export_captioner
    kw = dict(vocab_size=32, feat_dim=12, length=6, dim_hid=16, dim_embed=16, sos_ix=3,
              eos_ix=4)
    model = S2VT(**kw, use_pallas=True, compute_dtype=BF16)
    model.reset_parameters(torch.Generator().manual_seed(18))
    feats = np.random.default_rng(19).normal(size=(4, 6, 12)).astype(np.float32)
    srv = ServingCaptioner(export_captioner(model.eval(), {i: f"w{i}" for i in range(32)},
                                            {"pad_ix": 0, "unk_ix": 1, "sos_ix": 3,
                                             "eos_ix": 4}, 4, tmp_path / "bf16", mode="greedy"))
    ops = [n for n in srv._program.graph.nodes
           if n.target == torch.ops.s2vt_tpu_torch.argmax_linear.default]
    weights = {n.args[1] for n in ops}
    assert len(ops) == kw["length"] - 1 and len(weights) == 1
    assert next(iter(weights)).meta["val"].dtype == BF16
    np.testing.assert_array_equal(srv.decode_tokens(feats),
                                  model.greedy(torch.from_numpy(feats)).numpy())


def test_variant_tool_changes_one_constant_each():
    """tools/argmax_mma_variants.py finds each constant of the mma route in
    the kernel source (with the shared headers written in place) by its
    exact text; each variant changes what it names and nothing else."""
    from s2vt_tpu_torch.tools import argmax_mma_variants as tool
    src = tool.kernel_source()
    assert '#include "mma.cuh"' not in src and "void split_tf32(" in src
    got = tool.variants(src)
    assert got["as_built"] == src
    for name, gone in (("stages_3", tool._STAGES), ("stages_8", tool._STAGES),
                       ("warps_4", tool._WARPS), ("warps_8", tool._WARPS),
                       ("split_1", tool._SPLIT), ("split_2", tool._SPLIT),
                       ("mi8", tool._MI4), ("step_256", tool._STEP),
                       ("copy_only", tool._PRODUCTS),
                       ("compute_only", tool._COPIES)):
        assert src.count(gone) == 1 and got[name] != src, name
        assert len(got[name].splitlines()) == len(src.splitlines())
    assert tool._NO_COPIES in got["compute_only"] and tool._NO_PRODUCTS in got["copy_only"]
