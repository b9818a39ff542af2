"""The two routes of the port's per-layer GRU backward (ops/fused_gru.py,
csrc/gru_seq_bwd.cu).

``gru_seq_bwd_route(H, B, compute_bf16, device)`` sends the widths and
batches that the "mma" kernel serves and is chosen for to it, and every
other call to the "direct" kernel; the card's properties come in as a
``CardProps`` of plain values here. ``gru_bwd_mma_plan`` (``fused_rnn.mma_plan``
with one lane per cell and the backward's shared memory,
``gru_bwd_smem_bytes``) lays a launch out: batch groups of rows, H / U blocks
per group, m16 row tiles per pass, at most 4 cells per thread.
The route forms its bf16 sums on the tensor cores (one float32 partial per
warp's k share of the 3H operand columns, its k16 slices in order, the
shares added in order, then the carry) and its float32 sums on the CUDA
cores in the direct route's order (128 k slices of 4-k chunks, fused
multiply-adds per slot, the warp reduce-scatter per slice warp, the four
slice warps' sums added to 0 in order, then to the carry), so that its
float32 results are the direct route's bit for bit.
``test_emulated_mma_bf16_arithmetic_matches_plain_and_jax`` and
``test_emulated_direct_order_matches_plain_and_jax`` run both in numpy
against the plain version and JAX's ``_run_backward`` (its Pallas kernel in
interpret mode) within chip_smoke.py's SEQ_ATOL.

The ``cuda``-marked tests hold each route to the plain version on the card:
1e-4 in float32 and 1.5e-3 in bf16 (every value is stored float32, so only
a flipped bf16 rounding of a product operand shows), and check that each
call launched once, on its route. The JAX side is imported by a fixture, so
that the card tests also collect where the JAX package cannot be imported.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import _build, fused_gru, fused_rnn
from s2vt_tpu_torch.ops.rnn import TorchRNN

H100 = fused_rnn.CardProps(132, 232448, 15)   # as an H100 SXM reports
ATOL = {False: 1e-4, True: 1.5e-3}            # chip_smoke.py's SEQ_ATOL


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_gru)."""
    return tuple(importlib.import_module(n) for n in ("jax.numpy", "s2vt_tpu.ops.pallas_gru"))


def _plan(hidden, batch, bf16, props=H100, units=None):
    return fused_gru.gru_bwd_mma_plan(hidden, batch, bf16, props, units=units)


@pytest.mark.parametrize("hidden,batch,bf16,props,want", [
    (512, 1, False, H100, "mma"), (512, 16, False, H100, "mma"), (512, 96, False, H100, "mma"),
    (512, 1, True, H100, "mma"), (512, 16, True, H100, "mma"), (512, 96, True, H100, "mma"),
    (512, 128, False, H100, "mma"), (512, 128, True, H100, "mma"),
    (512, 200, False, H100, "mma"), (512, 200, True, H100, "mma"),
    (512, 201, False, H100, "direct"), (512, 256, True, H100, "direct"),
    (128, 8, False, H100, "mma"), (256, 33, True, H100, "mma"), (384, 17, False, H100, "mma"),
    (64, 3, False, H100, "direct"), (448, 16, False, H100, "direct"),
    (576, 16, True, H100, "direct"), (1000, 16, False, H100, "direct"),
    (1024, 16, True, H100, "direct"), (130, 5, False, H100, "direct"),
    # fewer SMs than the blocks of one group at every U (H / 16 in float32)
    (512, 16, False, fused_rnn.CardProps(31, 232448, 0), "direct"),
    (512, 16, False, fused_rnn.CardProps(32, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(16, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(15, 232448, 0), "direct"),
    # shared memory: float32 needs 122 KB at U = 4, bf16 78 KB at U = 4 or 8
    (512, 16, False, fused_rnn.CardProps(132, 120 * 1024, 15), "direct"),
    (512, 16, True, fused_rnn.CardProps(132, 80 * 1024, 15), "mma"),
    (512, 16, True, fused_rnn.CardProps(132, 78 * 1024, 15), "direct"),
    # a _build.Card serves as well as a CardProps
    (512, 16, False, _build.Card(132, 232448), "mma")],
    ids=lambda v: str(v) if not isinstance(v, tuple) else f"sms{v.sms}-smem{v.smem_optin}")
def test_route_by_width_batch_dtype_and_card(hidden, batch, bf16, props, want):
    assert fused_gru.gru_seq_bwd_route(hidden, batch, bf16, props) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_the_card_at_every_batch(bf16):
    """At H = 512 every batch up to 256 has a plan on an H100: its blocks fit
    the SMs, its groups cover the batch, a thread runs at most 4 cells (16 m16
    tiles x U cells per pass over 256 threads), and its shared memory fits."""
    for b in range(1, 257):
        p = _plan(512, b, bf16)
        assert p is not None, b
        assert p.units in (4, 8, 16) + ((32,) if bf16 else ())
        assert p.groups * 512 // p.units <= H100.sms
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.tiles * 16 >= p.rows > (p.passes - 1) * p.tiles * 16
        assert p.passes * -(-16 * p.tiles * p.units // 256) <= 4 and 1 <= p.tiles <= 4
        assert fused_gru.gru_bwd_smem_bytes(512, p.units, p.tiles, bf16) <= H100.smem_optin


def test_smem_of_the_backward_layout():
    """The block's W_hh columns are 3H x U values (bf16: U padded to whole n8
    tiles, rows of 3H + 8), its staged operand rows 3H values with 16 bytes
    of padding; the partial sums are 4 slice warps' in float32 and 8 warps' k
    shares' in bf16, each a row of the columns + 4 floats per staged row."""
    k = 3 * 512
    assert fused_gru.gru_bwd_smem_bytes(512, 16, 1, False) == \
        (k * 16 + 16 * (k + 4)) * 4 + 4 * 4 * 16 * 20
    assert fused_gru.gru_bwd_smem_bytes(512, 4, 2, False) == \
        (k * 4 + 32 * (k + 4)) * 4 + 4 * 4 * 32 * 8
    assert fused_gru.gru_bwd_smem_bytes(512, 4, 1, True) == \
        (8 * (k + 8) + 16 * (k + 8)) * 2 + 4 * 8 * 16 * 12
    assert fused_gru.gru_bwd_smem_bytes(512, 16, 2, True) == \
        (16 * (k + 8) + 32 * (k + 8)) * 2 + 4 * 8 * 32 * 20
    assert fused_gru.gru_bwd_smem_bytes(512, 32, 1, True) == \
        (32 * (k + 8) + 16 * (k + 8)) * 2 + 4 * 8 * 16 * 36
    assert fused_gru.gru_bwd_smem_bytes(128, 8, 3, False) == \
        (384 * 8 + 48 * 388) * 4 + 4 * 4 * 48 * 12


def test_plans_of_the_measured_batches_and_forced_units():
    """The measured U at H = 512: float32 4 at B = 1, 8 up to B = 4, then 16
    (B = 16 four groups of 4 rows, B = 96 four groups of 24 rows in two
    passes of one tile, B = 200 four passes); bf16 8 up to B = 2, 16 up to
    B = 12, then 32 (B = 16 eight groups of 2 rows, B = 200 eight groups of
    25 rows in two passes); where the measured U does not serve, mma_plan's
    own; a forced U lays out as many groups as the card holds; float32 never
    takes U = 32; and the GRU forward's plans are unchanged."""
    assert _plan(512, 1, False) == (4, 1, 1, 1, 1)
    assert _plan(512, 4, False) == (8, 2, 2, 1, 1)
    assert _plan(512, 16, False) == (16, 4, 4, 1, 1)
    assert _plan(512, 96, False) == (16, 4, 24, 1, 2)
    assert _plan(512, 200, False) == (16, 4, 50, 1, 4)
    assert _plan(512, 2, True) == (8, 2, 1, 1, 1)
    assert _plan(512, 4, True) == (16, 4, 1, 1, 1)
    assert _plan(512, 12, True) == (16, 4, 3, 1, 1)
    assert _plan(512, 14, True) == (32, 7, 2, 1, 1)
    assert _plan(512, 16, True) == (32, 8, 2, 1, 1)
    assert _plan(512, 96, True) == (32, 8, 12, 1, 1)
    assert _plan(512, 200, True) == (32, 8, 25, 1, 2)
    assert _plan(512, 16, False, H100._replace(sms=31)) is None
    assert _plan(512, 16, False, H100._replace(sms=64)) == (16, 2, 8, 1, 1)
    assert _plan(512, 16, False, H100._replace(smem_optin=160 * 1024)) == (4, 1, 16, 1, 1)
    assert _plan(512, 16, True, H100._replace(smem_optin=120 * 1024)) == (4, 1, 16, 1, 1)
    one = _plan(512, 96, False, units=4)
    assert (one.groups, one.rows, one.tiles, one.passes) == (1, 96, 2, 3)
    assert _plan(512, 96, False, H100._replace(sms=16), units=16) is None
    assert _plan(256, 16, False, units=32) is None
    assert _plan(512, 16, True, units=8).groups == 2
    assert fused_gru.gru_mma_plan(512, 16, False, H100) == (8, 2, 8, 1, 1)
    assert fused_gru.gru_mma_plan(512, 96, True, H100) == (16, 4, 24, 2, 1)


# ---------------------------------------------------------------------------
# The route's arithmetic in numpy


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even) and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _fma32(a, b, c):
    """fmaf in numpy: a * b exact in float64, one rounding to float32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)




def _mma_bf16_sums(a, w):
    """a [B, 3H] @ w [3H, H] as the mma route forms it in bf16: operands
    rounded to bf16; per k share (in order; one per warp, at every U) a
    float32 partial to which each k16 slice's 16 exact products are added
    (one rounding per slice); the shares added in order."""
    ab, wb = _bf16(a).astype(np.float64), _bf16(w).astype(np.float64)
    shares = 8                     # one per warp, each over every n8 tile
    per = a.shape[1] // 16 // shares
    total = None
    for share in range(shares):
        acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
        for sl in range(share * per, (share + 1) * per):
            ks = slice(sl * 16, (sl + 1) * 16)
            acc = (acc + ab[:, ks] @ wb[ks]).astype(np.float32)
        total = acc if total is None else total + acc
    return total


def _tree32(x):
    """The warp reduce-scatter's sum of one slot over its 32 lanes (the last
    axis): lanes paired by lane ^ 8, then ^ 4, ^ 2, ^ 1, ^ 16, float32."""
    lane = np.arange(32)
    for step in (8, 4, 2, 1, 16):
        x = x + x[..., lane ^ step]
    return x[..., 0]


def _direct_order_sums(a, w):
    """a [B, 3H] @ w [3H, H] as the direct route at U = 4 (and the mma route
    in float32) forms it: slice s of 128 sums the 4-k chunks ch = s + 128 m
    in order, k = 4 ch + q, by fused multiply-adds; each slice warp's 32
    lanes by the reduce-scatter tree; the four slice warps' sums added to 0
    in order."""
    B, K = a.shape
    nchunk = K // 4
    acc = np.zeros((B, w.shape[1], 128), np.float32)                 # [b, j, slice]
    for m in range(-(-nchunk // 128)):
        chs = np.arange(m * 128, min((m + 1) * 128, nchunk))
        for q in range(4):
            k = 4 * chs + q
            acc[:, :, :len(chs)] = _fma32(a[:, None, k], w[k].T[None], acc[:, :, :len(chs)])
    total = np.zeros((B, w.shape[1]), np.float32)
    for vw in range(4):
        total = total + _tree32(acc[:, :, 32 * vw:32 * vw + 32])
    return total


def _cell_grads(dh, r, z, n, gn, hp, fused=True):
    """The gate backward as the kernels compile it: 1 - n^2 as fma(-n, n, 1)
    (``fused``), or rounded product then difference. Returns (dr_pre,
    dz_pre, dn_pre, dghn)."""
    one = np.float32(1)
    dz = dh * (hp - n)
    nn = _fma32(-n, n, one) if fused else one - n * n
    dn = dh * (one - z) * nn
    return dn * gn * r * (one - r), dz * z * (one - z), dn, dn * r


def _emulated_backward(gates, ghn, hprev, w, dout, dhT, sums, fused=True):
    """The route's backward over T steps in numpy, recurrent sums by
    ``sums(operand, w)``: dprev = carry + the sum (dhT first), dh = dout +
    dprev, the gate backward, carry = dh z. Returns (dxp, dghn, dh0)."""
    hid = ghn.shape[-1]
    T = gates.shape[0]
    dxp, dghn = np.zeros_like(gates), np.zeros_like(ghn)
    dprev = dhT
    for t in range(T - 1, -1, -1):
        r, z, n = gates[t, :, :hid], gates[t, :, hid:2 * hid], gates[t, :, 2 * hid:]
        dh = dout[t] + dprev
        dr, dz, dn, dg = _cell_grads(dh, r, z, n, ghn[t], hprev[t], fused)
        dxp[t] = np.concatenate([dr, dz, dn], axis=1)
        dghn[t] = dg
        dprev = dh * z + sums(np.concatenate([dr, dz, dg], axis=1), w)
    return dxp, dghn, dprev


def _np_inputs(seed, b, t, h):
    """gates (post-activation r, z in (0, 1), n in (-1, 1)), gh_n, h_prev, w_hh
    [3H, H], dout, dhT, float32."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    sig = lambda v: 1 / (1 + np.exp(-v))    # noqa: E731
    pre = rng.normal(size=(t, b, 3 * h))
    gates = np.concatenate([sig(pre[..., :2 * h]), np.tanh(pre[..., 2 * h:])], -1)
    return tuple(np.asarray(x, np.float32) for x in (
        gates, rng.normal(size=(t, b, h)), np.tanh(rng.normal(size=(t, b, h))),
        rng.uniform(-k, k, (3 * h, h)), rng.normal(size=(t, b, h)), rng.normal(size=(b, h))))


def _against_plain_and_jax(jax_side, got, args, bf16):
    jnp, jgru = jax_side
    plain = fused_gru.gru_seq_bwd_reference(*map(torch.from_numpy, args), bf16)
    jax_out = jgru._run_backward(*map(jnp.asarray, args), compute_bf16=bf16)
    for g, p, j in zip(got, plain, jax_out):
        assert g.shape == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g, p.numpy(), atol=ATOL[bf16], rtol=0)
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL[bf16], rtol=0)
    return plain


@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5), (384, 6), (128, 3)])
def test_emulated_mma_bf16_arithmetic_matches_plain_and_jax(jax_side, hidden, batch):
    """The route's bf16 arithmetic, with its 8 k shares, against the plain
    version and JAX's _run_backward: dxp, dghn and dh0 within 1.5e-3
    (SEQ_ATOL); the shares' sums are not the plain version's float32 sum."""
    args = _np_inputs(hidden + batch, batch, 5, hidden)
    got = _emulated_backward(*args, sums=_mma_bf16_sums)
    _against_plain_and_jax(jax_side, got, args, True)
    a = args[0][0]
    exact = _bf16(a).astype(np.float64) @ _bf16(args[3]).astype(np.float64)
    assert 0 < np.abs(_mma_bf16_sums(a, args[3]) - exact).max() < 1e-5


@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5), (512, 2)])
def test_emulated_direct_order_matches_plain_and_jax(jax_side, hidden, batch):
    """The route's float32 arithmetic (the direct route's order: 1, 2 and 3
    chunks per slice at H = 128, 256 and 512) against the plain version and
    JAX's _run_backward: within 1e-4 (SEQ_ATOL), and within a few float32
    roundings of the plain version; the other form of 1 - n^2 moves a
    result, so the test of bit-equality on the card can tell the two
    apart."""
    args = _np_inputs(hidden * 3 + batch, batch, 4, hidden)
    got = _emulated_backward(*args, sums=_direct_order_sums)
    plain = _against_plain_and_jax(jax_side, got, args, False)
    for g, p in zip(got, plain):
        assert np.abs(g - p.numpy()).max() < 1e-5
    other = _emulated_backward(*args, sums=_direct_order_sums, fused=False)
    assert any(not np.array_equal(g, o) for g, o in zip(got, other))


def test_direct_order_tree_is_the_reduce_scatter():
    """_tree32 is what common.cuh's 16-value reduce-scatter leaves for each
    slot (the lane-by-lane emulation of tests/test_torch_gru_fwd_mma.py)."""
    from tests.test_torch_gru_fwd_mma import _reduce_scatter16
    v = np.random.default_rng(5).normal(size=(3, 32, 16)).astype(np.float32)
    want = _reduce_scatter16(v)
    got = np.stack([_tree32(v[:, :, s]) for s in range(16)], axis=-1)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_inputs(seed, b=4, t=5, h=128):
    return tuple(map(torch.from_numpy, _np_inputs(seed, b, t, h)))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_inputs(1)
    fn = fused_gru.gru_seq_bwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args, bf16)
    want = fused_gru.gru_seq_bwd_reference(*args, bf16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("batch,bf16,route", [(16, False, "mma"), (96, True, "mma"),
                                              (256, False, "direct")])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, batch, bf16, route):
    """A CUDA-typed tensor (a fake one here, with no card) goes to its route
    and the kernel's build or the card's properties, which raise without
    nvcc or a card; the plain version is never called and no launch is
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fused_gru, "gru_seq_bwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(_build, "card", lambda device: H100)
    plain_launch = fused_gru.launch_bwd

    def launch(*a, **kw):
        routes.append(a[7])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fused_gru, "launch_bwd", launch)
    fn = fused_gru.gru_seq_bwd
    before = (fn.launches, dict(fn.route_launches))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda") for a in _cpu_inputs(2, b=batch, t=3, h=512)]
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args, bf16)
    assert called == [] and routes == [route]
    assert (fn.launches, fn.route_launches) == before


def test_variant_tool_changes_one_piece_each():
    """tools/gru_bwd_variants.py finds each piece of the mma route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and nothing else: the edits of
    CHANGED remove their texts and keep the line count (the dn_* variants
    write 1 - n^2 in another form), inputs_after_poll moves the cells' input
    loads after the poll."""
    import difflib
    from s2vt_tpu_torch.tools import gru_bwd_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    got = tool.mma_variants(src)
    assert got["as_built"] == src
    assert set(got) == {"as_built", "phase_clock", "inputs_after_poll", *tool.CHANGED}
    for name, texts in tool.CHANGED.items():
        for gone in texts:
            assert src.count(gone) == 1 and gone not in got[name], (name, gone)
        assert got[name] != src and len(got[name].splitlines()) == len(src.splitlines()), name
        diff = [d for d in difflib.ndiff(src.splitlines(), got[name].splitlines())
                if d[:2] in ("- ", "+ ")]
        assert len(diff) == 2 * len(texts), (name, diff)
    moved = got["inputs_after_poll"]
    assert sorted(moved.splitlines()) == sorted(src.splitlines()) and moved != src
    assert moved.index(tool._IN_START) > moved.index(tool._STAGED_SYNC)
    assert src.index(tool._IN_START) < src.index(tool._STAGED_SYNC)


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order, and
    adds only its clock lines; it writes its sums over dxp[0, 0, :3], which
    block 0 alone writes (units 0-2 of row 0 at step 0), not past any
    allocation; the shipped kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import gru_bwd_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    assert "dxp[ph] = (float)clk[ph];" in added and len(tool.PHASES) <= 3 <= min(
        fused_rnn._MMA_UNITS)
    assert "xch[" not in added


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h):
    """The backward's inputs on the card, as _np_inputs lays them out."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    pre = n(t, b, 3 * h)
    gates = torch.cat([torch.sigmoid(pre[..., :2 * h]), torch.tanh(pre[..., 2 * h:])], -1)
    w = (torch.rand(3 * h, h, device="cuda", generator=gen) * 2 - 1) / h ** 0.5
    return gates.contiguous(), n(t, b, h), torch.tanh(n(t, b, h)), w, n(t, b, h), n(b, h)


def _check(got, want, bf16, label):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g).all(), label
        err = (g - w).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _forced(args, bf16, route, plan=None):
    """One launch of ``route`` through launch_bwd; checks that it counted
    once, on that route."""
    fn = fused_gru.gru_seq_bwd
    before = dict(fn.route_launches)
    got = fused_gru.launch_bwd(*args, bf16, route, plan=plan)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 80, 159])
@pytest.mark.parametrize("B", [1, 16, 96, 200])
def test_mma_route_matches_plain_on_card(B, T, bf16):
    """H = 512 on the mma route and on the direct route, on the same
    inputs, against the plain version: dxp, dghn and dh0; and the wrapper's
    own call on the route gru_seq_bwd_route names."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512)
    want = fused_gru.gru_seq_bwd_reference(*args, bf16)
    _check(_forced(args, bf16, "mma"), want, bf16, ("mma", B, T, bf16))
    _check(_forced(args, bf16, "direct"), want, bf16, ("direct", B, T, bf16))
    route = fused_gru.gru_seq_bwd_route(512, B, bf16, "cuda")
    fn = fused_gru.gru_seq_bwd
    before = dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    _check(got, want, bf16, (route, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 96, 128, 200])
def test_float32_mma_route_equals_the_direct_route_bit_for_bit(B):
    """In float32 the mma route forms every sum in the direct route's order
    and the gate backward in its expressions, so dxp, dghn and dh0 are the
    direct route's exactly."""
    _card()
    args = _card_inputs(B + 7, B, 40, 512)
    got = _forced(args, False, "mma")
    want = _forced(args, False, "direct")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,B", [(128, 8), (256, 33), (384, 17), (128, 96)])
def test_other_widths_on_the_mma_route(H, B, bf16):
    _card()
    assert fused_gru.gru_seq_bwd_route(H, B, bf16, "cuda") == "mma"
    args = _card_inputs(H + B, B, 30, H)
    want = fused_gru.gru_seq_bwd_reference(*args, bf16)
    _check(_forced(args, bf16, "mma"), want, bf16, (H, B, bf16))
    if not bf16:
        assert all(torch.equal(g, w) for g, w in zip(_forced(args, False, "mma"),
                                                     _forced(args, False, "direct")))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("units", [4, 8, 16, 32])
def test_every_layout_matches_plain_on_card(units, bf16):
    """Every instantiated U (32 in bf16 only), at as many groups as the card
    holds and at one group, at B = 16, 96 and 200, H = 512 and 128 (where a
    warp's bf16 k share at U <= 8 is 3 k16 slices); float32 equal to the
    direct route bit for bit at every layout."""
    _card()
    props = _build.card("cuda")
    for hid, b in ((512, 16), (512, 96), (512, 200), (128, 40)):
        args = _card_inputs(units + b + hid, b, 20, hid)
        want = fused_gru.gru_seq_bwd_reference(*args, bf16)
        direct = None if bf16 else _forced(args, False, "direct")
        for p in (props, props._replace(sms=hid // units)):
            plan = _plan(hid, b, bf16, p, units=units)
            if plan is None:     # f32 at U = 32, or too many cells per thread
                assert (units == 32 and not bf16) or p is not props or (b == 200 and units <= 8)
                continue
            got = _forced(args, bf16, "mma", plan=plan)
            _check(got, want, bf16, (units, hid, b, plan))
            if direct is not None:
                assert all(torch.equal(g, w) for g, w in zip(got, direct)), (units, hid, b, plan)


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's, and the card holds its
    plans at H = 512."""
    _card()
    props = _build.card("cuda")
    lib = fused_gru._bwd_lib()
    for h in (128, 256, 384, 512):
        for units in (4, 8, 16, 32):
            for tiles in (1, 2, 3, 4):
                for bf16 in (False, True):
                    if units == 32 and not bf16:
                        continue
                    assert lib.gru_seq_bwd_mma_smem_bytes(h, units, tiles, int(bf16)) == \
                        fused_gru.gru_bwd_smem_bytes(h, units, tiles, bf16)
    for b in (1, 16, 96, 200):
        for bf16 in (False, True):
            assert _plan(512, b, bf16, props) is not None


@pytest.mark.cuda
def test_two_layer_gru_torchrnn_train_step_on_the_mma_route():
    """A 2-layer GRU TorchRNN at H = 512, B = 16 on the card against the CPU
    (plain) route: outputs and every gradient within 2e-3 (chip_smoke.py's
    GRAD_TOL), both backward launches on the mma route."""
    _card()
    b, t, h = 16, 24, 512
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(b, t, h)).astype(np.float32))
    m = TorchRNN(h, h, num_layers=2, rnn_type="gru", use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(4))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(h, h, num_layers=2, rnn_type="gru", use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = dict(fused_gru.gru_seq_bwd.route_launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused_gru.gru_seq_bwd.route_launches == {
                "mma": before["mma"] + 2, "direct": before["direct"],
                "stream": before["stream"]}
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_repeated_launches_on_two_streams(bf16):
    """20 launches on each of two streams, in flight together: every result
    equals the first, so no launch reads another's words or stale state."""
    _card()
    args = _card_inputs(99, 16, 80, 512)
    first = fused_gru.launch_bwd(*args, bf16, "mma")
    _check(first, fused_gru.gru_seq_bwd_reference(*args, bf16), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_gru.launch_bwd(*args, bf16, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))
