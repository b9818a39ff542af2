"""The two routes of the port's per-layer GRU forward (ops/fused_gru.py,
csrc/gru_seq_fwd.cu).

``gru_seq_fwd_route(H, B, compute_bf16, device)`` sends the widths and
batches that the "mma" kernel serves and is chosen for to it, and every
other call to the "direct" kernel; the card's properties come in as a
``CardProps`` of plain values here. ``gru_mma_plan`` (``fused_rnn.mma_plan``
with three gate rows per unit, at the U measured fastest) lays a launch out:
batch groups of rows, H / U blocks per group, m16 row tiles per pass, at
most 4 cells per thread (one lane per cell).
The route forms its bf16 gate sums on the tensor cores (one float32 partial
per warp's k share, its k16 slices in order, the shares added in order,
b_hh after the sum) and its float32 sums on the CUDA cores in the direct
route's order (lane-strided fused multiply-adds into slot g * 4 + n of 16,
then the warp reduce-scatter), so that its float32 results are the direct
route's bit for bit. ``test_emulated_mma_bf16_arithmetic_matches_plain_and_jax``
and ``test_emulated_direct_order_matches_plain_and_jax`` run both in numpy
against the plain version and JAX's ``_run_forward`` (its Pallas kernel in
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
    return fused_gru.gru_mma_plan(hidden, batch, bf16, props, units=units)


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
    # fewer SMs than the blocks of one group (H / 16 at U = 16, H / 32 at U = 32)
    (512, 16, False, fused_rnn.CardProps(31, 232448, 0), "direct"),
    (512, 16, False, fused_rnn.CardProps(32, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(16, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(15, 232448, 0), "direct"),
    # shared memory: float32 needs 66 KB at U = 4, bf16 55 KB at U = 8, B = 16
    (512, 16, False, fused_rnn.CardProps(132, 60 * 1024, 15), "direct"),
    (512, 16, True, fused_rnn.CardProps(132, 60 * 1024, 15), "mma"),
    # a _build.Card serves as well as a CardProps
    (512, 16, False, _build.Card(132, 232448), "mma")],
    ids=lambda v: str(v) if not isinstance(v, tuple) else f"sms{v.sms}-smem{v.smem_optin}")
def test_route_by_width_batch_dtype_and_card(hidden, batch, bf16, props, want):
    assert fused_gru.gru_seq_fwd_route(hidden, batch, bf16, props) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_the_card_at_every_batch(bf16):
    """At H = 512 every batch up to 256 has a plan on an H100: its blocks fit
    the SMs, its groups cover the batch, a thread runs at most 4 cells (16 m16
    tiles x U cells per pass over 256 threads), and its shared memory fits;
    at the measured batches every row of a group runs in one pass."""
    for b in range(1, 257):
        p = _plan(512, b, bf16)
        assert p is not None, b
        assert p.units in (4, 8, 16) + ((32,) if bf16 else ())
        assert p.groups * 512 // p.units <= H100.sms
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.tiles * 16 >= p.rows > (p.passes - 1) * p.tiles * 16
        assert p.passes * -(-16 * p.tiles * p.units // 256) <= 4 and 1 <= p.tiles <= 4
        assert fused_rnn.mma_smem_bytes(512, p.units, p.tiles, bf16, gates=3) <= H100.smem_optin
        if b in (16, 96):      # the batches the route was measured at: one pass
            assert p.passes == 1, (b, p)


def test_smem_of_the_gru_layout():
    """Three gate rows per unit pad to whole n8 tiles (16 columns at U = 4);
    rows carry 16 bytes of padding; bf16 sums one k share per warp of a
    column tile (4 shares at U = 4, 8 at U = 8, where every warp takes the
    block's 3 n8 tiles); the LSTM's layout (gates = 4) is what it was."""
    assert fused_rnn.mma_smem_bytes(512, 4, 1, False, gates=3) == \
        (16 + 16) * 516 * 4 + 4 * 1 * 16 * 20
    assert fused_rnn.mma_smem_bytes(512, 16, 2, False, gates=3) == \
        (48 + 32) * 516 * 4 + 4 * 1 * 32 * 52
    assert fused_rnn.mma_smem_bytes(512, 4, 1, False) == (16 + 16) * 516 * 4 + 4 * 1 * 16 * 20
    assert fused_rnn.mma_smem_bytes(512, 4, 1, True, gates=3) == \
        (16 + 16) * 520 * 2 + 4 * 4 * 16 * 20
    assert fused_rnn.mma_smem_bytes(512, 8, 3, True, gates=3) == \
        (24 + 48) * 520 * 2 + 4 * 8 * 48 * 28
    assert fused_rnn.mma_smem_bytes(512, 16, 2, True, gates=3) == \
        (48 + 32) * 520 * 2 + 4 * 4 * 32 * 52
    assert fused_rnn.mma_smem_bytes(512, 32, 1, True, gates=3) == \
        (96 + 16) * 520 * 2 + 4 * 2 * 16 * 100
    assert fused_rnn.mma_smem_bytes(512, 8, 3, True) == (32 + 48) * 520 * 2 + 4 * 2 * 48 * 36


def test_plans_of_the_measured_batches_and_forced_units():
    """The measured U: 8 up to B = 32 in both modes (B = 16: two groups of 8
    rows), then float32 16 (B = 96: four groups of 24 rows, 2 m16 tiles,
    one pass; B = 200: two passes of 2 tiles), bf16 16 up to B = 128 and 32
    above (B = 200: eight groups of 25 rows); where the measured U does not
    serve, mma_plan's own; a forced U lays out as many groups as the card
    holds; float32 never takes U = 32; and the LSTM's plans are
    unchanged."""
    assert _plan(512, 1, False) == (8, 1, 1, 1, 1)
    assert _plan(512, 16, False) == (8, 2, 8, 1, 1)
    assert _plan(512, 96, False) == (16, 4, 24, 2, 1)
    assert _plan(512, 200, False) == (16, 4, 50, 2, 2)
    assert _plan(512, 16, True) == (8, 2, 8, 1, 1)
    assert _plan(512, 96, True) == (16, 4, 24, 2, 1)
    assert _plan(512, 200, True) == (32, 8, 25, 2, 1)
    assert _plan(512, 16, False, H100._replace(sms=31)) is None
    assert _plan(512, 16, False, H100._replace(sms=64)) == (8, 1, 16, 1, 1)
    assert _plan(512, 16, False, H100._replace(smem_optin=80 * 1024)) == (4, 1, 16, 1, 1)
    p = _plan(512, 96, False, units=16)
    assert (p.units, p.groups, p.rows, p.tiles, p.passes) == (16, 4, 24, 2, 1)
    one = _plan(512, 96, False, units=4)
    assert (one.groups, one.rows, one.tiles, one.passes) == (1, 96, 4, 2)
    assert _plan(512, 96, False, H100._replace(sms=32), units=16) is None
    assert _plan(256, 16, False, H100, units=32) is None     # float32 at U = 32
    assert fused_rnn.mma_plan(256, 16, False, H100, units=32) is None
    assert _plan(512, 16, True, units=32).groups == 8
    for bf16 in (False, True):
        assert fused_rnn.mma_plan(512, 16, bf16, H100) == (4, 1, 16, 1, 1)
        assert fused_rnn.mma_plan(512, 96, bf16, H100) == (8, 2, 48, 3, 1)


# ---------------------------------------------------------------------------
# The route's arithmetic in numpy


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even) and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _fma32(a, b, c):
    """fmaf in numpy: a * b exact in float64, one rounding to float32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _shares(units):
    """The k shares of a bf16 gate sum at U (Tile::kWarpsK in the source)."""
    n_tiles = -(-3 * units // 8)
    per_warp = 3 if n_tiles % 3 == 0 else max(1, n_tiles // 8)
    return 8 // (n_tiles // per_warp)


def _mma_bf16_gate_sums(h, w, units):
    """h [B, K] @ w [N, K]^T as the mma route forms it in bf16: operands
    rounded to bf16; per k share (in order) a float32 partial to which each
    k16 slice's 16 exact products are added (one rounding per slice); the
    shares added in order."""
    hb, wb = _bf16(h).astype(np.float64), _bf16(w).astype(np.float64)
    shares = _shares(units)
    per = h.shape[1] // 16 // shares
    total = None
    for share in range(shares):
        acc = np.zeros((h.shape[0], w.shape[0]), np.float32)
        for sl in range(share * per, (share + 1) * per):
            ks = slice(sl * 16, (sl + 1) * 16)
            acc = (acc + hb[:, ks] @ wb[:, ks].T).astype(np.float32)
        total = acc if total is None else total + acc
    return total


def _reduce_scatter16(v):
    """common.cuh's 16-value warp reduce-scatter, lane by lane: v [..., 32
    lanes, 16] float32 -> [..., 16], the sum of value l as lane l leaves it."""
    v = v.copy()
    lane = np.arange(32)
    for step in (8, 4, 2, 1):
        upper = (lane & step) != 0
        new = v.copy()
        for i in range(step):
            lo, hi = v[..., :, i], v[..., :, i + step]
            mine = np.where(upper, hi, lo)
            theirs = np.where(upper, lo, hi)[..., lane ^ step]
            new[..., :, i] = mine + theirs
        v = new
    v0 = v[..., :, 0] + v[..., lane ^ 16, 0]
    return v0[..., :16]


def _direct_order_gate_sums(h, w):
    """h [B, K] @ w [3H, K]^T as the direct route (and the mma route in
    float32) forms it: per unit and 4 batch rows, lane l sums k = l + 32 i
    in order by fused multiply-adds into slot g * 4 + n (slots 12-15 zero),
    then the warp reduce-scatter."""
    B, K = h.shape
    hid = w.shape[0] // 3
    out = np.zeros((B, 3 * hid), np.float32)
    rows = -(-B // 4) * 4
    hp = np.concatenate([h, np.repeat(h[-1:], rows - B, 0)]) if rows > B else h
    for u in range(hid):
        ws = w[[u, hid + u, 2 * hid + u]].reshape(3, K // 32, 32)      # [g, i, lane]
        for bg in range(rows // 4):
            hs = hp[bg * 4:bg * 4 + 4].reshape(4, K // 32, 32)          # [n, i, lane]
            acc = np.zeros((32, 16), np.float32)                        # [lane, 4 g + n]
            for i in range(K // 32):
                prod_w = np.zeros((32, 16), np.float32)
                prod_w[:, :12] = np.repeat(ws[:, i, :].T, 4, axis=1)    # slot g*4+n -> w_g
                prod_h = np.tile(hs[:, i, :].T, (1, 4))                 # slot g*4+n -> h_n
                acc = _fma32(prod_w, prod_h, acc)
            sums = _reduce_scatter16(acc)
            for g in range(3):
                for n in range(4):
                    if bg * 4 + n < B:
                        out[bg * 4 + n, g * hid + u] = sums[4 * g + n]
    return out


def _emulated_forward(xp, w, bhh, h0, sums):
    """The route's forward over T steps in numpy, gate sums by ``sums(h, w)``:
    b_hh after the sum, then x_proj; n = tanh(fma(r, gh_n, xp_n)), h =
    fma(z, h_{t-1}, (1 - z) n), as the kernels compile them. Returns (h seq,
    gates, gh_n seq, hT)."""
    sig = lambda v: np.float32(1) / (np.float32(1) + np.exp(-v))   # noqa: E731
    hid = h0.shape[1]
    h = h0
    outs, gseq, nseq = [], [], []
    for t in range(xp.shape[0]):
        gh = sums(h, w) + bhh
        x = xp[t]
        r = sig(x[:, :hid] + gh[:, :hid])
        z = sig(x[:, hid:2 * hid] + gh[:, hid:2 * hid])
        n = np.tanh(_fma32(r, gh[:, 2 * hid:], x[:, 2 * hid:]))
        h = _fma32(z, h, (np.float32(1) - z) * n)
        outs.append(h)
        gseq.append(np.concatenate([r, z, n], axis=1))
        nseq.append(gh[:, 2 * hid:])
    return np.stack(outs), np.stack(gseq), np.stack(nseq), h


def _np_inputs(seed, b, t, h):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    xp = rng.normal(size=(t, b, 3 * h)).astype(np.float32)
    w = rng.uniform(-k, k, (3 * h, h)).astype(np.float32)
    bhh = rng.uniform(-k, k, 3 * h).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(b, h))).astype(np.float32)
    return xp, w, bhh, h0


def _against_plain_and_jax(jax_side, got, args, bf16):
    jnp, jgru = jax_side
    xp, w, bhh, h0 = args
    plain = fused_gru.gru_seq_fwd_reference(*map(torch.from_numpy, args), bf16)
    jax_out = jgru._run_forward(*map(jnp.asarray, (xp, w.T, bhh, h0)), compute_bf16=bf16)
    for g, p, j in zip(got, plain, jax_out):
        assert g.shape == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g, p.numpy(), atol=ATOL[bf16], rtol=0)
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL[bf16], rtol=0)
    return plain


@pytest.mark.parametrize("hidden,batch,units", [(128, 8, 4), (256, 5, 4), (256, 6, 8),
                                                (128, 3, 8)])
def test_emulated_mma_bf16_arithmetic_matches_plain_and_jax(jax_side, hidden, batch, units):
    """The route's bf16 arithmetic, with the k shares of U, against the plain
    version and JAX's _run_forward: h, gates, gh_n and hT within 1.5e-3
    (SEQ_ATOL); the shares' sums are not the plain version's float32 sum."""
    args = _np_inputs(hidden + batch + units, batch, 5, hidden)
    got = _emulated_forward(*args, sums=lambda h, w: _mma_bf16_gate_sums(h, w, units))
    _against_plain_and_jax(jax_side, got, args, True)
    h0, w = args[3], args[1]
    exact = _bf16(h0).astype(np.float64) @ _bf16(w).T.astype(np.float64)
    assert 0 < np.abs(_mma_bf16_gate_sums(h0, w, units) - exact).max() < 1e-5


@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5)])
def test_emulated_direct_order_matches_plain_and_jax(jax_side, hidden, batch):
    """The route's float32 arithmetic (the direct route's order, emulated
    lane by lane) against the plain version and JAX's _run_forward: within
    1e-4 (SEQ_ATOL), and within a few float32 roundings of the plain
    version."""
    args = _np_inputs(hidden * 3 + batch, batch, 4, hidden)
    got = _emulated_forward(*args, sums=_direct_order_gate_sums)
    plain = _against_plain_and_jax(jax_side, got, args, False)
    for g, p in zip(got, plain):
        assert np.abs(g - p.numpy()).max() < 2e-6


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_inputs(seed, b=4, t=5, h=128):
    return tuple(map(torch.from_numpy, _np_inputs(seed, b, t, h)))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_inputs(1)
    fn = fused_gru.gru_seq_fwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args, bf16)
    want = fused_gru.gru_seq_fwd_reference(*args, bf16)
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
    monkeypatch.setattr(fused_gru, "gru_seq_fwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(_build, "card", lambda device: H100)
    plain_launch = fused_gru.launch_fwd

    def launch(*a, **kw):
        routes.append(a[5])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fused_gru, "launch_fwd", launch)
    fn = fused_gru.gru_seq_fwd
    before = (fn.launches, dict(fn.route_launches))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda") for a in _cpu_inputs(2, b=batch, t=3, h=512)]
        with pytest.raises((RuntimeError, AssertionError)):
            fused_gru._gru_seq_fwd_impl(*args, bf16)
    assert called == [] and routes == [route]
    assert (fn.launches, fn.route_launches) == before


def test_variant_tool_changes_one_piece_each():
    """tools/gru_fwd_variants.py finds each piece of the mma route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and nothing else: the edits of
    CHANGED remove their texts and keep the line count, xp_after_poll moves
    the x_proj loads after the poll, lanes4 rewrites the slot count, the
    cells of a pass, a slot's cell and b_hh and the cells themselves."""
    import difflib
    from s2vt_tpu_torch.tools import gru_fwd_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    got = tool.mma_variants(src)
    assert got["as_built"] == src
    assert set(got) == {"as_built", "phase_clock", "xp_after_poll", "lanes4", *tool.CHANGED}
    for name, texts in tool.CHANGED.items():
        for gone in texts:
            assert src.count(gone) == 1 and gone not in got[name], (name, gone)
        assert got[name] != src and len(got[name].splitlines()) == len(src.splitlines()), name
    moved = got["xp_after_poll"]
    assert sorted(moved.splitlines()) == sorted(src.splitlines()) and moved != src
    assert moved.index(tool._XV_START) > moved.index(tool._STAGED_SYNC)
    assert src.index(tool._XV_START) < src.index(tool._STAGED_SYNC)
    lanes = got["lanes4"]
    for gone in (tool._SLOTS, tool._PER_PASS, tool._CELL, tool._BIAS, tool._CELLS_START):
        assert src.count(gone) == 1 and gone not in lanes, gone
    assert lanes.count(tool._LANES4_CELLS) == 1
    cells = src.index(tool._CELLS_START), src.index(tool._KERNEL_END)
    rest = src[:cells[0]] + src[cells[1]:]
    diff = [d for d in difflib.ndiff(rest.splitlines(), lanes.replace(tool._LANES4_CELLS, "")
                                     .splitlines()) if d[:2] in ("- ", "+ ")]
    assert len(diff) == 8, diff      # 4 lines out, 4 in: slots, cells per pass, cell, b_hh


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order, and
    adds only its clock lines; it writes its sums over h[0, 0, :3], which
    block 0 alone writes (at step 0), not past any allocation; the shipped
    kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import gru_fwd_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    assert "out[ph] = (float)clk[ph];" in added and len(tool.PHASES) <= 4 <= min(
        fused_rnn._MMA_UNITS)
    assert "xch[" not in added


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 1.0 / h ** 0.5
    xp = torch.randn(t, b, 3 * h, device="cuda", generator=gen)
    w = (torch.rand(3 * h, h, device="cuda", generator=gen) * 2 - 1) * k
    bhh = (torch.rand(3 * h, device="cuda", generator=gen) * 2 - 1) * k
    h0 = 0.5 * torch.randn(b, h, device="cuda", generator=gen)
    return xp, w, bhh, h0


def _check(got, want, bf16, label):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g).all(), label
        err = (g - w).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _forced(args, bf16, route, plan=None):
    """One launch of ``route`` through launch_fwd; checks that it counted
    once, on that route."""
    fn = fused_gru.gru_seq_fwd
    before = dict(fn.route_launches)
    got = fused_gru.launch_fwd(*args, bf16, route, plan=plan)
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
    inputs, against the plain version: h, gates, gh_n and hT; and the
    wrapper's own call on the route gru_seq_fwd_route names."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512)
    want = fused_gru.gru_seq_fwd_reference(*args, bf16)
    _check(_forced(args, bf16, "mma"), want, bf16, ("mma", B, T, bf16))
    _check(_forced(args, bf16, "direct"), want, bf16, ("direct", B, T, bf16))
    route = fused_gru.gru_seq_fwd_route(512, B, bf16, "cuda")
    fn = fused_gru.gru_seq_fwd
    before = dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    _check(got, want, bf16, (route, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 96, 128, 200])
def test_float32_mma_route_equals_the_direct_route_bit_for_bit(B):
    """In float32 the mma route forms every gate sum in the direct route's
    order and the gate math in its expressions, so h, the gates, gh_n and hT
    are the direct route's exactly."""
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
    assert fused_gru.gru_seq_fwd_route(H, B, bf16, "cuda") == "mma"
    args = _card_inputs(H + B, B, 30, H)
    want = fused_gru.gru_seq_fwd_reference(*args, bf16)
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
    warp's k share at U = 8 is one k16 slice)."""
    _card()
    props = _build.card("cuda")
    for hid, b in ((512, 16), (512, 96), (512, 200), (128, 40)):
        args = _card_inputs(units + b + hid, b, 20, hid)
        want = fused_gru.gru_seq_fwd_reference(*args, bf16)
        for p in (props, props._replace(sms=hid // units)):
            plan = _plan(hid, b, bf16, p, units=units)
            if plan is None:     # f32 at U = 32, or one group of too many cells per thread
                assert (units == 32 and not bf16) or p is not props
                continue
            _check(_forced(args, bf16, "mma", plan=plan), want, bf16, (units, hid, b, plan))


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's, and the card holds its
    plans at H = 512."""
    _card()
    props = _build.card("cuda")
    lib = fused_gru._fwd_lib()
    for h in (128, 256, 384, 512):
        for units in (4, 8, 16, 32):
            for tiles in (1, 2, 3, 4):
                for bf16 in (False, True):
                    if units == 32 and not bf16:
                        continue
                    assert lib.gru_seq_fwd_mma_smem_bytes(h, units, tiles, int(bf16)) == \
                        fused_rnn.mma_smem_bytes(h, units, tiles, bf16, gates=3)
    for b in (1, 16, 96, 200):
        for bf16 in (False, True):
            assert _plan(512, b, bf16, props) is not None


@pytest.mark.cuda
def test_two_layer_gru_torchrnn_on_the_mma_route():
    """A 2-layer GRU TorchRNN at H = 512, B = 16 on the card against the CPU
    (plain) route: outputs and every gradient within 2e-3 (chip_smoke.py's
    GRAD_TOL), both forward launches on the mma route."""
    _card()
    b, t, h = 16, 24, 512
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(b, t, h)).astype(np.float32))
    m = TorchRNN(h, h, num_layers=2, rnn_type="gru", use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(4))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(h, h, num_layers=2, rnn_type="gru", use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = dict(fused_gru.gru_seq_fwd.route_launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused_gru.gru_seq_fwd.route_launches == {
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
    first = fused_gru.launch_fwd(*args, bf16, "mma")
    _check(first, fused_gru.gru_seq_fwd_reference(*args, bf16), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_gru.launch_fwd(*args, bf16, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))
