"""The two routes of the port's per-layer LSTM forward (ops/fused_rnn.py,
csrc/lstm_seq_fwd.cu).

``lstm_seq_fwd_route(H, B, compute_bf16, device)`` sends the widths and
batches that the "mma" kernel serves and is chosen for to it, and every
other call to the "direct" kernel; the card's properties come in as a
``CardProps`` of plain values here. ``mma_plan`` lays a launch out: batch
groups of rows, H / U blocks per group, m16 row tiles per pass.
The route forms its float32 gate sums on the CUDA cores in the direct
route's order (lane-strided fused multiply-adds, then the warp
reduce-scatter), so that its float32 results are the direct route's bit for
bit; ``test_emulated_direct_order_matches_plain_and_jax`` runs that order in
numpy. The tensor-core float32 path the variant tool measures (3xTF32 with
big rounded to TF32, the tensor cores' truncating sums, a fresh partial per
k slice joined by a round-to-nearest add, the k shares summed in order) is
emulated by ``test_emulated_mma_arithmetic_matches_plain_and_jax``. Both are
held to the plain version and to JAX's ``_run_forward`` (its Pallas kernel
in interpret mode) within chip_smoke.py's SEQ_ATOL.

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

from s2vt_tpu_torch.ops import fused_rnn
from s2vt_tpu_torch.ops.rnn import TorchRNN

H100 = fused_rnn.CardProps(132, 232448, 15)   # as an H100 SXM reports
ATOL = {False: 1e-4, True: 1.5e-3}            # chip_smoke.py's SEQ_ATOL


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_rnn)."""
    return tuple(importlib.import_module(n) for n in ("jax.numpy", "s2vt_tpu.ops.pallas_rnn"))


@pytest.mark.parametrize("hidden,batch,bf16,props,want", [
    (512, 1, False, H100, "mma"), (512, 16, False, H100, "mma"), (512, 96, False, H100, "mma"),
    (512, 1, True, H100, "mma"), (512, 16, True, H100, "mma"), (512, 96, True, H100, "mma"),
    (512, 97, False, H100, "mma"), (512, 128, False, H100, "mma"), (512, 128, True, H100, "mma"),
    (512, 129, False, H100, "direct"), (512, 200, False, H100, "direct"),
    (512, 200, True, H100, "direct"), (512, 256, True, H100, "direct"),
    (128, 8, False, H100, "mma"), (256, 33, True, H100, "mma"), (384, 17, False, H100, "mma"),
    (64, 3, False, H100, "direct"), (448, 16, False, H100, "direct"),
    (576, 16, True, H100, "direct"), (1000, 16, False, H100, "direct"),
    (1024, 16, True, H100, "direct"), (130, 5, False, H100, "direct"),
    # fewer SMs than the blocks of one group (H / 32 at U = 32, H / 16 at U = 16)
    (512, 16, False, fused_rnn.CardProps(31, 232448, 0), "direct"),
    (512, 16, False, fused_rnn.CardProps(32, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(16, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(15, 232448, 0), "direct"),
    # shared memory: U = 4 needs 71 KB in float32 at B = 16
    (512, 16, False, fused_rnn.CardProps(132, 60 * 1024, 15), "direct"),
    (512, 16, True, fused_rnn.CardProps(132, 60 * 1024, 15), "mma")],
    ids=lambda v: str(v) if not isinstance(v, fused_rnn.CardProps) else
    f"sms{v.sms}-smem{v.smem_optin}")
def test_route_by_width_batch_dtype_and_card(hidden, batch, bf16, props, want):
    assert fused_rnn.lstm_seq_fwd_route(hidden, batch, bf16, props) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_the_card_at_every_batch(bf16):
    """At H = 512 every batch up to 256 has a plan on an H100: its blocks fit
    the SMs, its groups cover the batch, a thread runs at most 16 pairs, and
    its shared memory fits; at the measured batches every row of a group
    runs in one pass."""
    for b in range(1, 257):
        p = fused_rnn.mma_plan(512, b, bf16, H100)
        assert p is not None, b
        assert p.units in (4, 8, 16) + ((32,) if bf16 else ())
        assert p.groups * 512 // p.units <= H100.sms
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.tiles * 16 >= p.rows > (p.passes - 1) * p.tiles * 16
        assert p.passes * p.tiles * p.units // 4 <= 16 and 1 <= p.tiles <= 4
        assert fused_rnn.mma_smem_bytes(512, p.units, p.tiles, bf16) <= H100.smem_optin
        if b in (16, 96):      # the batches the route was measured at: one pass
            assert p.passes == 1, (b, p)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_register_arrays_of_every_served_layout(bf16):
    """What a thread of the mma route keeps in registers, at every layout a
    served batch can get: the products' accumulators (4 m16 tiles of its n8
    tiles, 4 floats each), 16 exchange loads in flight (two 8-byte words
    each) or the cells' x_proj, gates and h, and 16 pairs' cell index and c;
    within the 255 registers of a thread, so that a build without spills is
    possible."""
    for b in range(1, 257):
        p = fused_rnn.mma_plan(512, b, bf16, H100)
        n_tiles = 4 * p.units // 8
        per_warp = max(1, n_tiles // 8)
        assert n_tiles // per_warp <= 8 and 8 % (n_tiles // per_warp) == 0
        acc = 4 * per_warp * 4
        words = max(16 * 2 * 2, 4 * 16)
        cells = 2 * 16
        assert acc + words + cells <= 160, (b, p)


def test_plans_of_the_measured_batches_and_forced_units():
    """B = 16 runs U = 4 in one group of 128 blocks; B = 96 U = 8 in two
    groups of 48 rows (3 m16 tiles, one pass); a forced U lays out as many
    groups as the card holds; at U = 4 the card holds one group of 128
    blocks, each reading every row (in two passes at B = 96); one group of
    96 rows at U = 16 would need 24 pairs per thread, more than the route
    holds."""
    for bf16 in (False, True):
        assert fused_rnn.mma_plan(512, 16, bf16, H100) == (4, 1, 16, 1, 1)
        assert fused_rnn.mma_plan(512, 96, bf16, H100) == (8, 2, 48, 3, 1)
    p = fused_rnn.mma_plan(512, 96, False, H100, units=16)
    assert (p.units, p.groups, p.rows, p.tiles, p.passes) == (16, 4, 24, 2, 1)
    one = fused_rnn.mma_plan(512, 96, False, H100, units=4)
    assert (one.groups, one.rows, one.tiles, one.passes) == (1, 96, 4, 2)
    assert fused_rnn.mma_plan(512, 96, False, H100._replace(sms=32), units=16) is None
    assert fused_rnn.mma_plan(512, 16, False, H100, units=32) is None    # f32 W at U = 32
    assert fused_rnn.mma_plan(512, 16, True, H100, units=32).groups == 8


# ---------------------------------------------------------------------------
# The route's float32 arithmetic in numpy


def _tf32(x):
    """x as the tensor cores read a float32 operand: its upper 19 bits."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xffffe000)).view(
        np.float32)


def _rna(x):
    """x rounded to TF32, to nearest with ties away from zero (mma.cuh's
    tf32_rna)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split(x, rounded=True):
    """split_tf32 (big = x rounded to TF32) or, with ``rounded`` False,
    split_trunc (big = x passed whole, read as _tf32(x)); small = x - big,
    exact in float32; both as the tensor cores read them."""
    x = np.asarray(x, np.float32)
    big = _rna(x) if rounded else _tf32(x)
    return big, _tf32(x - big)


def _f32_toward_zero(x):
    """float64 x to float32, truncating: how an mma.sync adds into its
    accumulator."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _emulated_gate_sums(h, w_rows, shares, kstep=8):
    """h [B, K] @ w_rows [N, K]^T as the mma route forms it in float32: per
    k share (in order), per k slice of 8 a fresh partial of the three TF32
    products (small*big, big*small, big*big) accumulated with truncation,
    joined to the share's sum by a round-to-nearest float32 add."""
    hb, hs = _split(h)
    wb, ws = _split(w_rows)
    per = h.shape[1] // kstep // shares
    total = np.zeros((h.shape[0], w_rows.shape[0]), np.float32)
    for share in range(shares):
        acc = np.zeros_like(total)
        for sl in range(share * per, (share + 1) * per):
            ks = slice(sl * kstep, (sl + 1) * kstep)
            part = np.zeros_like(total)
            for a, b in ((hs, wb), (hb, ws), (hb, wb)):
                prod = a[:, ks].astype(np.float64) @ b[:, ks].T.astype(np.float64)
                part = _f32_toward_zero(part.astype(np.float64) + prod)
            acc = acc + part
        total = total + acc
    return total


def _fma32(a, b, c):
    """fmaf in numpy: a * b exact in float64, one rounding to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


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


def _direct_order_gate_sums(h, w_rows):
    """h [B, K] @ w_rows [N, K]^T as the direct route (and the mma route in
    float32) forms it: per gate row and 4 batch rows, lane l sums k = l +
    32 i in order by fused multiply-adds, then the warp reduce-scatter."""
    B, K = h.shape
    N = w_rows.shape[0]
    out = np.zeros((B, N), np.float32)
    rows = -(-B // 4) * 4
    hp = np.concatenate([h, np.repeat(h[-1:], rows - B, 0)]) if rows > B else h
    for u in range(N // 4):
        for bg in range(rows // 4):
            hs = hp[bg * 4:bg * 4 + 4].reshape(4, K // 32, 32)        # [n, i, lane]
            ws = w_rows[u * 4:u * 4 + 4].reshape(4, K // 32, 32)      # [g, i, lane]
            acc = np.zeros((32, 16), np.float32)                      # [lane, 4 g + n]
            for i in range(K // 32):
                prod_w = np.repeat(ws[:, i, :].T, 4, axis=1)          # [lane, g*4+n] -> w_g
                prod_h = np.tile(hs[:, i, :].T, (1, 4))               # [lane, g*4+n] -> h_n
                acc = _fma32(prod_w, prod_h, acc)
            sums = _reduce_scatter16(acc)                             # [4 g + n]
            for g in range(4):
                for n in range(4):
                    if bg * 4 + n < B:
                        out[bg * 4 + n, u * 4 + g] = sums[4 * g + n]
    return out


def _emulated_forward(xp, w, h0, c0, shares, sums=None):
    """The mma route's float32 forward over T steps, in numpy: gate sums by
    ``sums(h, w)`` (default: the 3xTF32 path with ``shares`` k shares)."""
    sig = lambda v: np.float32(1) / (np.float32(1) + np.exp(-v))   # noqa: E731
    h, c = h0, c0
    hid = h0.shape[1]
    outs, gseq, cseq = [], [], []
    # the kernel's gate rows: row 4 u + g is W_hh row g H + u
    w_rows = w.reshape(4, hid, -1).transpose(1, 0, 2).reshape(4 * hid, -1)
    for t in range(xp.shape[0]):
        if sums is None:
            pre = _emulated_gate_sums(h, w, shares) + xp[t]
        else:
            per_unit = sums(h, w_rows)                                # [B, 4 u + g]
            pre = per_unit.reshape(-1, hid, 4).transpose(0, 2, 1).reshape(-1, 4 * hid) + xp[t]
        i, f, g, o = (pre[:, k * hid:(k + 1) * hid] for k in range(4))
        i, f, g, o = sig(i), sig(f), np.tanh(g), sig(o)
        c = f * c + i * g
        h = o * np.tanh(c)
        outs.append(h)
        gseq.append(np.concatenate([i, f, g, o], axis=1))
        cseq.append(c)
    return np.stack(outs), np.stack(gseq), np.stack(cseq), h, c


@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5)])
def test_emulated_mma_arithmetic_matches_plain_and_jax(jax_side, hidden, batch):
    """The route's float32 arithmetic, with the k shares of the plan's U,
    against the plain version and JAX's _run_forward: h, gates, c and the
    finals within 1e-4 (SEQ_ATOL)."""
    jnp, jrnn = jax_side
    rng = np.random.default_rng(hidden + batch)
    T = 6
    k = 1.0 / np.sqrt(hidden)
    xp = rng.normal(size=(T, batch, 4 * hidden)).astype(np.float32)
    w = rng.uniform(-k, k, (4 * hidden, hidden)).astype(np.float32)
    h0, c0 = ((0.5 * rng.normal(size=(batch, hidden))).astype(np.float32) for _ in range(2))
    plan = fused_rnn.mma_plan(hidden, batch, False, H100)
    n_tiles = plan.units // 2
    shares = 8 // (n_tiles // max(1, n_tiles // 8))
    got = _emulated_forward(xp, w, h0, c0, shares)
    plain = fused_rnn.lstm_seq_fwd_reference(*map(torch.from_numpy, (xp, w, h0, c0)), False)
    jax_out = jrnn._run_forward(*map(jnp.asarray, (xp, w.T, h0, c0)), compute_bf16=False)
    for g, p, j in zip(got, plain, jax_out):
        assert g.shape == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g, p.numpy(), atol=ATOL[False], rtol=0)
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL[False], rtol=0)
    # the emulation is not the plain sum: the truncations do show
    sums = _emulated_gate_sums(h0, w, shares)
    exact = h0.astype(np.float64) @ w.T.astype(np.float64)
    assert 0 < np.abs(sums - exact).max() < 1e-5


@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5)])
def test_emulated_direct_order_matches_plain_and_jax(jax_side, hidden, batch):
    """The route's float32 arithmetic (the direct route's order, emulated
    lane by lane) against the plain version and JAX's _run_forward: within
    1e-4 (SEQ_ATOL), and within a few float32 roundings of the plain
    version."""
    jnp, jrnn = jax_side
    rng = np.random.default_rng(hidden * 3 + batch)
    T = 4
    k = 1.0 / np.sqrt(hidden)
    xp = rng.normal(size=(T, batch, 4 * hidden)).astype(np.float32)
    w = rng.uniform(-k, k, (4 * hidden, hidden)).astype(np.float32)
    h0, c0 = ((0.5 * rng.normal(size=(batch, hidden))).astype(np.float32) for _ in range(2))
    got = _emulated_forward(xp, w, h0, c0, 1, sums=_direct_order_gate_sums)
    plain = fused_rnn.lstm_seq_fwd_reference(*map(torch.from_numpy, (xp, w, h0, c0)), False)
    jax_out = jrnn._run_forward(*map(jnp.asarray, (xp, w.T, h0, c0)), compute_bf16=False)
    for g, p, j in zip(got, plain, jax_out):
        assert g.shape == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g, p.numpy(), atol=ATOL[False], rtol=0)
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL[False], rtol=0)
        assert np.abs(g - p.numpy()).max() < 2e-6


def test_split_is_exact_and_truncates():
    """big + small is the float32 value exactly; the tensor cores' reads of
    them lose at most ~2^-21 of it. With big rounded, small takes either
    sign, so the small x small terms that 3xTF32 drops cancel over k; with
    big passed whole, small has the value's sign and they add up."""
    x = np.random.default_rng(0).normal(size=100000).astype(np.float32)
    for rounded in (True, False):
        big, small = _split(x, rounded)
        exact_small = x - (_rna(x) if rounded else _tf32(x))
        assert np.array_equal((_rna(x) if rounded else _tf32(x)) + exact_small, x)
        assert np.abs((big.astype(np.float64) + small) - x).max() <= np.abs(x).max() * 2.0 ** -20
    assert np.all(_split(x, False)[1] * x >= 0)
    assert 0.4 < np.mean(_split(x, True)[1] * x > 0) < 0.6


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_inputs(seed, b=4, t=5, h=128):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    xp, h0, c0 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((t, b, 4 * h), (b, h), (b, h)))
    w = torch.from_numpy(rng.uniform(-k, k, (4 * h, h)).astype(np.float32))
    return xp, w, h0, c0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_inputs(1)
    fn = fused_rnn.lstm_seq_fwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args, bf16)
    want = fused_rnn.lstm_seq_fwd_reference(*args, bf16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("batch,bf16,route", [(16, False, "mma"), (96, True, "mma"),
                                              (200, False, "direct")])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, batch, bf16, route):
    """A CUDA-typed tensor (a fake one here, with no card) goes to its route
    and the kernel's build or the card's properties, which raise without
    nvcc or a card; the plain version is never called and no launch is
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fused_rnn, "lstm_seq_fwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(fused_rnn, "card_props", lambda device: H100)
    plain_launch = fused_rnn.launch_fwd

    def launch(*a, **kw):
        routes.append(a[5])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fused_rnn, "launch_fwd", launch)
    fn = fused_rnn.lstm_seq_fwd
    before = (fn.launches, dict(fn.route_launches))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda") for a in _cpu_inputs(2, b=batch, t=3, h=512)]
        with pytest.raises((RuntimeError, AssertionError)):
            fused_rnn._lstm_seq_fwd_impl(*args, bf16)
    assert called == [] and routes == [route]
    assert (fn.launches, fn.route_launches) == before


def test_variant_tool_changes_one_piece_each():
    """tools/lstm_fwd_variants.py finds each piece of each route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and nothing else."""
    from s2vt_tpu_torch.tools import lstm_fwd_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    direct, mma = tool.direct_variants(src), tool.mma_variants(src)
    assert direct["as_built"] == src and mma["as_built"] == src
    for got, name, gone in ((direct, "no_barrier", tool._BARRIER),
                            (direct, "own_slice", tool._READ),
                            (direct, "no_products", tool._PRODUCTS),
                            (direct, "one_pass", tool._PASSES),
                            (mma, "no_poll", tool._POLL),
                            (mma, "late_xp", tool._EARLY),
                            (mma, "early_xp", tool._EARLY),
                            (mma, "cp_async", tool._XV_LOAD),
                            (mma, "cp_async", tool._SMEM_TAIL),
                            (mma, "tf32x3", tool._F32_CORES),
                            (mma, "group1", tool._GROUP),
                            *((mma, "one_sum", p) for p in tool._PASSES_TF32),
                            (mma, "one_sum", tool._JOIN),
                            (mma, "fast_act", tool._SIGMOID),
                            (mma, "fast_act", tool._ACT),
                            (mma, "fast_act", tool._TANH_C),
                            (mma, "no_stores", tool._GATES_STORE),
                            (mma, "no_stores", tool._H_STORE),
                            (mma, "no_products", tool._MMA_PRODUCTS),
                            (mma, "no_products", tool._CORE_PRODUCTS)):
        assert src.count(gone) == 1 and gone not in got[name] and got[name] != src, name
        if name != "cp_async":
            assert len(got[name].splitlines()) == len(src.splitlines()), name
    sleep = mma["poll_sleep"]
    assert "__nanosleep" not in src and sleep.count("__nanosleep(100);") == 1
    assert sleep.replace("  __nanosleep(100);\n", "") == src


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order,
    and adds only its clock lines; the shipped kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import lstm_fwd_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    assert f"xch[{tool._TAIL} + ph]" in added and tool.TAIL_WORDS >= len(tool.PHASES)


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 1.0 / h ** 0.5
    xp = torch.randn(t, b, 4 * h, device="cuda", generator=gen)
    w = (torch.rand(4 * h, h, device="cuda", generator=gen) * 2 - 1) * k
    h0, c0 = (0.5 * torch.randn(b, h, device="cuda", generator=gen) for _ in range(2))
    return xp, w, h0, c0


def _check(got, want, bf16, label):
    outs, gates, cseq, fin = got
    for g, w in zip((outs, gates, cseq, fin[0], fin[1]), want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g).all(), label
        err = (g - w).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _forced(args, bf16, route):
    """One launch of ``route`` through launch_fwd; checks that it counted
    once, on that route."""
    fn = fused_rnn.lstm_seq_fwd
    before = dict(fn.route_launches)
    got = fused_rnn.launch_fwd(*args, bf16, route)
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
    inputs, against the plain version: h, gates, c and the finals; and the
    wrapper's own call on the route lstm_seq_fwd_route names."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512)
    want = fused_rnn.lstm_seq_fwd_reference(*args, bf16)
    _check(_forced(args, bf16, "mma"), want, bf16, ("mma", B, T, bf16))
    _check(_forced(args, bf16, "direct"), want, bf16, ("direct", B, T, bf16))
    route = fused_rnn.lstm_seq_fwd_route(512, B, bf16, "cuda")
    fn = fused_rnn.lstm_seq_fwd
    before = dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    _check((got[0], got[1], got[2], torch.stack(got[3:])), want, bf16, (route, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 96, 128, 200])
def test_float32_mma_route_equals_the_direct_route_bit_for_bit(B):
    """In float32 the mma route forms every gate sum in the direct route's
    order, so h, the gates, c and the finals are the direct route's exactly
    (the float32 decode checks of chip_smoke.py were set against them)."""
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
    assert fused_rnn.lstm_seq_fwd_route(H, B, bf16, "cuda") == "mma"
    args = _card_inputs(H + B, B, 30, H)
    _check(_forced(args, bf16, "mma"), fused_rnn.lstm_seq_fwd_reference(*args, bf16), bf16,
           (H, B, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("units", [4, 8, 16, 32])
def test_every_layout_matches_plain_on_card(units, bf16):
    """Every instantiated U (32 in bf16 only), at as many groups as the card
    holds and at one group, at B = 96 and 200."""
    _card()
    props = fused_rnn.card_props("cuda")
    for b in (96, 200):
        args = _card_inputs(units + b, b, 20, 512)
        want = fused_rnn.lstm_seq_fwd_reference(*args, bf16)
        for p in (props, props._replace(sms=512 // units)):
            plan = fused_rnn.mma_plan(512, b, bf16, p, units=units)
            if plan is None:     # f32 at U = 32, or one group of too many pairs per thread
                assert (units == 32 and not bf16) or p is not props
                continue
            got = fused_rnn.launch_fwd(*args, bf16, "mma", plan=plan)
            torch.cuda.synchronize()
            _check(got, want, bf16, (units, b, plan))


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's, and the card holds its
    plans at H = 512."""
    _card()
    props = fused_rnn.card_props("cuda")
    lib = fused_rnn._fwd_lib()
    for h in (128, 256, 384, 512):
        for units in (4, 8, 16, 32):
            for tiles in (1, 2, 3, 4):
                for bf16 in (False, True):
                    if units == 32 and not bf16:
                        continue
                    assert lib.lstm_seq_fwd_mma_smem_bytes(h, units, tiles, int(bf16)) == \
                        fused_rnn.mma_smem_bytes(h, units, tiles, bf16)
    for b in (1, 16, 96, 200):
        for bf16 in (False, True):
            assert fused_rnn.mma_plan(512, b, bf16, props) is not None


@pytest.mark.cuda
def test_two_layer_torchrnn_on_the_mma_route():
    """A 2-layer TorchRNN at H = 512, B = 16 on the card against the CPU
    (plain) route: outputs and every gradient within 2e-3 (chip_smoke.py's
    GRAD_TOL), both forward launches on the mma route."""
    _card()
    b, t, h = 16, 24, 512
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(b, t, h)).astype(np.float32))
    m = TorchRNN(h, h, num_layers=2, use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(4))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(h, h, num_layers=2, use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = dict(fused_rnn.lstm_seq_fwd.route_launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused_rnn.lstm_seq_fwd.route_launches == {
                "mma": before["mma"] + 2, "direct": before["direct"],
                "stream": before["stream"]}
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_beam_on_the_mma_route():
    """S2VT.beam at H = 512, B = 16 on the card: both encode launches on the
    mma route, and the CPU (plain) route's beams."""
    _card()
    from s2vt_tpu_torch.models import S2VT
    model = S2VT(vocab_size=64, feat_dim=32, length=12, dim_hid=512, dim_embed=512,
                 use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(16))
    feats = torch.from_numpy(np.random.default_rng(17).normal(size=(16, 12, 32)).astype(
        np.float32))
    want = model.eval().beam(feats, 3, 8)
    before = dict(fused_rnn.lstm_seq_fwd.route_launches)
    got = model.cuda().beam(feats.cuda(), 3, 8)
    assert fused_rnn.lstm_seq_fwd.route_launches == {"mma": before["mma"] + 2,
                                                     "direct": before["direct"],
                                                     "stream": before["stream"]}
    np.testing.assert_array_equal(got.tokens.cpu().numpy(), want.tokens.numpy())
    np.testing.assert_allclose(got.scores.cpu().numpy(), want.scores.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_repeated_launches_on_two_streams(bf16):
    """20 launches on each of two streams, in flight together: every result
    equals the first, so no launch reads another's words or stale state."""
    _card()
    args = _card_inputs(99, 16, 80, 512)
    first = fused_rnn.launch_fwd(*args, bf16, "mma")
    _check(first, fused_rnn.lstm_seq_fwd_reference(*args, bf16), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_rnn.launch_fwd(*args, bf16, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))
