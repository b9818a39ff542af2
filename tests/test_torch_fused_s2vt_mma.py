"""The two routes of the port's fused dual-LSTM S2VT forward (ops/fused_s2vt.py,
csrc/fused_s2vt_fwd.cu).

``fused_s2vt_fwd_route(H, B, compute_bf16, device)`` sends the widths and
batches that the "mma" kernel serves and is chosen for to it, and every
other call to the "direct" kernel; the card's properties come in as a
``CardProps`` of plain values here. ``fused_fwd_plan`` lays a launch out:
batch groups of rows, H / U blocks per group, m16 row tiles per pass.

The route forms its float32 gate sums on the CUDA cores in the direct
route's order: for each weight segment and k slice ks in 0..7 one fused
multiply-add chain from 0 over k = ks, ks + 8, ..., the slices added in
order, W2v's before W2hh's for layer 2. ``_direct_order_pre`` follows the
direct kernel's tasks (an item of 4 gates x 4 rows per k slice, its
partials summed by the cell) and ``_mma_order_pre`` the mma kernel's warp
items (lane (ks, q): 8 weight rows x 4 batch rows of slice ks, the partials
in red[ks][n][row]), each
fused multiply-add emulated in float64 and rounded once; the two are held
equal bit for bit, and both, through the cell, to the plain version and to
JAX's ``_run_fwd`` (its Pallas kernel in interpret mode). The bf16 path's
sums (bf16 operands, float32 sums per k16 slice and k share) are emulated
likewise and held to them within the bf16 tolerance.

The ``cuda``-marked tests hold each route to the plain version on the card
(chip_smoke.py's ATOL: 1e-4 in float32, 3e-2 in bf16, whose gates are
stored in bf16), the float32 mma route to the direct route bit for bit, and
check that each call launched once, on its route. The JAX side is imported
by a fixture, so that the card tests also collect where the JAX package
cannot be imported.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import _build, fused_rnn
from s2vt_tpu_torch.ops import fused_s2vt as fs

H100 = fused_rnn.CardProps(132, 232448, 15)   # as an H100 SXM reports
ATOL = {False: 1e-4, True: 3e-2}              # chip_smoke.py's ATOL


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_s2vt)."""
    return tuple(importlib.import_module(n) for n in ("jax.numpy", "s2vt_tpu.ops.pallas_s2vt"))


@pytest.mark.parametrize("hidden,batch,bf16,props,want", [
    (512, 1, False, H100, "mma"), (512, 16, False, H100, "mma"), (512, 96, False, H100, "mma"),
    (512, 1, True, H100, "mma"), (512, 16, True, H100, "mma"), (512, 96, True, H100, "mma"),
    (512, 128, False, H100, "mma"), (512, 128, True, H100, "mma"),
    (512, 200, False, H100, "mma"), (512, 200, True, H100, "mma"),
    (512, 201, False, H100, "direct"), (512, 256, True, H100, "direct"),
    (128, 8, False, H100, "mma"), (256, 33, True, H100, "mma"), (384, 17, False, H100, "mma"),
    (64, 3, False, H100, "direct"), (448, 16, False, H100, "direct"),
    (576, 16, True, H100, "direct"), (1000, 16, False, H100, "direct"),
    (130, 5, False, H100, "direct"),
    # fewer SMs than the blocks of one group (H / 8 at U = 8)
    (512, 16, False, fused_rnn.CardProps(127, 232448, 0), "direct"),
    (512, 16, True, fused_rnn.CardProps(64, 232448, 0), "mma"),
    (512, 16, True, fused_rnn.CardProps(63, 232448, 0), "direct"),
    # shared memory: U = 4 needs 194 KB in float32, 85 KB in bf16
    (512, 16, False, fused_rnn.CardProps(132, 160 * 1024, 15), "direct"),
    (512, 16, True, fused_rnn.CardProps(132, 160 * 1024, 15), "mma"),
    (512, 16, True, fused_rnn.CardProps(132, 80 * 1024, 15), "direct")],
    ids=lambda v: str(v) if not isinstance(v, fused_rnn.CardProps) else
    f"sms{v.sms}-smem{v.smem_optin}")
def test_route_by_width_batch_dtype_and_card(hidden, batch, bf16, props, want):
    assert fs.fused_s2vt_fwd_route(hidden, batch, bf16, props) == want
    assert fs.fused_s2vt_fwd_route(hidden, batch, bf16, _build.Card(*props[:2])) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_the_card_at_every_batch(bf16):
    """At H = 512 every batch from 1 to 200 has a plan on an H100: its
    blocks fit the SMs, its groups cover the batch, a thread runs at most 32
    pairs, and its shared memory fits; float32 has one layout (U = 4, one
    m16 tile per pass), and at the measured batches bf16 runs every row of a
    group in one pass."""
    for b in range(1, 201):
        p = fs.fused_fwd_plan(512, b, bf16, H100)
        assert p is not None, b
        assert p.units in (4, 8)
        assert p.groups * 512 // p.units <= H100.sms
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.tiles * 16 >= p.rows > (p.passes - 1) * p.tiles * 16
        assert p.passes * p.tiles * p.units // 2 <= 32 and 1 <= p.tiles <= 4
        assert fs.fused_fwd_smem_bytes(512, p.units, p.tiles, bf16, p.passes) <= H100.smem_optin
        if not bf16:
            assert (p.units, p.groups, p.tiles) == (4, 1, 1), (b, p)
        elif b in (16, 96):
            assert p.passes == 1, (b, p)


def test_plans_of_the_measured_batches_and_forced_units():
    """B = 16 runs U = 4 in one group of 128 blocks in both modes; bf16 at
    B = 96 U = 8 in two groups of 48 rows (3 m16 tiles, one pass), float32
    U = 4 in six passes of 16 rows; float32 at U = 8 does not fit (its
    weights alone take 197 KB), bf16 at U = 8 is two groups at B = 16."""
    for bf16 in (False, True):
        assert fs.fused_fwd_plan(512, 16, bf16, H100) == (4, 1, 16, 1, 1)
    assert fs.fused_fwd_plan(512, 96, True, H100) == (8, 2, 48, 3, 1)
    assert fs.fused_fwd_plan(512, 96, False, H100) == (4, 1, 96, 1, 6)
    assert fs.fused_fwd_plan(512, 16, False, H100, units=8) is None
    assert fs.fused_fwd_plan(512, 16, True, H100, units=8) == (8, 2, 8, 1, 1)
    assert fs.fused_fwd_plan(512, 96, True, H100, units=4) == (4, 1, 96, 4, 2)
    assert fs.fused_fwd_plan(256, 16, False, H100, units=8) == (8, 4, 4, 1, 1)
    assert fs.fused_fwd_plan(512, 16, True, H100, units=16) is None
    # the smallest bf16 block: U = 4, one tile; c: 2 slots of 256 threads;
    # two buffers of x, 2 layers x 16 rows x 4 gates x 4 units
    assert fs.fused_fwd_smem_bytes(512, 4, 1, True) == 48 * 520 * 2 + 16 * 1032 * 2 + 2048 + 2048
    # float32: weights, staged rows and the slice partials apart; six passes
    assert (fs.fused_fwd_smem_bytes(512, 4, 1, False, 6)
            == 48 * 520 * 4 + 16 * 1032 * 4 + 4 * 8 * 836 + 6 * 2048 + 4096)


# ---------------------------------------------------------------------------
# The routes' arithmetic, emulated in torch


def _fma_chain(w, h):
    """One fused multiply-add chain per row of the last axis: from 0, acc =
    fma(w[..., i], h[..., i], acc) in order, each product and sum formed in
    float64 (the product exactly) and rounded once to float32."""
    acc = torch.zeros(torch.broadcast_shapes(w.shape, h.shape)[:-1], dtype=torch.float32)
    for i in range(w.shape[-1]):
        acc = (w[..., i].double() * h[..., i].double() + acc.double()).float()
    return acc


def _direct_order_pre(z, segs):
    """The direct kernel's float32 gate sums (csrc/fused_s2vt_fwd.cu, the
    direct kernel): a task is (k slice ks, item = (segment, unit, group of 4
    rows)); it forms 4 gates x 4 rows of chains over k = ks + 8 i into
    red[item][gate * 4 + row][ks]; the cell of (layer, row, unit, gate)
    starts from 0 and adds red[.][.][ks] for ks 0..7, segment by segment.
    z [B, 2H] = [h1 | h2]; segs: the three [4H, H] weights. Returns the
    sums of layer 1 and layer 2 [B, 4H] (gate blocks i, f, g, o)."""
    B, H = z.shape[0], z.shape[1] // 2
    nbg = -(-B // 4)
    red = {}
    for seg, w in enumerate(segs):
        h = z[:, H:] if seg == 2 else z[:, :H]
        for ks in range(8):
            for bg in range(nbg):
                rows = [min(bg * 4 + n, B - 1) for n in range(4)]
                hk = h[rows][:, ks::8]                               # [4 rows, H / 8]
                wk = w.reshape(4, H, H)[:, :, ks::8]                 # [gate, unit, H / 8]
                chains = _fma_chain(wk[:, :, None, :], hk[None, None])   # [gate, unit, row]
                for n in range(4):
                    red[(seg, bg, n, ks)] = chains[:, :, n]          # [gate, unit]
    pre = []
    for layer, seg_list in ((0, (0,)), (1, (1, 2))):
        out = torch.zeros(B, 4, H)
        for b in range(B):
            acc = torch.zeros(4, H)
            for seg in seg_list:
                for ks in range(8):
                    acc = acc + red[(seg, b // 4, b % 4, ks)]
            out[b] = acc
        pre.append(out.reshape(B, 4 * H))
    return pre


def _mma_item_chains(units, RP, rows):
    """(n, row, ks) of every chain the warp items of one pass form, in item
    order: an item (segment, unit pair u0, block rb of 16 rows) gives its
    lane (ks = lane % 8, q = lane / 8) the chains of weight rows n0 + g U +
    v (n0 = seg * 4U + u0; gate g, unit u0 + v) and rows rb * 16 + q + 4 j,
    slice ks."""
    out = []
    rblocks = -(-rows // 16)
    for item in range(3 * (units // 2) * rblocks):
        rb, su = item % rblocks, item // rblocks
        seg, u0 = su // (units // 2), 2 * (su % (units // 2))
        n0 = seg * 4 * units + u0
        for lane in range(32):
            ks, q = lane % 8, lane // 8
            out += [(n0 + (a >> 1) * units + (a & 1), rb * 16 + q + 4 * j, ks)
                    for a in range(8) for j in range(4)]
    return torch.tensor(out)


def _mma_order_pre(z, segs, units=4, rp=16):
    """The mma kernel's float32 gate sums (namespace mma_route, the CUDA-core
    path): the block owning units [j0, j0 + U) keeps weight row n = seg * 4U
    + gate * U + u; its items' chains (``_mma_item_chains``, over k = 8 i +
    ks) go to red[n][row][ks] (red[ks][n][row] in the kernel), each exactly
    once; the cell of (layer, row,
    unit, gate) starts from 0 and adds red[n][row][0..7] for each of its
    segments, W2v's before W2hh's. All blocks at once."""
    B, H = z.shape[0], z.shape[1] // 2
    RP, blocks = rp, H // units
    # wsm[blk, n] = W_seg[gate * H + blk * U + u]
    wsm = torch.stack([s.reshape(4, blocks, units, H) for s in segs])   # [seg, gate, blk, u, H]
    wsm = wsm.permute(2, 0, 1, 3, 4).reshape(blocks, 12 * units, H)
    steps = torch.arange(H // 8)
    pre = [torch.zeros(B, 4 * H), torch.zeros(B, 4 * H)]
    for pr0 in range(0, B, RP):
        rows = min(RP, B - pr0)
        hs = torch.zeros(RP, 2 * H)
        hs[:rows] = z[pr0:pr0 + rows]
        n, r, ks = _mma_item_chains(units, RP, rows).unbind(1)
        assert len(set(zip(n.tolist(), r.tolist(), ks.tolist()))) == len(n)
        k = ks[:, None] + 8 * steps                                          # [chains, H / 8]
        h_off = torch.where(n // (4 * units) == 2, H, 0)[:, None]
        chains = _fma_chain(wsm[:, n[:, None], k], hs[r[:, None], h_off + k][None])
        red = torch.full((blocks, 12 * units, RP, 8), float("nan"))
        red[:, n, r, ks] = chains
        for layer, seg_list in ((0, (0,)), (1, (1, 2))):
            acc = torch.zeros(blocks, 4, units, rows)
            for seg in seg_list:
                part = red[:, seg * 4 * units:(seg + 1) * 4 * units, :rows]
                part = part.reshape(blocks, 4, units, rows, 8)
                for q in range(8):
                    acc = acc + part[..., q]
            pre[layer][pr0:pr0 + rows] = acc.permute(3, 1, 0, 2).reshape(rows, 4 * H)
    return pre


def _bf16_mma_pre(z, segs, shares=4):
    """The mma kernel's bf16 gate sums, up to the tensor cores' own order
    inside one m16n8k16: bf16 operands, float32 sums per k16 slice, the
    slices of a k share in order, the shares added in order."""
    B, H = z.shape[0], z.shape[1] // 2
    zb = z.to(torch.bfloat16).double()
    per = H // 16 // shares
    pre = []
    for layer, seg_list in ((0, (0,)), (1, (1, 2))):
        acc = torch.zeros(B, 4 * H)
        for seg in seg_list:
            h = zb[:, H:] if seg == 2 else zb[:, :H]
            w = segs[seg].to(torch.bfloat16).double()
            for k in range(shares):
                part = torch.zeros(B, 4 * H)
                for sl in range(k * per, (k + 1) * per):
                    cols = slice(16 * sl, 16 * sl + 16)
                    part = part + (h[:, cols] @ w[:, cols].T).float()
                acc = acc + part
        pre.append(acc)
    return pre


def _emulated_forward(x1, x2, segs, snap, sums, mmd):
    """fused_s2vt_fwd_reference's recurrence with the gate sums of ``sums``
    (z [B, 2H] -> [pre1, pre2]); the cell in float32 as the kernels run it.
    Returns the reference's ten outputs."""
    T, B, G = x1.shape
    H = G // 4
    h1 = c1 = h2 = c2 = torch.zeros(B, H)
    g1s, g2s = torch.empty(T, B, G, dtype=mmd), torch.empty(T, B, G, dtype=mmd)
    c1s, c2s = torch.empty(T, B, H), torch.empty(T, B, H)
    snap_hc = None
    for t in range(T + 1):
        pre1, pre2 = sums(torch.cat([h1, h2], dim=-1))
        if t < T:
            post, c1, h1 = fs._cell(x1[t].float() + pre1, c1)
            g1s[t], c1s[t] = post, c1
        if t >= 1:
            post, c2, h2 = fs._cell(x2[t - 1].float() + pre2, c2)
            g2s[t - 1], c2s[t - 1] = post, c2
            if t - 1 == snap:
                snap_hc = (h2, c2)
    return g1s, c1s, g2s, c2s, h1, c1, h2, c2, *snap_hc


def _np_inputs(seed, b, t, h):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    x1, x2 = (rng.normal(size=(t, b, 4 * h)).astype(np.float32) for _ in range(2))
    ws = [rng.uniform(-k, k, (4 * h, h)).astype(np.float32) for _ in range(3)]
    return x1, x2, ws


def test_mma_order_equals_the_direct_order_bit_for_bit():
    """The float32 gate sums of the mma route's items equal the direct
    route's, bit for bit, at two widths and batches that leave a partial
    row group (B = 5) and a partial pass (B = 18 at 16 rows per pass)."""
    for hid, b, units in ((128, 5, 4), (128, 18, 8)):
        x1, x2, ws = _np_inputs(hid + b, b, 1, hid)
        segs = [torch.from_numpy(w) for w in ws]
        z = torch.from_numpy(np.random.default_rng(b).normal(size=(b, 2 * hid)).astype(
            np.float32))
        want = _direct_order_pre(z, segs)
        got = _mma_order_pre(z, segs, units=units)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        exact = z[:, :hid].double() @ segs[0].double().T
        assert 0 < (want[0].double() - exact).abs().max() < 1e-5


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("hidden,batch", [(128, 8), (256, 5)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_emulated_routes_match_plain_and_jax(jax_side, hidden, batch, T, bf16):
    """Each route's arithmetic (float32: the direct route's order, which the
    mma route shares; bf16: the mma route's k shares) through the recurrence
    against the plain version and JAX's _run_fwd (its Pallas kernel in
    interpret mode): every output within 1e-4 in float32 and 3e-2 in bf16."""
    jnp, jfused = jax_side
    x1, x2, ws = _np_inputs(hidden * 7 + batch + T, batch, T, hidden)
    mmd = torch.bfloat16 if bf16 else torch.float32
    tx1, tx2, *tws = (torch.from_numpy(a).to(mmd) for a in (x1, x2, *ws))
    snap = T // 2
    segs = [w.float() for w in tws]
    if bf16:   # the plan's k shares: 8 warps over 1.5 U / 3 column groups
        shares = 16 // fs.fused_fwd_plan(hidden, batch, True, H100).units
        sums = lambda z: _bf16_mma_pre(z, segs, shares=shares)  # noqa: E731
    else:
        sums = lambda z: _direct_order_pre(z, segs)  # noqa: E731
    got = _emulated_forward(tx1, tx2, segs, snap, sums, mmd)
    plain = fs.fused_s2vt_fwd_reference(tx1, tx2, *tws, snap)
    jax_out = jfused._run_fwd(jnp.asarray(x1), jnp.asarray(x2),
                              jfused._assemble_wall(*map(jnp.asarray, ws)),
                              snap_idx=snap, compute_bf16=bf16)
    assert len(got) == len(plain) == len(jax_out) == 10
    for g, p, j in zip(got, plain, jax_out):
        assert tuple(g.shape) == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(), atol=ATOL[bf16], rtol=0)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(j, dtype=np.float32),
                                   atol=ATOL[bf16], rtol=0)


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_inputs(seed, b=4, t=5, h=128, mmd=torch.float32):
    x1, x2, ws = _np_inputs(seed, b, t, h)
    return [torch.from_numpy(a).to(mmd) for a in (x1, x2, *ws)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_inputs(1, mmd=torch.bfloat16 if bf16 else torch.float32)
    fn = fs.fused_s2vt_fwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args, 2)
    want = fs.fused_s2vt_fwd_reference(*args, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("batch,bf16,route", [(16, False, "mma"), (96, True, "mma"),
                                              (201, False, "direct")])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, batch, bf16, route):
    """A CUDA-typed tensor (a fake one here, with no card) goes to its route
    and the kernel's build or the card's properties, which raise without
    nvcc or a card; the plain version is never called and no launch is
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fs, "fused_s2vt_fwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(fs._build, "card", lambda device: H100)
    plain_launch = fs.launch_fwd

    def launch(*a, **kw):
        routes.append(a[6])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fs, "launch_fwd", launch)
    fn = fs.fused_s2vt_fwd
    before = (fn.launches, dict(fn.route_launches))
    mmd = torch.bfloat16 if bf16 else torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda", dtype=mmd)
                for a in _cpu_inputs(2, b=batch, t=3, h=512)]
        with pytest.raises((RuntimeError, AssertionError)):
            fs._fused_s2vt_fwd_impl(*args, 1)
    assert called == [] and routes == [route]
    assert (fn.launches, fn.route_launches) == before


def test_variant_tool_changes_one_piece_each():
    """tools/fused_fwd_variants.py finds each piece of the mma route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and keeps every other line."""
    from s2vt_tpu_torch.tools import fused_fwd_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    variants = tool.mma_variants(src)
    assert variants["as_built"] == src
    for name, gone in tool.CHANGED.items():
        got = variants[name]
        assert got != src, name
        for text in gone:
            assert src.count(text) == 1 and text not in got, (name, text)
        assert len(got.splitlines()) == len(src.splitlines()), name


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order,
    and adds only its clock lines; the shipped kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import fused_fwd_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    # The clocks go over c1's first units, which block 0 owns (U >= 4) and
    # writes at step 0, and nowhere outside the launch's own buffers.
    assert "c1[ph] = (float)clk[ph];" in added and "xch[" not in added
    assert len(tool.PHASES) <= min(fs._MMA_UNITS)


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h, bf16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 1.0 / h ** 0.5
    mmd = torch.bfloat16 if bf16 else torch.float32
    x1, x2 = (torch.randn(t, b, 4 * h, device="cuda", generator=gen).to(mmd) for _ in range(2))
    ws = [((torch.rand(4 * h, h, device="cuda", generator=gen) * 2 - 1) * k).to(mmd)
          for _ in range(3)]
    return [x1, x2, *ws]


def _check(got, want, bf16, label):
    g1, c1, g2, c2, fin = got
    for g, w in zip((g1, c1, g2, c2, *fin.unbind(0)), want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g.float()).all(), label
        err = (g.float() - w.float()).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _forced(args, snap, route, plan=None):
    """One launch of ``route`` through launch_fwd; checks that it counted
    once, on that route."""
    fn = fs.fused_s2vt_fwd
    before = dict(fn.route_launches)
    got = fs.launch_fwd(*args, snap, route, plan=plan)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, route: 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 80, 159])
@pytest.mark.parametrize("B", [1, 16, 96, 200])
def test_both_routes_match_plain_on_card(B, T, bf16):
    """H = 512 on the mma route and on the direct route, on the same
    inputs, against the plain version: the gates and c of both layers, the
    finals and the snapshot; and the wrapper's own call on the route
    fused_s2vt_fwd_route names."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512, bf16)
    snap = (T - 1) // 2
    want = fs.fused_s2vt_fwd_reference(*args, snap)
    _check(_forced(args, snap, "mma"), want, bf16, ("mma", B, T, bf16))
    _check(_forced(args, snap, "direct"), want, bf16, ("direct", B, T, bf16))
    route = fs.fused_s2vt_fwd_route(512, B, bf16, "cuda")
    fn = fs.fused_s2vt_fwd
    before = dict(fn.route_launches)
    got = fn(*args, snap)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, route: 1}
    _check((*got[:4], torch.stack(got[4:])), want, bf16, (route, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 96, 128, 200])
def test_float32_mma_route_equals_the_direct_route_bit_for_bit(B):
    """In float32 the mma route forms every gate sum in the direct route's
    order, so the gates, c, the finals and the snapshot are the direct
    route's exactly (the float32 decode checks of chip_smoke.py were set
    against them)."""
    _card()
    args = _card_inputs(B + 7, B, 40, 512, False)
    got = _forced(args, 17, "mma")
    want = _forced(args, 17, "direct")
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (B, i, (g - w).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,B", [(128, 8), (256, 33), (384, 17), (128, 96)])
def test_other_widths_on_the_mma_route(H, B, bf16):
    _card()
    assert fs.fused_s2vt_fwd_route(H, B, bf16, "cuda") == "mma"
    args = _card_inputs(H + B, B, 30, H, bf16)
    want = fs.fused_s2vt_fwd_reference(*args, 11)
    got = _forced(args, 11, "mma")
    _check(got, want, bf16, (H, B, bf16))
    if not bf16:
        direct = _forced(args, 11, "direct")
        assert all(torch.equal(g, w) for g, w in zip(got, direct)), (H, B)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("units", [4, 8])
def test_every_layout_matches_plain_on_card(units, bf16):
    """Every U at every tile count the card holds, at as many groups as the
    card holds and at one group, at B = 16, 96 and 200 (H = 512; float32 at
    U = 8 only at H = 256, where its weights fit)."""
    _card()
    props = _build.card("cuda")
    hid = 256 if units == 8 and not bf16 else 512
    for b in (16, 96, 200):
        args = _card_inputs(units + b, b, 20, hid, bf16)
        want = fs.fused_s2vt_fwd_reference(*args, 5)
        direct = None if bf16 else _forced(args, 5, "direct")
        ran = 0
        for p in (props, props._replace(sms=hid // units)):
            base = fs.fused_fwd_plan(hid, b, bf16, p, units=units)
            if base is None:
                continue
            m_tiles = -(-base.rows // 16)
            for tiles in range(1, 5):
                passes = -(-m_tiles // tiles)
                if (passes * tiles * units // 2 > 32 or fs.fused_fwd_smem_bytes(
                        hid, units, tiles, bf16, passes) > props.smem_optin):
                    continue
                plan = base._replace(tiles=tiles, passes=passes)
                got = _forced(args, 5, "mma", plan=plan)
                _check(got, want, bf16, (units, b, plan))
                if direct is not None:
                    assert all(torch.equal(g, w) for g, w in zip(got, direct)), (units, b, plan)
                ran += 1
        assert ran, (units, b)


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's, and the card holds its
    plans at H = 512."""
    _card()
    props = _build.card("cuda")
    lib = fs._kernel_lib()
    for h in (128, 256, 384, 512):
        for units in (4, 8):
            for tiles in (1, 2, 3, 4):
                for bf16 in (False, True):
                    for passes in (1, 2, 6):
                        assert lib.s2vt_fused_fwd_mma_smem_bytes(
                            h, units, tiles, passes, int(bf16)) == \
                            fs.fused_fwd_smem_bytes(h, units, tiles, bf16, passes)
    for b in (1, 16, 96, 200):
        for bf16 in (False, True):
            assert fs.fused_fwd_plan(512, b, bf16, props) is not None


@pytest.mark.cuda
def test_training_step_through_the_mma_route():
    """s2vt_fused_out2 at H = 512, B = 16 in float32 on the card against the
    CPU (plain) route: the output and every input's gradient (the backward
    kernel reads the forward's gates and c) within 2e-3 (chip_smoke.py's
    GRAD_TOL); the forward launch on the route its wrapper names."""
    _card()
    b, t, h = 16, 23, 512
    rng = np.random.default_rng(5)
    k = 1.0 / np.sqrt(h)
    leaves = [rng.normal(size=(t, b, 4 * h)).astype(np.float32) for _ in range(2)]
    leaves += [rng.uniform(-k, k, (4 * h, h)).astype(np.float32) for _ in range(3)]
    res = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in leaves]
        before = dict(fs.fused_s2vt_fwd.route_launches)
        out = fs.s2vt_fused_out2(*ts, compute_bf16=False)
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            route = fs.fused_s2vt_fwd_route(h, b, False, "cuda")
            assert fs.fused_s2vt_fwd.route_launches == {
                **before, route: before[route] + 1}
        res[dev] = [out.detach().cpu()] + [a.grad.cpu() for a in ts]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_repeated_launches_on_two_streams(bf16):
    """20 launches on each of two streams, in flight together: every result
    equals the first, so no launch reads another's words or stale state."""
    _card()
    args = _card_inputs(99, 16, 80, 512, bf16)
    first = fs.launch_fwd(*args, 40, "mma")
    _check(first, fs.fused_s2vt_fwd_reference(*args, 40), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fs.launch_fwd(*args, 40, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))
