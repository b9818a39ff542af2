"""The two routes of the port's fused dual-LSTM S2VT backward (ops/fused_s2vt.py,
csrc/fused_s2vt_bwd.cu).

``fused_s2vt_bwd_route(H, B, compute_bf16, device)`` sends the widths and
batches that the "mma" kernel serves and was measured faster at to it, and
every other call to the "direct" kernel; the card's properties come in as a
``BwdCard`` of plain values here. ``fused_bwd_plan`` lays a launch out: batch
groups of rows, H / U blocks per group in thread-block clusters of C blocks
that split the k range of the products, rows per pass.

The route runs in bf16 alone (float32 takes the direct route at every batch).
Its sums (bf16 operands; per rank, per warp share of its k16 slices one
float32 partial per weight segment, the slices added in order; the shares
added in order, the ranks in rank order) are emulated in numpy and run
through the recurrence against the plain version and JAX's ``_run_bwd`` (its
Pallas kernel in interpret mode) within chip_smoke.py's bf16 ATOL, 3e-2
(the gate gradients are stored in bf16).

The ``cuda``-marked tests hold each route to the plain version on the card
within chip_smoke.py's ATOL (1e-4 in float32, 3e-2 in bf16) and check that
each call launched once, on its route. The JAX side is
imported by a fixture, so that the card tests also collect where the JAX
package cannot be imported.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops import fused_s2vt as fs

H100 = fs.BwdCard(132, 232448, (66, 30))        # as an H100 SXM reports
ATOL = {False: 1e-4, True: 3e-2}                # chip_smoke.py's ATOL


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_s2vt)."""
    return tuple(importlib.import_module(n) for n in ("jax.numpy", "s2vt_tpu.ops.pallas_s2vt"))


def _plan(hidden, batch, bf16, props=H100, units=None, cluster=None):
    return fs.fused_bwd_plan(hidden, batch, bf16, props, units=units, cluster=cluster)


@pytest.mark.parametrize("hidden,batch,bf16,props,want", [
    (512, 1, False, H100, "direct"), (512, 4, False, H100, "direct"), (512, 5, False, H100, "direct"),
    (512, 16, False, H100, "direct"), (512, 96, False, H100, "direct"),
    (512, 200, False, H100, "direct"),
    (512, 1, True, H100, "mma"), (512, 16, True, H100, "mma"), (512, 33, True, H100, "mma"),
    (512, 96, True, H100, "mma"), (512, 200, True, H100, "mma"),
    (512, 201, True, H100, "direct"), (512, 256, True, H100, "direct"),
    (128, 8, True, H100, "mma"), (256, 33, True, H100, "mma"), (384, 17, True, H100, "mma"),
    (384, 3, False, H100, "direct"), (128, 2, False, H100, "direct"),
    (64, 3, True, H100, "direct"), (448, 16, True, H100, "direct"),
    (576, 16, True, H100, "direct"), (130, 2, False, H100, "direct"),
    # fewer SMs: 64 blocks of 8 units in clusters of 4 still fit, 63 SMs do not
    (512, 16, True, fs.BwdCard(64, 232448, (32, 16)), "mma"),
    (512, 16, True, fs.BwdCard(63, 232448, (31, 15)), "direct"),
    (512, 2, True, fs.BwdCard(63, 232448, (31, 15)), "direct"),
    # no clusters of 4: clusters of 2; too little shared memory: none
    (512, 16, True, H100._replace(clusters=(66, 0)), "mma"),
    (512, 16, True, H100._replace(smem_optin=100 * 1024), "direct")],
    ids=lambda v: str(v) if not isinstance(v, fs.BwdCard) else
    f"sms{v.sms}-smem{v.smem_optin}-clusters{'.'.join(map(str, v.clusters))}")
def test_route_by_width_batch_dtype_and_card(hidden, batch, bf16, props, want):
    assert fs.fused_s2vt_bwd_route(hidden, batch, bf16, props) == want


@pytest.mark.parametrize("hidden", [256, 512])
def test_plan_fits_the_card_at_every_batch(hidden):
    """In bf16 every batch from 1 to 200 has a plan on an H100: U = 8, its
    blocks fit the SMs and its clusters the co-resident clusters, its groups
    cover the batch, its passes the group's rows, a thread runs at most 4
    cells per pass, and its shared memory fits. float32 has none."""
    for b in range(1, 201):
        p = _plan(hidden, b, True)
        assert p is not None, b
        assert _plan(hidden, b, False) is None
        blocks = p.groups * hidden // p.units
        assert p.units == 8 and p.cluster in (2, 4)
        assert blocks <= H100.sms and blocks // p.cluster <= H100.clusters[(2, 4).index(p.cluster)]
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.pass_rows >= p.rows > (p.passes - 1) * p.pass_rows
        assert p.pass_rows % 16 == 0 and p.pass_rows <= 48
        assert -(-2 * p.pass_rows * p.units // 256) <= 4
        assert fs.fused_bwd_smem_bytes(hidden, p.units, p.cluster, p.pass_rows,
                                       p.passes) <= H100.smem_optin


def test_smem_of_the_backward_layout():
    """The block's weights are 12 H U bf16 values (the cluster's C U dh1
    rows over 2 Kh and dh2 rows over Kh, Kh = 4H / C, each padded by 8), its
    staged rows 8H / C values padded by 8 (at least the warps' k shares of
    the sums, rows of 2 C U + 4 floats), the pushed partials [2][C][rows]
    [2][U] in float32, then the carries and the 7 input words of each cell
    slot of 256 threads; at least 120 KiB."""
    assert fs.fused_bwd_smem_bytes(512, 8, 4, 16) == \
        (32 * 1032 + 32 * 520) * 2 + 16 * 1032 * 2 + 4 * 2 * 4 * 16 * 2 * 8 + 4 * 256 + 4 * 7 * 256
    assert fs.fused_bwd_smem_bytes(512, 8, 4, 48, 3) == \
        (32 * 1032 + 32 * 520) * 2 + 48 * 1032 * 2 + 4 * 2 * 4 * 48 * 2 * 8 + 4 * 3 * 768 \
        + 4 * 7 * 768
    assert fs.fused_bwd_smem_bytes(512, 8, 2, 16, 7) == \
        (16 * 2056 + 16 * 1032) * 2 + 16 * 2056 * 2 + 4 * 2 * 2 * 16 * 2 * 8 + 4 * 7 * 256 \
        + 4 * 7 * 256
    # H = 128, U = 4, C = 4: the k shares of the sums (8 warps' rows of 2 C U
    # + 4 floats) take more than the staged rows; the whole is under 120 KiB
    shares = 4 * 8 * 16 * (2 * 16 + 4)
    assert shares > 16 * (2 * 128 + 8) * 2
    assert fs.fused_bwd_smem_bytes(128, 4, 4, 16) == 120 * 1024
    assert (16 * 264 + 16 * 136) * 2 + shares + 4 * 2 * 4 * 16 * 2 * 4 + 8 * 256 * 4 < 120 * 1024


def test_plans_of_the_measured_batches_and_forced_layouts():
    """bf16 takes U = 8 in clusters of 4, one group in one pass, up to B =
    32, then clusters of 2 in two groups in passes of 16 rows (the layouts
    the layouts run measured fastest); float32 has no plan; a forced layout
    lays out as many groups as the SMs and clusters hold (U = 4 for the
    variant tool's build); the card's SMs, shared memory and clusters bound
    the plan."""
    assert _plan(512, 1, True) == (8, 4, 1, 1, 16, 1)
    assert _plan(512, 16, True) == (8, 4, 1, 16, 16, 1)
    assert _plan(512, 32, True) == (8, 4, 1, 32, 32, 1)
    assert _plan(512, 33, True) == (8, 2, 2, 17, 16, 2)
    assert _plan(512, 96, True) == (8, 2, 2, 48, 16, 3)
    assert _plan(512, 200, True) == (8, 2, 2, 100, 16, 7)
    assert _plan(512, 16, False) is None and _plan(512, 16, False, units=8, cluster=2) is None
    assert _plan(512, 16, True, units=8, cluster=4) == (8, 4, 1, 16, 16, 1)
    assert _plan(512, 96, True, units=8, cluster=4) == (8, 4, 1, 96, 16, 6)
    assert _plan(512, 16, True, units=4, cluster=2) == (4, 2, 1, 16, 16, 1)
    assert _plan(512, 16, True, units=4, cluster=4) is None     # 128 blocks > 30 clusters of 4
    assert _plan(512, 16, True, units=8, cluster=1) is None     # no clusters of 1
    assert _plan(512, 16, True, H100._replace(sms=63, clusters=(31, 15))) is None
    assert _plan(512, 16, True, H100._replace(sms=64, clusters=(32, 16)))[:3] == (8, 4, 1)
    assert _plan(512, 16, True, H100._replace(clusters=(66, 0)))[1] == 2
    assert _plan(512, 16, True, H100._replace(smem_optin=100 * 1024)) is None
    assert _plan(448, 16, True) is None and _plan(640, 16, True) is None
    for b in (1, 16, 96, 200):
        p = _plan(512, b, True)
        assert p.passes == -(-p.rows // p.pass_rows)


# ---------------------------------------------------------------------------
# The route's arithmetic in numpy


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even) and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _mma_bf16_parts(a1, a2, w1, wv, w2, H, C, U):
    """The bf16 sums as the mma route forms them: operands rounded to bf16;
    rank c takes k in [c Kh, (c + 1) Kh) of each half (Kh = 4H / C); its
    warps' k shares (8 / max(1, C U / 16) of them) each keep one float32
    partial per weight segment to which each k16 slice's 16 exact products
    are added (one rounding per slice); a share's dh1 is its W1hh partial
    plus its W2v partial; the shares added in order. Returns the C ranks'
    parts of dh1 and of dh2, added to dout in rank order by the cell."""
    kh = 4 * H // C
    cu = C * U
    shares = 8 // (cu // 16 if cu >= 32 else 1)
    per = kh // 16 // shares
    a1b, a2b = (_bf16(x).astype(np.float64) for x in (a1, a2))
    w1b, wvb, w2b = (_bf16(x).astype(np.float64) for x in (w1, wv, w2))
    parts1, parts2 = [], []
    for c in range(C):
        tot1 = tot2 = None
        for share in range(shares):
            acc = [np.zeros((a1.shape[0], H), np.float32) for _ in range(3)]
            for sl in range(share * per, (share + 1) * per):
                ks = slice(c * kh + sl * 16, c * kh + (sl + 1) * 16)
                acc[0] = (acc[0] + a1b[:, ks] @ w1b[ks]).astype(np.float32)
                acc[1] = (acc[1] + a2b[:, ks] @ wvb[ks]).astype(np.float32)
                acc[2] = (acc[2] + a2b[:, ks] @ w2b[ks]).astype(np.float32)
            d1 = acc[0] + acc[1]
            tot1 = d1 if tot1 is None else tot1 + d1
            tot2 = acc[2] if tot2 is None else tot2 + acc[2]
        parts1.append(tot1)
        parts2.append(tot2)
    return parts1, parts2


def _cell_bwd(gi, gf, gg, go, cc, cp, dh, carry):
    """The kernels' cell backward in float32 (nvcc's contractions aside)."""
    one = np.float32(1)
    tc = np.tanh(cc)
    dcv = carry + dh * go * (one - tc * tc)
    d = np.concatenate([dcv * gg * gi * (one - gi), dcv * cp * gf * (one - gf),
                        dcv * gi * (one - gg * gg), dh * tc * go * (one - go)], axis=-1)
    return d, dcv * gf


def _emulated_backward(g1, c1, g2, c2, dout2, w1, wv, w2, parts, mmd):
    """The route's reverse sweep in numpy: iteration it runs layer 2 at t2 =
    T-1-it and layer 1 at t1 = T-it from the sums of the previous
    iteration's gate gradients (rounded to the matmul dtype ``mmd``), dh =
    dout (0 for layer 1) plus each part in order. Returns (dxp1, dxp2)
    float32, as stored in ``mmd``."""
    T, B, G = g1.shape
    H = G // 4
    rnd = _bf16 if mmd == "bf16" else (lambda x: np.asarray(x, np.float32))
    dxp1, dxp2 = np.zeros_like(g1), np.zeros_like(g2)
    dg1 = dg2 = np.zeros((B, G), np.float32)
    carry1 = carry2 = np.zeros((B, H), np.float32)
    zero = np.zeros((B, H), np.float32)

    def run(g, c, t, dh, carry):
        gi, gf, gg, go = (g[t][:, i * H:(i + 1) * H] for i in range(4))
        return _cell_bwd(gi, gf, gg, go, c[t], c[t - 1] if t >= 1 else zero, dh, carry)

    for it in range(T + 1):
        p1, p2 = parts(dg1, dg2)
        dh1, dh2 = zero.copy(), None
        for p in p1:
            dh1 = dh1 + p
        if it <= T - 1:
            t2 = T - 1 - it
            dh2 = dout2[t2]
            for p in p2:
                dh2 = dh2 + p
            d, carry2 = run(g2, c2, t2, dh2, carry2)
            dg2 = rnd(d)
            dxp2[t2] = dg2
        if it >= 1:
            t1 = T - it
            d, carry1 = run(g1, c1, t1, dh1, carry1)
            dg1 = rnd(d)
            dxp1[t1] = dg1
    return dxp1, dxp2


def _np_inputs(seed, b, t, h, mmd):
    """(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh) float32 numpy arrays from a
    forward run of the plain version (gates and c are real LSTM states);
    the gates and weights rounded to ``mmd``."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    dt = torch.bfloat16 if mmd == "bf16" else torch.float32
    x1, x2 = (torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(np.float32)).to(dt)
              for _ in range(2))
    ws = [torch.from_numpy(rng.uniform(-k, k, (4 * h, h)).astype(np.float32)).to(dt)
          for _ in range(3)]
    g1, c1, g2, c2 = fs.fused_s2vt_fwd_reference(x1, x2, *ws, t - 1)[:4]
    dout2 = rng.normal(size=(t, b, h)).astype(np.float32)
    return (g1.float().numpy(), c1.numpy(), g2.float().numpy(), c2.numpy(), dout2,
            *(w.float().numpy() for w in ws))


def _against_plain_and_jax(jax_side, got, args, mmd):
    jnp, jfused = jax_side
    dt = torch.bfloat16 if mmd == "bf16" else torch.float32
    targs = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 5, 6, 7):
        targs[i] = targs[i].to(dt)
    plain = fs.fused_s2vt_bwd_reference(*targs)
    jdt = jnp.bfloat16 if mmd == "bf16" else jnp.float32
    g1, c1, g2, c2, dout2, w1, wv, w2 = args
    zero = np.zeros_like(c1[:1])
    wb1, wb2 = jfused._assemble_wb(*(jnp.asarray(w).astype(jdt) for w in (w1, wv, w2)))
    jax_out = jfused._run_bwd(jnp.asarray(g1).astype(jdt), jnp.asarray(c1),
                              jnp.asarray(np.concatenate([zero, c1[:-1]])),
                              jnp.asarray(g2).astype(jdt), jnp.asarray(c2),
                              jnp.asarray(np.concatenate([zero, c2[:-1]])), jnp.asarray(dout2),
                              wb1, wb2, compute_bf16=mmd == "bf16")
    bf16 = mmd == "bf16"
    for g, p, j in zip(got, plain, jax_out):
        assert g.shape == tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(g, p.float().numpy(), atol=ATOL[bf16], rtol=0)
        np.testing.assert_allclose(g, np.asarray(j, np.float32), atol=ATOL[bf16], rtol=0)
    return plain


@pytest.mark.parametrize("hidden,batch,C,U", [(128, 8, 4, 8), (128, 3, 2, 8), (256, 5, 4, 8),
                                              (256, 4, 2, 8), (384, 6, 2, 8)])
def test_emulated_mma_bf16_arithmetic_matches_plain_and_jax(jax_side, hidden, batch, C, U):
    """The route's bf16 arithmetic (k split over the C ranks, the warps' k
    shares, one partial per weight segment) against the plain version and
    JAX's _run_bwd within 3e-2 (ATOL; the gate gradients are stored in
    bf16); its sums are not the plain version's exact float32 sums."""
    args = _np_inputs(hidden * 3 + batch, batch, 5, hidden, "bf16")
    w1, wv, w2 = args[5:]
    got = _emulated_backward(*args, parts=lambda a1, a2: _mma_bf16_parts(
        a1, a2, w1, wv, w2, hidden, C, U), mmd="bf16")
    _against_plain_and_jax(jax_side, got, args, "bf16")
    a = args[0][0]
    exact = _bf16(a).astype(np.float64) @ _bf16(w1).astype(np.float64)
    parts = _mma_bf16_parts(a, a, w1, np.zeros_like(wv), w2, hidden, C, U)[0]
    assert 0 < np.abs(sum(parts) - exact).max() < 1e-5


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_inputs(seed, b=4, t=5, h=128, mmd="f32"):
    args = [torch.from_numpy(a) for a in _np_inputs(seed, b, t, h, mmd)]
    if mmd == "bf16":
        for i in (0, 2, 5, 6, 7):
            args[i] = args[i].bfloat16()
    return args


@pytest.mark.parametrize("mmd", ["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(mmd):
    args = _cpu_inputs(1, mmd=mmd)
    fn = fs.fused_s2vt_bwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args)
    want = fs.fused_s2vt_bwd_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("batch,mmd", [(1, "f32"), (16, "f32"), (16, "bf16"), (96, "bf16"),
                                       (256, "f32")])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, batch, mmd):
    """A CUDA-typed tensor (a fake one here, with no card) goes to the route
    fused_s2vt_bwd_route names and to the kernel's build, which raises
    without nvcc or a card; the plain version is never called and no launch
    is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fs, "fused_s2vt_bwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(fs, "bwd_card", lambda device: H100)
    plain_launch = fs.launch_bwd

    def launch(*a, **kw):
        routes.append(a[8])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fs, "launch_bwd", launch)
    fn = fs.fused_s2vt_bwd
    before = (fn.launches, dict(fn.route_launches))
    dt = torch.bfloat16 if mmd == "bf16" else torch.float32
    H, T = 512, 3
    with FakeTensorMode(allow_non_fake_inputs=True):
        shapes = [(T, batch, 4 * H), (T, batch, H)] * 2 + [(T, batch, H)] + [(4 * H, H)] * 3
        dtypes = [dt, torch.float32, dt, torch.float32, torch.float32, dt, dt, dt]
        args = [torch.empty(s, device="cuda", dtype=d) for s, d in zip(shapes, dtypes)]
        with pytest.raises((RuntimeError, AssertionError, OSError)):
            fn(*args)
    assert called == []
    assert routes == [fs.fused_s2vt_bwd_route(H, batch, mmd == "bf16", H100)]
    assert (fn.launches, fn.route_launches) == before


def test_variant_tool_changes_one_piece_each():
    """tools/fused_bwd_variants.py finds each piece of the mma route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and nothing else (the line
    count kept; inputs_after_poll moves the cells' input copies after the
    poll)."""
    import difflib
    from s2vt_tpu_torch.tools import fused_bwd_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    got = tool.mma_variants(src)
    assert got["as_built"] == src
    edits = {"no_poll": 1, "no_stores": 1, "no_products": 1, "no_push": 1, "dc_unfused": 1,
             "dg_unfused": 1, "bf16_unpacked": 5}
    assert set(got) == {"as_built", "phase_clock", "inputs_after_poll", *edits}
    for name, n in edits.items():
        assert got[name] != src and len(got[name].splitlines()) == len(src.splitlines()), name
        diff = [d for d in difflib.ndiff(src.splitlines(), got[name].splitlines())
                if d[:2] in ("- ", "+ ")]
        assert len(diff) == 2 * n, (name, diff)
    moved = got["inputs_after_poll"]
    assert sorted(moved.splitlines()) == sorted(src.splitlines()) and moved != src
    assert moved.index(tool._IN_START) > moved.index(tool._STAGED_SYNC)
    assert src.index(tool._IN_START) < src.index(tool._STAGED_SYNC)


def test_variant_tool_layout_build_adds_units4():
    """The layouts run's second build differs from the source in the entry
    point alone: it accepts U = 4 beside U = 8 and launches its
    instantiation; the shipped source launches U = 8 alone."""
    import difflib
    from s2vt_tpu_torch.tools import fused_bwd_variants as tool
    src = tool.kernel_source()
    got = tool.layout_sources(src)
    assert got["as_built"] == src and set(got) == {"as_built", "units4"}
    assert "launch<4>" not in src and src.count("launch<8>(") == 1
    diff = [d for d in difflib.ndiff(src.splitlines(), got["units4"].splitlines())
            if d[:2] in ("- ", "+ ")]
    assert len(diff) == 4, diff
    assert "mma_route::launch<4>" in got["units4"] and "U != 8 && U != 4" in got["units4"]
    assert {u for u, _ in tool.LAYOUTS} == set(fs._BWD_UNITS) | {4}
    assert {c for _, c in tool.LAYOUTS} == set(fs._BWD_CLUSTERS)


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order, and
    adds only its clock lines; it writes its sums over dxp1[0, 0, (p % 4) H
    + 2 (p / 4)] (units 0-3 of gates 0-3 of row 0 at step 0), which block 0
    alone writes (it owns U >= 4 units), not past any allocation; the
    shipped kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import fused_bwd_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    assert "dxp1 + (size_t)(ph % 4) * H + 2 * (ph / 4)" in added
    assert len(tool.PHASES) <= 8 and min({u for u, _ in tool.LAYOUTS}) >= 4
    assert "xch[" not in added and "dxp2" not in added


def test_variant_tool_l2_bytes_follow_the_plan():
    """The tool prints the operand bytes all blocks read per iteration from
    the plan: at B = 16 (U = 8, C = 4) a quarter of the direct route's bf16
    bytes, at B = 96 (U = 8, C = 2) half of them; the direct route reads
    twice the bytes in float32."""
    from s2vt_tpu_torch.tools import fused_bwd_variants as tool
    assert tool.l2_bytes(16, False) == 128 * 16 * 4096 * 4
    assert tool.l2_bytes(16, True, _plan(512, 16, True)) == 64 * 16 * 1024 * 4
    assert tool.l2_mib(16, True) == "16.00 MiB" and tool.l2_mib(16, False) == "32.00 MiB"
    assert tool.l2_mib(16, True, _plan(512, 16, True, units=8, cluster=4)) == "4.00 MiB"
    assert tool.l2_mib(96, True, _plan(512, 96, True)) == "48.00 MiB"
    assert tool.l2_mib(96, True) == "96.00 MiB"


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h, bf16):
    """The backward's inputs on the card from a forward kernel run of
    random weights (real LSTM states), dout2 random."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    k = 1.0 / h ** 0.5
    x1, x2 = (torch.randn(t, b, 4 * h, device="cuda", generator=gen).to(dt) for _ in range(2))
    ws = [((torch.rand(4 * h, h, device="cuda", generator=gen) * 2 - 1) * k).to(dt)
          for _ in range(3)]
    g1, c1, g2, c2 = fs.fused_s2vt_fwd(x1, x2, *ws, t - 1)[:4]
    return g1, c1, g2, c2, torch.randn(t, b, h, device="cuda", generator=gen), *ws


def _check(got, want, bf16, label):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g.float()).all(), label
        err = (g.float() - w.float()).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _forced(args, route, plan=None):
    """One launch of ``route`` through launch_bwd; checks that it counted
    once, on that route."""
    fn = fs.fused_s2vt_bwd
    before = dict(fn.route_launches)
    got = fs.launch_bwd(*args, route, plan=plan)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, route: 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 3, 159])
@pytest.mark.parametrize("B", [1, 16, 96, 200])
def test_both_routes_match_plain_on_card(B, T, bf16):
    """H = 512 on the mma route (bf16; float32 it refuses) and on the direct
    route, on the same inputs, against the plain version: dxp1 and dxp2;
    and the wrapper's own call on the route fused_s2vt_bwd_route names."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512, bf16)
    want = fs.fused_s2vt_bwd_reference(*args)
    if bf16:
        _check(_forced(args, "mma"), want, bf16, ("mma", B, T, bf16))
    else:
        with pytest.raises(ValueError):
            fs.launch_bwd(*args, "mma")
    _check(_forced(args, "direct"), want, bf16, ("direct", B, T, bf16))
    route = fs.fused_s2vt_bwd_route(512, B, bf16, "cuda")
    assert route == ("mma" if bf16 else "direct")
    fn = fs.fused_s2vt_bwd
    before = dict(fn.route_launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, route: 1}
    _check(got, want, bf16, (route, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("units,cluster", [(8, 2), (8, 4)])
def test_every_layout_matches_plain_on_card(units, cluster):
    """Every layout the plan takes (U = 8 in clusters of 2 and of 4), at the
    groups the card holds, at B = 16, 96 and 200, H = 512, and at B = 40, H
    = 128."""
    _card()
    props = fs.bwd_card("cuda")
    for hid, b in ((512, 16), (512, 96), (512, 200), (128, 40)):
        plan = _plan(hid, b, True, props, units=units, cluster=cluster)
        assert plan is not None, (units, cluster, hid, b)
        args = _card_inputs(units + b + hid + cluster, b, 20, hid, True)
        _check(_forced(args, "mma", plan=plan), fs.fused_s2vt_bwd_reference(*args), True,
               (units, cluster, hid, b, plan))


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's; the card holds its plans
    at H = 512 at every checked bf16 batch."""
    _card()
    lib = fs._bwd_kernel_lib()
    for h in (128, 256, 384, 512):
        for units, cluster in ((4, 2), (4, 4), (8, 2), (8, 4)):
            for rows in (16, 32, 48):
                for passes in (1, 3):
                    assert lib.s2vt_fused_bwd_mma_smem_bytes(h, units, cluster, rows, passes) == \
                        fs.fused_bwd_smem_bytes(h, units, cluster, rows, passes)
    props = fs.bwd_card("cuda")
    assert props.clusters[0] >= props.clusters[1] > 0
    for b in (1, 16, 96, 200):
        assert _plan(512, b, True, props) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_training_step_through_the_routed_backward(bf16):
    """The 1-layer S2VT core's autograd Function at H = 512, B = 16, T = 159:
    the loss and every gradient against the plain route (the CPU) within
    chip_smoke.py's GRAD_TOL (2e-3 + 2e-3 |g|), the backward launched once,
    on the route fused_s2vt_bwd_route names."""
    _card()
    T, B, H = 159, 16, 512
    rng = np.random.default_rng(7)
    k = 1.0 / np.sqrt(H)
    x1, x2 = (torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32))
              for _ in range(2))
    ws = [torch.from_numpy(rng.uniform(-k, k, (4 * H, H)).astype(np.float32)) for _ in range(3)]
    res = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).clone().requires_grad_() for t in (x1, x2, *ws)]
        before = dict(fs.fused_s2vt_bwd.route_launches)
        loss = fs.s2vt_fused_out2(*leaves, compute_bf16=bf16).square().mean()
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            route = fs.fused_s2vt_bwd_route(H, B, bf16, "cuda")
            assert {k: fs.fused_s2vt_bwd.route_launches[k] - before[k] for k in before} == \
                {"mma": 0, "direct": 0, route: 1}
        res[dev] = [loss.detach().cpu()] + [t.grad.cpu() for t in leaves]
    assert abs(res["cuda"][0].item() - res["cpu"][0].item()) <= 1e-4
    for g, w in zip(res["cuda"][1:], res["cpu"][1:]):
        assert ((g - w).abs() <= 2e-3 + 2e-3 * w.abs()).all()


@pytest.mark.cuda
def test_repeated_launches_on_two_streams():
    """20 mma launches on each of two streams, in flight together: every
    result equals the first, so no launch reads another's words or stale
    state."""
    _card()
    args = _card_inputs(99, 16, 80, 512, True)
    first = fs.launch_bwd(*args, "mma")
    _check(first, fs.fused_s2vt_bwd_reference(*args), True, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fs.launch_bwd(*args, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))


class _FakeLib:
    """The entry points fused_shapes_ok reads of the two libraries."""

    def __init__(self, fwd_smem=150_000, bwd_smem=100_352):
        self.fwd_smem, self.bwd_smem = fwd_smem, bwd_smem

    def s2vt_fused_fwd_smem_bytes(self, hidden, units):
        return self.fwd_smem

    def s2vt_fused_bwd_smem_bytes(self, hidden):
        return self.bwd_smem

    def s2vt_fused_bwd_units_per_block(self):
        return 4


@pytest.mark.parametrize("sms,smem,bwd_smem,want", [
    (132, 232448, 100_352, True),     # an H100: both direct routes fit
    (100, 232448, 100_352, False),    # 128 direct backward blocks > 100 SMs
    (132, 232448, 240_000, False),    # the direct backward, which float32 takes, does not fit
    (132, 110 * 1024, 100_352, False)])   # the direct forward, which B > 200 takes, does not fit
def test_fused_shapes_ok_reads_the_routed_kernels(monkeypatch, sms, smem, bwd_smem, want):
    """On a card, fused_shapes_ok accepts the 1-layer LSTM model at H = 512
    when the kernel every route rule sends some batch to fits: the direct
    forward (every batch above 200) and the direct backward (every float32
    batch); the mma routes take only shapes their plans fit, whatever the
    card."""
    lib = _FakeLib(bwd_smem=bwd_smem)
    monkeypatch.setattr(fs, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(fs, "_bwd_kernel_lib", lambda: lib)
    monkeypatch.setattr(_build, "card", lambda device: _build.Card(sms, smem))
    assert fs.fused_shapes_ok(512, 1, "lstm", torch.device("cuda")) is want
    assert not fs.fused_shapes_ok(512, 2, "lstm", torch.device("cuda"))
