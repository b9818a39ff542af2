"""The two routes of the port's attention-decoder loop (ops/fused_att_decode.py,
csrc/att_decode_fwd.cu).

``att_decode_fwd_route(H, L, B, compute_bf16, device)`` sends the widths,
lengths and batches that the "mma" route serves and is chosen for to it, and
every other call to the "direct" kernel; the card's properties come in as a
``_build.Card`` of plain values here. ``att_decode_plan`` lays an mma launch
out: batch groups of rows, H / U blocks per group, m16 row tiles per pass,
and whether the group's slice of P = [enc_out; ctx0] @ W_ctx^T and the
block's score pairs' enc_wh rows stay in shared memory.

The route folds the context product out of the loop: its first launch forms
P (bf16 operands on m16n8k16, or 3xTF32 on m16n8k8 with a fresh partial per
k8 slice), then every step's gates take sum_l a_t[b, l] P[b, l, :] in place
of ctx_t @ W_ctx^T. ``test_emulated_route_matches_plain_and_jax`` runs that
arithmetic in numpy (P as the kernel forms it, the h products in the warps'
k shares, the fold's four lanes, the softmax every block forms) against the
plain version and JAX's ``_kernel`` (its Pallas kernel in interpret mode, as
tests/test_torch_fused_att_decode.py runs it), at that file's shapes and
tolerances (float32 2e-5, bf16 0.05).

The ``cuda``-marked tests hold each route to the plain version on the card
(chip_smoke.py's ATOL: 1e-4 in float32, 3e-2 in bf16) and check that each
call launched once, on its route. The JAX side is imported by a fixture, so
that the card tests also collect where the JAX package cannot be imported.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops import fused_att_decode as fad

H100 = _build.Card(132, 232448)                 # as an H100 SXM reports
SHAPES = [(7, 8, 128, 16), (8, 8, 128, 16), (5, 16, 128, 8), (5, 3, 20, 6)]
EMU_ATOL = {False: 2e-5, True: 0.05}            # tests/test_torch_fused_att_decode.py
ATOL = {False: 1e-4, True: 3e-2}                # chip_smoke.py's ATOL


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_att_decode)."""
    return tuple(importlib.import_module(n) for n in
                 ("jax.numpy", "s2vt_tpu.ops.pallas_att_decode"))


def _plan(hidden, batch, bf16, props=H100, units=None, enc_len=80):
    return fad.att_decode_plan(hidden, enc_len, batch, bf16, props, units=units)


@pytest.mark.parametrize("hidden,enc_len,batch,bf16,props,want", [
    (512, 80, 1, False, H100, "mma"), (512, 80, 16, False, H100, "mma"),
    (512, 80, 96, False, H100, "mma"), (512, 80, 200, False, H100, "mma"),
    (512, 80, 16, True, H100, "mma"), (512, 80, 96, True, H100, "mma"),
    (512, 80, 200, True, H100, "mma"),
    (512, 80, 201, False, H100, "direct"), (512, 80, 256, True, H100, "direct"),
    # widths and lengths the sweep did not measure, which the plan serves
    (128, 16, 8, False, H100, "direct"), (256, 24, 33, True, H100, "direct"),
    (384, 8, 17, False, H100, "direct"),
    # widths and lengths it does not serve
    (500, 80, 16, False, H100, "direct"), (640, 80, 16, True, H100, "direct"),
    (1024, 6, 8, False, H100, "direct"), (20, 6, 3, False, H100, "direct"),
    (512, 79, 16, False, H100, "direct"), (128, 1, 4, True, H100, "direct"),
    # a smaller card: fewer SMs than the 64 blocks of one group at U = 8
    (512, 80, 16, False, _build.Card(63, 232448), "direct"),
    (512, 80, 16, True, _build.Card(64, 232448), "mma"),
    # a card with 99 KiB a block: only bf16 fits one block (P streamed)
    (512, 80, 16, False, _build.Card(132, 101376), "direct"),
    (512, 80, 16, True, _build.Card(132, 101376), "mma")],
    ids=lambda v: str(v) if not isinstance(v, tuple) else f"sms{v.sms}-smem{v.smem_optin}")
def test_route_by_width_length_batch_dtype_and_card(hidden, enc_len, batch, bf16, props, want):
    assert fad.att_decode_fwd_route(hidden, enc_len, batch, bf16, props) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_fits_the_card_at_every_batch(bf16):
    """At H = 512, L = 80 every batch up to 256 has a plan on an H100 at the
    U the source instantiates for it (8; 16 in bf16 from B = 80): its
    blocks fit the SMs, its groups cover the batch, its passes of m16 tiles
    cover a group's rows, and its shared memory fits."""
    for b in range(1, 257):
        p = _plan(512, b, bf16)
        assert p is not None, b
        assert p.units == (16 if bf16 and b >= 80 else 8)
        assert p.groups * 512 // p.units <= H100.sms
        assert p.groups * p.rows >= b > (p.groups - 1) * p.rows
        assert p.passes * p.tiles * 16 >= p.rows > (p.passes - 1) * p.tiles * 16
        assert 1 <= p.tiles <= 4 and p.tiles * 16 <= max(16, -(-p.rows // 16) * 16)
        assert fad.att_mma_smem_bytes(512, 80, p.units, p.rows, p.tiles, p.p_resident,
                                      p.e_resident, bf16) <= H100.smem_optin


def test_smem_of_the_layout():
    """The block's parts, each rounded up to 16 bytes: 5U weight rows padded
    to whole n8 tiles and the staged h rows in the operand type (rows padded
    by 16 bytes), 8 k shares (one per warp) of (5U padded + 4) floats per
    staged row, the h part and x_proj [R, 4U], P's slice [R, L, 4U] and the
    pairs' enc_wh rows [Q, H] where resident, the dw rows of up to `span`
    rows, w_apply, the attention weights [R, L] and c [R, U]."""
    # f32, U = 8, R = 8 (B = 16 in two groups): Q = 10 pairs spanning 2 rows.
    assert fad.att_mma_smem_bytes(512, 80, 8, 8, 1, True, True, False) == (
        40 * 516 * 4 + 8 * 516 * 4 + 8 * 8 * 44 * 4 + 2 * 8 * 32 * 4 + 8 * 80 * 32 * 4
        + 10 * 512 * 4 + 2 * 512 * 4 + 512 * 4 + 8 * 80 * 4 + 8 * 8 * 4) == 223744
    # bf16, U = 4 (24 padded columns), R = 16 staged in one tile; nothing resident.
    assert fad.att_mma_smem_bytes(512, 80, 4, 16, 1, False, False, True) == (
        24 * 520 * 2 + 16 * 520 * 2 + 8 * 16 * 28 * 4 + 2 * 16 * 16 * 4 + 2 * 512 * 4
        + 512 * 4 + 16 * 80 * 4 + 16 * 4 * 4)
    # U = 16: k shares of 84 floats; R = 1, L = 6: every 16-byte rounding shows.
    assert fad.att_mma_smem_bytes(128, 6, 16, 1, 1, True, True, False) == (
        80 * 132 * 4 + 132 * 4 + 8 * 1 * 84 * 4 + 2 * 64 * 4 + 6 * 64 * 4 + 1 * 128 * 4
        + 128 * 4 + 128 * 4 + 32 + 64)
    # passes of m16 tiles stage at most 16 * tiles rows, and never more than R
    two = fad.att_mma_smem_bytes(512, 80, 8, 48, 2, False, False, False)
    three = fad.att_mma_smem_bytes(512, 80, 8, 48, 3, False, False, False)
    assert three - two == 16 * 516 * 4 + 8 * 16 * 44 * 4
    assert fad.att_mma_smem_bytes(512, 80, 8, 8, 4, False, False, False) == \
        fad.att_mma_smem_bytes(512, 80, 8, 8, 1, False, False, False)


def test_plans_of_the_measured_batches_and_forced_units():
    """B = 16 splits into two groups of 8 rows at U = 8 with P's slice and the
    pairs' enc_wh rows resident; B = 96 streams P (48 rows x 80 x 32 floats
    do not fit) in two groups in float32, in bf16 from B = 80 four groups at
    U = 16 (the measured U); a forced U lays out as many groups as the card
    holds; where no layout fits, no plan."""
    assert _plan(512, 16, False) == (8, 2, 8, 1, 1, True, True)
    assert _plan(512, 16, True) == (8, 2, 8, 1, 1, True, True)
    p = _plan(512, 96, False)
    assert (p.units, p.groups, p.rows, p.p_resident) == (8, 2, 48, False)
    assert _plan(512, 64, True)[:3] == (8, 2, 32)
    assert _plan(512, 80, True)[:3] == (16, 4, 20)
    assert _plan(512, 96, True)[:5] == (16, 4, 24, 2, 1)
    assert _plan(512, 200, True).units == 16 and _plan(512, 200, False).units == 8
    assert _plan(512, 16, False, units=4)[:3] == (4, 1, 16)
    assert _plan(512, 16, True, units=16)[:3] == (16, 4, 4)
    assert _plan(512, 96, False, units=16) is None          # 80 f32 weight rows + a pass
    assert _plan(512, 16, False, H100._replace(sms=63), units=8) is None
    assert _plan(512, 16, False, H100._replace(sms=64)) == (8, 1, 16, 1, 1, False, True)


# ---------------------------------------------------------------------------
# The route's arithmetic in numpy


def _f32(x):
    return np.asarray(x, np.float32)


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even) and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _tf32_split(x):
    """mma.cuh's split_tf32 as the tensor cores read it: big = x rounded to
    TF32 (ties away), small = x - big truncated to TF32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    small = (np.ascontiguousarray(x, np.float32) - big).view(np.uint32)
    return big, (small & np.uint32(0xffffe000)).view(np.float32)


def _mma_sum(a, w, bf16, shares=1):
    """a [M, K] @ w [N, K]^T as the kernels' tensor-core products form it: k
    in slices (16 of bf16 operands; 8 of 3xTF32 terms, each slice's three
    products a fresh partial), each slice's exact sum added to a float32
    partial of its k share, the shares (of equal k ranges) added in order."""
    k = a.shape[1]
    step = 16 if bf16 else 8
    pad = -(-k // (step * shares)) * step * shares - k
    a = np.pad(a, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, 0), (0, pad)))
    if bf16:
        terms = [(_bf16(a).astype(np.float64), _bf16(w).astype(np.float64))]
    else:
        (ab, asm), (wb, wsm) = _tf32_split(a), _tf32_split(w)
        terms = [(t.astype(np.float64), u.astype(np.float64))
                 for t, u in ((asm, wb), (ab, wsm), (ab, wb))]
    per = a.shape[1] // step // shares
    total = None
    for share in range(shares):
        acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
        for sl in range(share * per, (share + 1) * per):
            ks = slice(sl * step, (sl + 1) * step)
            acc = _f32(acc + sum(t[:, ks] @ u[:, ks].T for t, u in terms))
        total = acc if total is None else _f32(total + acc)
    return total


def _emulated_route(args, bf16, shares=8):
    """The mma route's loop in numpy: P and ctx0's rows of it from the
    fold's product, each step's h products (W_hh's 4 gate rows and W_att's
    row per unit) in the warps' ``shares`` k shares, dw and the scores, the
    softmax over L, the fold sum_l a P in four lanes (l = q mod 4, lanes
    added pairwise), the gates and the cell. Returns the h sequence."""
    xp, wc, wh, wa, ba, wap, ewh, eout, ctx0 = args
    T, B, G = xp.shape
    H, L = G // 4, eout.shape[1]
    p = _mma_sum(np.concatenate([eout.reshape(B * L, 2 * H), ctx0]), wc, bf16)
    pl, p0 = p[:B * L].reshape(B, L, G), p[B * L:]
    ewh_r = _bf16(ewh) if bf16 else ewh
    sig = lambda v: _f32(1) / (_f32(1) + np.exp(-v))   # noqa: E731
    c = np.zeros((B, H), np.float32)
    hpart = np.zeros((B, G), np.float32)
    outs = []
    for t in range(T):
        if t == 0:
            fold = p0
        else:
            lanes = [np.einsum("bl,blg->bg", a[:, q::4].astype(np.float64),
                               pl[:, q::4].astype(np.float64)).astype(np.float32)
                     for q in range(4)]
            fold = _f32(_f32(lanes[0] + lanes[1]) + _f32(lanes[2] + lanes[3]))
        pre = _f32(_f32(xp[t] + fold) + hpart)
        ig, fg = sig(pre[:, :H]), sig(pre[:, H:2 * H])
        gg, og = np.tanh(pre[:, 2 * H:3 * H]), sig(pre[:, 3 * H:])
        c = _f32(fg * c + ig * gg)
        h = _f32(og * np.tanh(c))
        outs.append(h)
        sums = _mma_sum(h, np.concatenate([wh, wa]), bf16, shares)
        hpart, dw = sums[:, :G], _f32(sums[:, G:] + ba)
        et = np.sum(np.tanh(_f32(ewh_r + dw[:, None, :])) * wap, axis=2, dtype=np.float32)
        e = np.exp(_f32(et - et.max(axis=1, keepdims=True)))
        a = _f32(e / e.sum(axis=1, keepdims=True, dtype=np.float32))
    return np.stack(outs)


def _np_inputs(T, B, H, L, seed=0):
    """The nine inputs in the port's layout, float32 numpy, scaled as
    tests/test_pallas_att_decode.py scales its own."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return [n(T, B, 4 * H), n(4 * H, 2 * H), n(4 * H, H), n(H, H), n(H), n(H), n(B, L, H),
            n(B, L, 2 * H), n(B, 2 * H)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H,L", SHAPES)
def test_emulated_route_matches_plain_and_jax(jax_side, T, B, H, L, bf16):
    """The route's arithmetic against the plain version and JAX's _kernel
    (interpret mode), in 8 k shares; float32 within 2e-5, bf16 within
    0.05."""
    jnp, jatt = jax_side
    args = _np_inputs(T, B, H, L, seed=T + B + H + L)
    got = _emulated_route(args, bf16)
    plain = fad.att_decode_fwd_reference(*map(torch.from_numpy, args), bf16).numpy()
    xp, wc, wh, wa, *rest = args
    want = np.asarray(jatt.att_decode_sequence_pallas(
        *[jnp.asarray(a) for a in (xp, wc.T, wh.T, wa.T, *rest)],
        compute_dtype=jnp.bfloat16 if bf16 else None))
    assert got.shape == plain.shape == want.shape == (T, B, H)
    np.testing.assert_allclose(got, plain, rtol=EMU_ATOL[bf16], atol=EMU_ATOL[bf16])
    np.testing.assert_allclose(got, want, rtol=EMU_ATOL[bf16], atol=EMU_ATOL[bf16])


@pytest.mark.parametrize("shares", [1, 4])
def test_emulated_route_k_shares_change_roundings_only(shares):
    """The 8 warps' k shares give the h of 1 or 4 shares within float32
    roundings; the fold is not the plain version's context product, bit for
    bit, in float32."""
    args = _np_inputs(6, 4, 128, 8, seed=shares)
    got = _emulated_route(args, False, shares)
    ref = _emulated_route(args, False)
    plain = fad.att_decode_fwd_reference(*map(torch.from_numpy, args), False).numpy()
    assert np.abs(got - ref).max() < 1e-6
    assert 0 < np.abs(got - plain).max() < 2e-6


def test_fold_equals_the_context_product():
    """sum_l a[b, l] (enc_out @ W_ctx^T)[b, l] is ctx @ W_ctx^T, ctx = sum_l
    a[b, l] enc_out[b, l] (float64), and the 3xTF32 P is float32-exact."""
    rng = np.random.default_rng(5)
    eout = rng.normal(size=(3, 10, 64)).astype(np.float32)
    wc = (0.1 * rng.normal(size=(128, 64))).astype(np.float32)
    a = rng.random(size=(3, 10))
    a /= a.sum(axis=1, keepdims=True)
    p = eout.astype(np.float64) @ wc.T.astype(np.float64)
    ctx = np.einsum("bl,blk->bk", a, eout.astype(np.float64))
    np.testing.assert_allclose(np.einsum("bl,blg->bg", a, p), ctx @ wc.T.astype(np.float64),
                               rtol=1e-12, atol=1e-12)
    p3 = _mma_sum(eout.reshape(30, 64), wc, False).reshape(3, 10, 128)
    assert np.abs(p3 - p).max() < 4e-6
    pb = _mma_sum(eout.reshape(30, 64), wc, True).reshape(3, 10, 128)
    assert 1e-4 < np.abs(pb - p).max() < 0.05


# ---------------------------------------------------------------------------
# Dispatch


def _cpu_args(seed, T=4, B=3, H=128, L=8):
    return [torch.from_numpy(a) for a in _np_inputs(T, B, H, L, seed)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_args(1)
    fn = fad.att_decode_fwd
    before = (fn.launches, dict(fn.route_launches))
    got = fn(*args, bf16)
    assert torch.equal(got, fad.att_decode_fwd_reference(*args, bf16))
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("batch,hidden,bf16,route", [(16, 512, False, "mma"),
                                                     (96, 512, True, "mma"),
                                                     (256, 512, False, "direct"),
                                                     (16, 500, True, "direct")])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, batch, hidden, bf16, route):
    """A CUDA-typed tensor (a fake one here, with no card) goes to its route
    and the kernel's build or the card's properties, which raise without
    nvcc or a card; the plain version is never called and no launch is
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fad, "att_decode_fwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(_build, "card", lambda device: H100)
    plain_launch = fad.launch

    def launch(*a, **kw):
        routes.append(a[10])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fad, "launch", launch)
    fn = fad.att_decode_fwd
    before = (fn.launches, dict(fn.route_launches))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda")
                for a in _cpu_args(2, T=3, B=batch, H=hidden, L=80)]
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args, bf16)
    assert called == [] and routes == [route]
    assert (fn.launches, fn.route_launches) == before


def test_shapes_ok_asks_the_routed_kernel(monkeypatch):
    """On a card the gate answers for the kernel the route picks: the mma
    route wherever it is picked, without asking the direct kernel's fit; the
    direct kernel's fit elsewhere (a batch above 200, H = 500, bf16 or
    float32 as the caller says)."""
    asked = []
    monkeypatch.setattr(_build, "card", lambda device: H100)
    monkeypatch.setattr(fad, "_layout", lambda h, l, d: asked.append((h, l)) or (4, 0))
    assert fad.att_decode_shapes_ok(16, 512, 80, "cuda") and asked == []
    assert fad.att_decode_shapes_ok(96, 512, 80, "cuda", compute_bf16=True) and asked == []
    assert not fad.att_decode_shapes_ok(201, 512, 80, "cuda") and asked == [(512, 80)]
    assert not fad.att_decode_shapes_ok(16, 500, 80, "cuda", True) and asked[-1] == (500, 80)
    monkeypatch.setattr(fad, "_layout", lambda h, l, d: (4, 16))
    assert fad.att_decode_shapes_ok(201, 512, 80, "cuda")
    assert fad.att_decode_shapes_ok(3, 20, 6, "cpu") and not fad.att_decode_shapes_ok(0, 512, 80)


def test_variant_tool_changes_one_piece_each():
    """tools/att_decode_variants.py finds each piece of the mma route in the
    kernel source (the shared headers written in place) by its exact text;
    each variant of CHANGED removes its texts and keeps the line count;
    f32_cuda_cores adds the CUDA-core products before the tensor-core ones
    and changes nothing else."""
    import difflib
    from s2vt_tpu_torch.tools import att_decode_variants as tool
    src = tool.kernel_source()
    assert '#include "exchange.cuh"' not in src and "void st_word(" in src
    got = tool.mma_variants(src)
    assert got["as_built"] == src
    assert set(got) == {"as_built", "phase_clock", "f32_cuda_cores", "tanhf", "w_as_a",
                        "k_unroll2", "ctx_words", "f32_small_acc", "f32_one_acc",
                        "fold_128x128", *tool.CHANGED}
    assert got["fold_128x128"] == src.replace(
        tool._FOLD_TILE, "constexpr int kPM = 128, kPN = 128, kPK = 32, kPThreads = 256;")
    ctx = got["ctx_words"]
    for gone, put in ((tool._P_REGION, tool._CTX_REGION), (tool._ARGS, tool._CTX_ARGS),
                      (tool._FOLD_START, tool._CTX_FOLD)):
        assert src.count(gone) == 1 and gone not in ctx and ctx.count(put) == 1, gone
    assert ctx.count(tool._CTX_SIGNATURE) == ctx.count(tool._CTX_STEP) == 1
    assert ctx.index(tool._CTX_WEIGHTS) < ctx.index(tool._WAP) < ctx.index(tool._CTX_STEP)
    assert got["k_unroll2"] == src.replace(tool._K_LOOP,
                                           tool._K_LOOP.replace("unroll 1", "unroll 2"))
    start, end = src.index(tool._PRODUCTS_START), src.index(tool._PRODUCTS_END)
    assert got["w_as_a"] == src[:start] + tool._W_AS_A + src[end:] and start < end
    diff = [d for d in difflib.ndiff(src.splitlines(), got["tanhf"].splitlines())
            if d[:2] in ("- ", "+ ")]
    assert len(diff) == 8 and all("tanh_exp(" in d for d in diff if d.startswith("- "))
    assert all("tanhf(" in d and "tanh_exp" not in d for d in diff if d.startswith("+ "))
    for name, texts in tool.CHANGED.items():
        for gone in texts:
            assert src.count(gone) == 1 and gone not in got[name], (name, gone)
        assert got[name] != src and len(got[name].splitlines()) == len(src.splitlines()), name
    diff = [d for d in difflib.ndiff(src.splitlines(), got["f32_cuda_cores"].splitlines())
            if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    assert "\n".join(d[2:] for d in diff) + "\n" == tool._CORE_PRODUCTS
    assert got["f32_cuda_cores"].index(tool._CORE_PRODUCTS) < \
        got["f32_cuda_cores"].index(tool._PRODUCTS)


def test_variant_tool_layout_and_p_builds_add_one_piece_each():
    """``more_units`` adds U = 4 (both modes) and float32 U = 16 to the two
    entry points' switches and changes nothing else; ``p_only`` makes the
    mma launch return after P's launch and changes nothing else."""
    import difflib
    from s2vt_tpu_torch.tools import att_decode_variants as tool
    src = tool.kernel_source()
    for case in ("case 8:", "case 9:", "case 32:"):
        assert case not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), tool.more_units(src).splitlines())
            if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")] and len(diff) == 6
    added = "\n".join(d[2:] for d in diff)
    for u, bf in ((4, 0), (4, 1), (16, 0)):
        assert f"block_smem<{bf}, {u}>" in added and f"S2VT_ATT_MMA({bf}, {u})" in added
    diff = [d for d in difflib.ndiff(src.splitlines(), tool.p_only(src).splitlines())
            if d[:2] in ("- ", "+ ")]
    assert [(d[0], d[2:].strip()) for d in diff] == [("-", "if (err != cudaSuccess) return err;"),
                                                     ("+", "if (true) return err;")]
    assert src.count(tool._FOLD_LAUNCH) == 1 and "launch_fold<kBf16>" in tool._FOLD_LAUNCH


def test_variant_tool_phase_clock_adds_only_its_lines():
    """The phase-clock variant keeps every line of the source, in order, and
    adds only its clock lines; it writes its sums over h[0, 0, :6], which
    block 0 alone writes (at step 0, units 0-5 of the plan's U = 8), not past
    any allocation; the shipped kernel has none of them."""
    import difflib
    from s2vt_tpu_torch.tools import att_decode_variants as tool
    src = tool.kernel_source()
    got = tool.mma_variants(src)["phase_clock"]
    assert "clock64" not in src and "mark(" not in src
    diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert not [d for d in diff if d.startswith("- ")]
    added = "\n".join(d[2:] for d in diff if d.startswith("+ "))
    assert all(f"mark({ph});" in added for ph in range(len(tool.PHASES)))
    assert "out[ph] = (float)clk[ph];" in added and len(tool.PHASES) <= 8
    assert "words[" not in added and "ww[" not in added


def test_the_direct_route_keeps_its_phase_markers():
    """tools/att_decode_phases.py cuts the direct kernel by its phase comments
    and its four grid barriers: the mma route adds none of them."""
    src = (_build.CSRC / "att_decode_fwd.cu").read_text()
    mma = src[src.index("namespace mma_route {"):]
    for marker in ("grid.sync();", "// A: gates", "// B: dw", "// C: et", "// D: softmax",
                   "if (t + 1 == T) break;"):
        assert marker not in mma, marker
    assert src.count("grid.sync();") == 4


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, B, T, H, L):
    """chip_smoke.py's att_inputs: weights at torch's init scale, encoder
    tensors as an encoder makes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * k

    def n(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    return [n(T, B, 4 * H), u(4 * H, 2 * H), u(4 * H, H), u(H, H), u(H), u(H),
            torch.tanh(n(B, L, H)), torch.tanh(n(B, L, 2 * H)), n(B, 2 * H, scale=0.1)]


def _forced(args, bf16, route, plan=None):
    """One call of ``route`` through launch; checks that it counted once, on
    that route."""
    fn = fad.att_decode_fwd
    before = dict(fn.route_launches)
    got = fad.launch(*args, bf16, route, plan=plan)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    return got


def _check(got, want, bf16, label):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    assert torch.isfinite(got).all(), label
    err = (got - want).abs().max().item()
    assert err <= ATOL[bf16], (label, err)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H,L", [(79, b, h, 80) for h in (512, 500) for b in (1, 16, 96, 200)]
                         + SHAPES)
def test_routes_match_plain_on_card(T, B, H, L, bf16):
    """Each route the shape has, on the same inputs, against the plain
    version; and the wrapper's own call, on the route att_decode_fwd_route
    names."""
    _card()
    args = _card_inputs(B * 1000 + H + L, B, T, H, L)
    want = fad.att_decode_fwd_reference(*args, bf16)
    route = fad.att_decode_fwd_route(H, L, B, bf16, "cuda")
    served = fad.att_decode_plan(H, L, B, bf16, _build.card("cuda")) is not None
    assert served == (H in (512, 128)) and (route == "direct" or served), (route, served)
    if served:
        _check(_forced(args, bf16, "mma"), want, bf16, ("mma", T, B, H, L))
    _check(_forced(args, bf16, "direct"), want, bf16, ("direct", T, B, H, L))
    fn = fad.att_decode_fwd
    before = dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"mma": 0, "direct": 0, "stream": 0, route: 1}
    _check(got, want, bf16, (route, T, B, H, L))


INSTANTIATED = [(False, 8), (True, 8), (True, 16)]      # (bf16, U) the source builds


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,units", INSTANTIATED, ids=["f32-8", "bf16-8", "bf16-16"])
def test_every_layout_matches_plain_on_card(units, bf16):
    """Every instantiated U at as many groups as the card holds and at one
    group, P's slice resident and streamed, at B = 16, 96 and 200 (H = 512)
    and B = 40 at H = 128 (a warp's k share one k16 slice)."""
    _card()
    props = _build.card("cuda")
    for hid, b in ((512, 16), (512, 96), (512, 200), (128, 40)):
        args = _card_inputs(units + b + hid, b, 20, hid, 80)
        want = fad.att_decode_fwd_reference(*args, bf16)
        for p in (props, props._replace(sms=hid // units)):
            plan = fad.att_decode_plan(hid, 80, b, bf16, p, units=units)
            if plan is None:      # no layout fits in one group
                assert p is not props, (units, hid, b, bf16)
                continue
            for p_res in {plan.p_resident, False}:
                _check(_forced(args, bf16, "mma", plan=plan._replace(p_resident=p_res)), want,
                       bf16, (units, hid, b, plan, p_res))


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The route's shared memory is the source's, and the card holds its
    plans at H = 512, L = 80."""
    _card()
    props = _build.card("cuda")
    lib = fad._kernel_lib()
    for h in (128, 256, 512):
        for bf16, units in INSTANTIATED:
            for rows in (1, 8, 17, 48, 100):
                for tiles in (1, 2, 3, 4):
                    for p_res in (0, 1):
                        for e_res in (0, 1):
                            assert lib.att_decode_fwd_mma_smem_bytes(
                                h, 80, units, rows, tiles, p_res, e_res, int(bf16)) == \
                                fad.att_mma_smem_bytes(h, 80, units, rows, tiles, p_res, e_res,
                                                       bf16)
    assert lib.att_decode_fwd_mma_smem_bytes(512, 80, 4, 8, 1, 0, 0, 0) == 0
    for b in (1, 16, 96, 200):
        for bf16 in (False, True):
            assert fad.att_decode_plan(512, 80, b, bf16, props) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_repeated_launches_on_two_streams(bf16):
    """20 calls on each of two streams, in flight together: every result
    equals the first, so no call reads another's words, P or stale state."""
    _card()
    args = _card_inputs(99, 16, 79, 512, 80)
    first = _forced(args, bf16, "mma")
    _check(first, fad.att_decode_fwd_reference(*args, bf16), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fad.launch(*args, bf16, "mma") for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(got, first) for per_stream in outs for got in per_stream)


@pytest.mark.cuda
def test_teacher_forced_on_the_route_against_the_per_step_route():
    """AttBaseline.teacher_forced at H = E = 512, L = 80, B = 16 under no_grad
    on the card: one launch, on the route att_decode_fwd_route names, and
    logits within 1e-4 of the per-step route (use_pallas off for the
    decoder's loop)."""
    _card()
    from s2vt_tpu_torch.models import AttBaseline
    model = AttBaseline(vocab_size=64, dim_feat=32, length=80, dim_hid=512, dim_embed=512,
                        use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(8))
    model = model.cuda().eval()
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(rng.normal(size=(16, 80, 32)).astype(np.float32)).cuda()
    targets = torch.from_numpy(rng.integers(0, 64, size=(16, 79))).cuda()
    route = fad.att_decode_fwd_route(512, 80, 16, False, "cuda")
    assert route == "mma"
    fn = fad.att_decode_fwd
    before = dict(fn.route_launches)
    with torch.no_grad():
        got = model(feats, targets, deterministic=True)
        torch.cuda.synchronize()
        assert {k: fn.route_launches[k] - before[k] for k in before} == \
            {"mma": 0, "direct": 0, "stream": 0, route: 1}
        model.use_pallas = False
        want = model(feats, targets, deterministic=True)
    assert (got - want).abs().max().item() <= 1e-4
