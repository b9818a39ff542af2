"""The port's fused dual-LSTM backward against s2vt_tpu/ops/pallas_s2vt.py.

On the CPU the port runs its plain backward and JAX runs the Pallas backward
kernel in interpret mode, on the same numpy inputs (B=8, H=128, L=6 as in
tests/test_pallas_s2vt.py). The gates and c come from a forward run of the
same weights, so they are real LSTM states. Tolerances: float32 at 1e-5
(same products, summed in another order); bf16 at 2e-2 with the stored bf16
gate gradients compared as stored; gradients through the differentiable
core at 2e-3 (tests/test_pallas_s2vt.py:122).

The kernel itself needs a card: the ``cuda``-marked tests skip elsewhere.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_s2vt as tfused

B, L, H = 8, 6, 128
T = 2 * L - 1
ATOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy, s2vt_tpu.ops.pallas_s2vt)."""
    return (importlib.import_module("jax"), importlib.import_module("jax.numpy"),
            importlib.import_module("s2vt_tpu.ops.pallas_s2vt"))


def _inputs(seed, b=B, t=T, h=H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    x1 = rng.normal(size=(t, b, 4 * h)).astype(np.float32)
    x2 = rng.normal(size=(t, b, 4 * h)).astype(np.float32)
    ws = [rng.uniform(-k, k, (4 * h, h)).astype(np.float32) for _ in range(3)]
    dout2 = rng.normal(size=(t, b, h)).astype(np.float32)
    return x1, x2, ws, dout2


def _bwd_inputs(seed, mmd, b=B, t=T, h=H, device="cpu"):
    """(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh) from a forward run."""
    x1, x2, ws, dout2 = _inputs(seed, b, t, h)
    args = [torch.from_numpy(a).to(device, mmd) for a in (x1, x2, *ws)]
    g1, c1, g2, c2 = tfused.fused_s2vt_fwd_reference(*args, t - 1)[:4]
    return g1, c1, g2, c2, torch.from_numpy(dout2).to(device), *args[2:]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_reference_matches_jax_run_bwd(jax_side, dtype):
    """dxp1 and dxp2 in time order; JAX returns them as float32 after
    storing them in the matmul dtype, the port as stored."""
    _, jnp, jfused = jax_side
    mmd = torch.bfloat16 if dtype == "bf16" else torch.float32
    g1, c1, g2, c2, dout2, w1hh, w2v, w2hh = _bwd_inputs(0, mmd)
    to_j = lambda x: jnp.asarray(x.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    zero = torch.zeros(1, B, H)
    wb1, wb2 = jfused._assemble_wb(to_j(w1hh), to_j(w2v), to_j(w2hh))
    want = jfused._run_bwd(to_j(g1), to_j(c1), to_j(torch.cat([zero, c1[:-1]])), to_j(g2),
                           to_j(c2), to_j(torch.cat([zero, c2[:-1]])), to_j(dout2), wb1, wb2,
                           compute_bf16=dtype == "bf16")
    got = tfused.fused_s2vt_bwd(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    assert [g.dtype for g in got] == [mmd, mmd]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (T, B, 4 * H)
        _close(g.float(), w, ATOL[dtype])


def test_assemble_wb_matches_jax(jax_side):
    _, jnp, jfused = jax_side
    ws = _inputs(2, h=16)[2]
    want = jfused._assemble_wb(*map(jnp.asarray, ws))
    got = tfused._assemble_wb(*map(torch.from_numpy, ws))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cell_bwd_matches_jax(jax_side):
    _, jnp, jfused = jax_side
    rng = np.random.default_rng(3)
    post = 1 / (1 + np.exp(-rng.normal(size=(4, 64)))).astype(np.float32)
    c, c_prev, dh, dc = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(4))
    want = jfused._cell_bwd(*map(jnp.asarray, (post, c, c_prev, dh, dc)))
    got = tfused._cell_bwd(*map(torch.from_numpy, (post, c, c_prev, dh, dc)))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_differentiable_core_matches_jax_grad(jax_side, dtype):
    """The autograd Function against jax.grad of the custom_vjp, for all five
    inputs, under one numpy cotangent of out2."""
    jax, jnp, jfused = jax_side
    bf16 = dtype == "bf16"
    x1, x2, ws, dout2 = _inputs(1)
    _, jvjp = jax.vjp(lambda *a: jfused.s2vt_fused_out2(*a, bf16),
                      *map(jnp.asarray, (x1, x2, *ws)))
    want = jvjp(jnp.asarray(dout2))
    args = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, *ws)]
    out2 = tfused.s2vt_fused_out2(*args, compute_bf16=bf16)
    out2.backward(torch.from_numpy(dout2))
    for a, w in zip(args, want):
        assert a.grad.dtype == torch.float32 and tuple(a.grad.shape) == tuple(w.shape)
        _close(a.grad, w, 2e-3)


def test_fused_core_gradients_match_torch_autograd_of_plain_forward():
    """An independent check of the hand-written backward: torch autograd
    through an op-by-op float32 LSTM pair gives the same five gradients."""
    x1, x2, ws, dout2 = _inputs(4, b=3, t=5, h=8)
    args = [torch.from_numpy(a).double().requires_grad_() for a in (x1, x2, *ws)]
    xa, xb, w1hh, w2v, w2hh = args
    h1 = c1 = h2 = c2 = torch.zeros(3, 8, dtype=torch.float64)
    outs = []
    for t in range(5):
        _, c1n, h1n = tfused._cell(xa[t] + h1 @ w1hh.T, c1)
        _, c2, h2 = tfused._cell(xb[t] + h1n @ w2v.T + h2 @ w2hh.T, c2)
        h1, c1 = h1n, c1n
        outs.append(h2)
    torch.stack(outs).backward(torch.from_numpy(dout2).double())
    mine = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, *ws)]
    tfused.s2vt_fused_out2(*mine, compute_bf16=False).backward(torch.from_numpy(dout2))
    for m, a in zip(mine, args):
        _close(m.grad, a.grad.float(), 1e-5)


def test_backward_wrapper_validates_inputs():
    g1, c1, g2, c2, dout2, *ws = _bwd_inputs(5, torch.float32, b=2, t=3, h=8)
    with pytest.raises(ValueError, match="g2"):
        tfused.fused_s2vt_bwd(g1, c1, g2[:2], c2, dout2, *ws)
    with pytest.raises(TypeError, match="dout2"):
        tfused.fused_s2vt_bwd(g1, c1, g2, c2, dout2.double(), *ws)
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_s2vt_bwd(g1, c1, g2, c2, dout2, ws[0].bfloat16(), *ws[1:])
    with pytest.raises(ValueError, match="w2hh"):
        tfused.fused_s2vt_bwd(g1, c1, g2, c2, dout2, *ws[:2], ws[2][:, :4])


def test_backward_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain backward: anything else reaches the
    kernel or raises (here: meta tensors, which no kernel serves)."""
    args = [t.to("meta") for t in _bwd_inputs(6, torch.float32, b=2, t=3, h=8)]
    before = tfused.fused_s2vt_bwd.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfused.fused_s2vt_bwd(*args)
    assert tfused.fused_s2vt_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_kernel_matches_plain_on_card(dtype):
    """The CUDA backward against its plain version on the card, at the test
    width and at the full MSVD width, for small and large batches. Bounds as
    in chip_smoke.py: 1e-4 in float32, 3e-2 in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mmd = torch.bfloat16 if dtype == "bf16" else torch.float32
    atol = 3e-2 if dtype == "bf16" else 1e-4
    for b, t, h in ((1, T, H), (B, T, H), (16, 159, 512), (200, 159, 512)):
        args = _bwd_inputs(7, mmd, b=b, t=t, h=h, device="cuda")
        before = tfused.fused_s2vt_bwd.launches
        got = tfused.fused_s2vt_bwd(*args)
        torch.cuda.synchronize()
        assert tfused.fused_s2vt_bwd.launches == before + 1
        want = tfused.fused_s2vt_bwd_reference(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert (g.float() - w.float()).abs().max().item() <= atol, (b, h)
