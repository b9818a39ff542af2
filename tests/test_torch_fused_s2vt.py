"""The port's fused dual-LSTM forward against s2vt_tpu/ops/pallas_s2vt.py.

On the CPU the port runs its plain version and JAX runs the Pallas kernel in
interpret mode, on the same numpy inputs (B=8, H=128, L=6 as in
tests/test_pallas_s2vt.py). Tolerances: float32 at 1e-5 (same products,
summed in another order); bf16 at 2e-2 on h and c, with the gates, which both
sides store in bf16, compared as stored.

The kernel itself needs a card: ``test_kernel_matches_plain_on_card`` is
marked ``cuda`` and skips elsewhere. The JAX side is imported by a fixture,
so that the card test also collects where the JAX package cannot be
imported.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_s2vt as tfused

B, L, H = 8, 6, 128
T = 2 * L - 1
ATOL = {"f32": 1e-5, "bf16": 2e-2}


def _inputs(seed, b=B, t=T, h=H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    x1 = rng.normal(size=(t, b, 4 * h)).astype(np.float32)
    x2 = rng.normal(size=(t, b, 4 * h)).astype(np.float32)
    ws = [rng.uniform(-k, k, (4 * h, h)).astype(np.float32) for _ in range(3)]
    return x1, x2, ws


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_s2vt)."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("s2vt_tpu.ops.pallas_s2vt"))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("snap_idx", [0, L - 1, T - 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_forward_outputs_match_jax(jax_side, dtype, snap_idx):
    """Every output of the forward: gates and c of both layers in time
    order, the finals and the snapshot at ``snap_idx``."""
    jnp, jfused = jax_side
    bf16 = dtype == "bf16"
    x1, x2, (w1hh, w2v, w2hh) = _inputs(0)
    want = jfused._run_fwd(jnp.asarray(x1), jnp.asarray(x2),
                           jfused._assemble_wall(*map(jnp.asarray, (w1hh, w2v, w2hh))),
                           snap_idx=snap_idx, compute_bf16=bf16)
    mmd = torch.bfloat16 if bf16 else torch.float32
    got = tfused.fused_s2vt_fwd(*(torch.from_numpy(a).to(mmd)
                                  for a in (x1, x2, w1hh, w2v, w2hh)), snap_idx)
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), i
        _close(g.float(), w, ATOL[dtype])
    assert got[0].dtype == got[2].dtype == mmd


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_infer_matches_jax(jax_side, dtype):
    jnp, jfused = jax_side
    bf16 = dtype == "bf16"
    x1, x2, ws = _inputs(1)
    want = jfused.s2vt_fused_infer(jnp.asarray(x1), jnp.asarray(x2),
                                   *map(jnp.asarray, ws), snap_idx=L - 1, compute_bf16=bf16)
    got = tfused.s2vt_fused_infer(torch.from_numpy(x1), torch.from_numpy(x2),
                                  *map(torch.from_numpy, ws), snap_idx=L - 1,
                                  compute_bf16=bf16)
    _close(got[0], want[0], ATOL[dtype])
    _close(got[1], want[1], ATOL[dtype])
    for (gh, gc), (wh, wc) in zip(got[2:], want[2:]):
        _close(gh, wh, ATOL[dtype])
        _close(gc, wc, ATOL[dtype])


def test_assemble_wall_matches_jax(jax_side):
    jnp, jfused = jax_side
    _, _, ws = _inputs(2, h=16)
    want = np.asarray(jfused._assemble_wall(*map(jnp.asarray, ws)))
    got = tfused._assemble_wall(*map(torch.from_numpy, ws)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_shapes_ok_on_cpu():
    assert tfused.fused_shapes_ok(512, 1, "lstm")
    assert tfused.fused_shapes_ok(H, 1, "lstm", torch.device("cpu"))
    assert not tfused.fused_shapes_ok(512, 2, "lstm")
    assert not tfused.fused_shapes_ok(512, 1, "gru")


def test_units_per_block_keeps_one_block_per_sm():
    assert tfused.units_per_block(512, 132) == 4
    assert tfused.units_per_block(128, 132) == 1
    for h in (100, 512, 1000, 2048):
        u = tfused.units_per_block(h, 132)
        assert -(-h // u) <= 132 and (u == 1 or -(-h // (u - 1)) > 132)


def test_wrapper_validates_inputs():
    x1, x2, ws = _inputs(3, b=2, t=3, h=8)
    args = [torch.from_numpy(a) for a in (x1, x2, *ws)]
    with pytest.raises(ValueError, match="snap_idx"):
        tfused.fused_s2vt_fwd(*args, 3)
    with pytest.raises(ValueError, match="x2"):
        tfused.fused_s2vt_fwd(args[0], args[1][:2], *args[2:], 0)
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_s2vt_fwd(args[0].double(), *args[1:], 0)
    with pytest.raises(ValueError, match="w2v"):
        tfused.fused_s2vt_fwd(*args[:3], args[3][:, :4], args[4], 0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain version: anything else reaches the
    kernel or raises (here: a meta tensor, which no kernel serves)."""
    x1, x2, ws = _inputs(4, b=2, t=3, h=8)
    args = [torch.from_numpy(a).to("meta") for a in (x1, x2, *ws)]
    before = tfused.fused_s2vt_fwd.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfused.fused_s2vt_fwd(*args, 0)
    assert tfused.fused_s2vt_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card, at full MSVD
    width and at the test width, for small and large batches. Bounds as in
    chip_smoke.py: 1e-4 on h/c in float32; 3e-2 on h/c and on the stored
    gates in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mmd = torch.bfloat16 if dtype == "bf16" else torch.float32
    atol = 3e-2 if dtype == "bf16" else 1e-4
    for b, t, h in ((1, T, H), (B, T, H), (16, 159, 512), (200, 159, 512)):
        x1, x2, ws = _inputs(5, b=b, t=t, h=h)
        args = [torch.from_numpy(a).to("cuda", mmd) for a in (x1, x2, *ws)]
        before = tfused.fused_s2vt_fwd.launches
        got = tfused.fused_s2vt_fwd(*args, t // 2)
        torch.cuda.synchronize()
        assert tfused.fused_s2vt_fwd.launches == before + 1
        want = tfused.fused_s2vt_fwd_reference(*args, t // 2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert (g.float() - w.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_greedy_on_card_goes_through_the_kernel():
    """S2VT.greedy on the card launches the kernel once per request and
    gives the CPU (plain) route's tokens, in float32, at the test width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from s2vt_tpu_torch.models import S2VT
    model = S2VT(vocab_size=32, feat_dim=16, length=L, dim_hid=H, dim_embed=H, use_pallas=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats = torch.from_numpy(np.random.default_rng(6).normal(size=(B, L, 16)).astype(np.float32))
    want = model.eval().greedy(feats)
    before = tfused.fused_s2vt_fwd.launches
    got = model.cuda().greedy(feats.cuda())
    assert tfused.fused_s2vt_fwd.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
