"""The port's attention-decoder op against s2vt_tpu/ops/pallas_att_decode.py.

On the CPU the port runs the plain version of its kernel and JAX runs the
Pallas kernel in interpret mode (as tests/test_pallas_att_decode.py does), on
the same numpy inputs: at that file's shapes and at a width that is a multiple
of neither 128 nor 8. Tolerances are JAX's own: float32 rtol = atol = 2e-5
(tests/test_pallas_att_decode.py:67), bf16 0.05 (:84); the float32 plain
version also equals ``att_decode_sequence_scan`` within 2e-5. The JAX side
takes its weights transposed ([in, out]); the port keeps torch's [out, in].

The JAX side is imported by a fixture, so that the card tests also collect
where the JAX package cannot be imported. The kernel itself needs a card: the
``cuda``-marked tests skip elsewhere.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_att_decode as fad

SHAPES = [(7, 8, 128, 16), (8, 8, 128, 16), (5, 16, 128, 8), (5, 3, 20, 6)]
ATOL = {"f32": 2e-5, "bf16": 0.05}


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_att_decode)."""
    return tuple(importlib.import_module(n) for n in
                 ("jax.numpy", "s2vt_tpu.ops.pallas_att_decode"))


def _inputs(T, B, H, L, seed=0):
    """The nine inputs in the port's layout, float32 numpy, scaled as
    tests/test_pallas_att_decode.py scales its own."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return [n(T, B, 4 * H), n(4 * H, 2 * H), n(4 * H, H), n(H, H), n(H), n(H), n(B, L, H),
            n(B, L, 2 * H), n(B, 2 * H)]


def _jax_args(jnp, args):
    """The port's inputs in the JAX kernel's layout: the three weights transposed."""
    xp, wc, wh, wa, *rest = args
    return [jnp.asarray(a) for a in (xp, wc.T, wh.T, wa.T, *rest)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,B,H,L", SHAPES)
def test_reference_matches_jax_kernel(jax_side, T, B, H, L, dtype):
    jnp, jatt = jax_side
    bf16 = dtype == "bf16"
    args = _inputs(T, B, H, L)
    want = np.asarray(jatt.att_decode_sequence_pallas(
        *_jax_args(jnp, args), compute_dtype=jnp.bfloat16 if bf16 else None))
    got = fad.att_decode_fwd(*map(torch.from_numpy, args), bf16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, B, H) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("T,B,H,L", SHAPES[::3])
def test_reference_matches_jax_scan(jax_side, T, B, H, L):
    jnp, jatt = jax_side
    args = _inputs(T, B, H, L, seed=1)
    want = np.asarray(jatt.att_decode_sequence_scan(*_jax_args(jnp, args)))
    got = fad.att_decode_fwd_reference(*map(torch.from_numpy, args), False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_sequence_drop_in_detaches_and_maps_the_dtype():
    """``att_decode_sequence`` takes tensors that carry gradients and the
    model's compute dtype, and gives the op's result with none attached."""
    args = [torch.from_numpy(a) for a in _inputs(4, 2, 8, 5, seed=2)]
    for compute_dtype, bf16 in ((None, False), (torch.bfloat16, True)):
        leaves = [a.clone().requires_grad_() for a in args]
        got = fad.att_decode_sequence(*leaves, compute_dtype=compute_dtype)
        assert not got.requires_grad
        torch.testing.assert_close(got, fad.att_decode_fwd_reference(*args, bf16), rtol=0, atol=0)
    rounded = fad.att_decode_fwd_reference(*args, True)
    assert (rounded - fad.att_decode_fwd_reference(*args, False)).abs().max() > 0


def test_wrappers_validate_inputs():
    args = [torch.from_numpy(a) for a in _inputs(3, 2, 8, 5, seed=3)]
    for i, name in enumerate(fad._ARGS):
        bad = list(args)
        bad[i] = bad[i][..., :-1]
        with pytest.raises(ValueError, match=name if i else "xp_t"):
            fad.att_decode_fwd(*bad, False)
    bad = list(args)
    bad[6] = bad[6].double()
    with pytest.raises(TypeError, match="enc_wh"):
        fad.att_decode_fwd(*bad, False)
    with pytest.raises(ValueError, match="several devices"):
        fad.att_decode_fwd(*args[:-1], args[-1].to("meta"), False)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain version: anything else reaches the
    kernel or raises (here: meta tensors, which no kernel serves)."""
    args = [torch.from_numpy(a).to("meta") for a in _inputs(3, 2, 8, 5, seed=4)]
    before = fad.att_decode_fwd.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fad.att_decode_fwd(*args, False)
    assert fad.att_decode_fwd.launches == before


def test_shape_gate_on_cpu():
    """The plain version serves any shapes; the gate refuses empty ones."""
    assert fad.att_decode_shapes_ok(16, 512, 80) and fad.att_decode_shapes_ok(3, 20, 6, "cpu")
    assert fad.att_decode_shapes_ok(200, 4096, 80, torch.device("cpu"))
    assert not fad.att_decode_shapes_ok(0, 512, 80)


def test_phase_tool_finds_every_phase_of_the_kernel_source():
    """tools/att_decode_phases.py cuts phases out of the kernel source by its
    phase comments and grid barriers: each variant drops what it names."""
    from s2vt_tpu_torch.ops import _build
    from s2vt_tpu_torch.tools.att_decode_phases import variants
    src = (_build.CSRC / "att_decode_fwd.cu").read_text()
    got = variants(src)
    assert got["full"] == src
    barriers = {name: text.count("grid.sync();") for name, text in got.items()}
    assert barriers == {"full": 4, "no_B": 4, "no_C": 4, "no_D": 4, "A_4_barriers": 4,
                        "A_1_barrier": 1, "4_barriers": 4, "1_barrier": 1}
    for name, gone in (("no_B", "dwb[(size_t)"), ("no_C", "etb[p] = acc"),
                       ("no_D", "ctxb[(size_t)b * H2"), ("4_barriers", "reduce_scatter(acc")):
        assert gone in src and gone not in got[name], name


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card at the MSVD
    decode length (T = 79, L = 80) for H = 512 (MSVD) and 500 (the model's
    default), B in {1, 16, 96, 200}, and at the small widths above. Bounds as
    in chip_smoke.py: 1e-4 in float32, 3e-2 in bf16."""
    _card()
    bf16 = dtype == "bf16"
    atol = 3e-2 if bf16 else 1e-4
    cases = [(79, b, h, 80) for h in (512, 500) for b in (1, 16, 96, 200)] + SHAPES
    for T, B, H, L in cases:
        assert fad.att_decode_shapes_ok(B, H, L, "cuda")
        args = [torch.from_numpy(a).cuda() for a in _inputs(T, B, H, L, seed=5)]
        before = fad.att_decode_fwd.launches
        got = fad.att_decode_fwd(*args, bf16)
        torch.cuda.synchronize()
        assert fad.att_decode_fwd.launches == before + 1
        err = (got - fad.att_decode_fwd_reference(*args, bf16)).abs().max().item()
        assert err <= atol, (T, B, H, L, err)


@pytest.mark.cuda
def test_teacher_forced_on_card_routes_by_gradient_and_width():
    """On the card, AttBaseline.teacher_forced launches the kernel once under
    no_grad and never with a gradient, and both give the CPU (plain) route's
    logits; a width whose weights do not fit one block per SM raises under
    no_grad instead of running the per-step loop."""
    _card()
    from s2vt_tpu_torch.models import AttBaseline
    kw = dict(vocab_size=32, dim_feat=16, length=6, dim_embed=128, use_pallas=True)
    model = AttBaseline(dim_hid=128, **kw)
    model.reset_parameters(torch.Generator().manual_seed(6))
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.normal(size=(8, 6, 16)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 32, size=(8, 5)))
    with torch.no_grad():
        want = model.eval()(feats, targets)
    card = model.cuda()
    for grad, launches in ((False, 1), (True, 0)):
        before = fad.att_decode_fwd.launches
        with torch.set_grad_enabled(grad):
            got = card(feats.cuda(), targets.cuda())
        torch.cuda.synchronize()
        assert fad.att_decode_fwd.launches == before + launches
        np.testing.assert_allclose(got.detach().cpu().numpy(), want.numpy(), atol=1e-4, rtol=0)
    assert not fad.att_decode_shapes_ok(8, 1024, 6, "cuda")
    wide = AttBaseline(dim_hid=1024, **kw).cuda()
    before = fad.att_decode_fwd.launches
    with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden size 1024"):
        wide(feats.cuda(), targets.cuda())
    assert fad.att_decode_fwd.launches == before
