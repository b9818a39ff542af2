"""The port's fused 3x3 conv + folded BN + ReLU (ops/fused_conv.py) against
s2vt_tpu's ops/pallas_conv.py.

On the CPU ``conv3x3_bn_relu`` runs its plain version (nine shifted matrix
products, the TPU kernel's formulation) and JAX runs the Pallas kernel in
interpret mode (as tests/test_pallas_conv.py does) and its XLA twin
``xla_conv3x3_bn_relu``, on the same numpy inputs. Tolerances are the JAX
package's own (tests/test_pallas_conv.py:32,46): 1e-4 in float32 (the same
products, summed in another order) and 3e-2 in bf16 (operands rounded to
bf16, the output stored in bf16). The zero halo is checked exactly.

The JAX side is imported by fixtures, so that the card tests also collect
where the JAX package cannot be imported; the ``cuda``-marked tests skip
without a card.
"""

import importlib

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_conv

# (H, W, C, K): tests/test_pallas_conv.py's shapes, and VGG's first layer (C = 3)
SHAPES = [(8, 8, 64, 64), (14, 14, 128, 64), (7, 10, 64, 128), (28, 28, 64, 64),
          (12, 9, 3, 64)]


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, s2vt_tpu.ops.pallas_conv)."""
    return tuple(importlib.import_module(n) for n in ("jax.numpy", "s2vt_tpu.ops.pallas_conv"))


def _inputs(seed, n, h, w, c, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, c)).astype(np.float32),
            (rng.normal(size=(3, 3, c, k)) * 0.05).astype(np.float32),
            (rng.normal(size=k) * 0.3 + 1.0).astype(np.float32),
            (rng.normal(size=k) * 0.1).astype(np.float32))


@pytest.mark.parametrize("H,W,C,K", SHAPES)
def test_plain_version_matches_jax_f32(jax_side, H, W, C, K):
    jnp, jconv = jax_side
    args = _inputs(0, 2, H, W, C, K)
    got = fused_conv.conv3x3_bn_relu(*(torch.from_numpy(a) for a in args), False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, H, W, K)
    jargs = [jnp.asarray(a) for a in args]
    xla = np.asarray(jconv.xla_conv3x3_bn_relu(*jargs, compute_bf16=False))
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-4, rtol=1e-4)
    if C % 64 == 0:       # the TPU kernel's own gate refuses C = 3
        kern = np.asarray(jconv.fused_conv3x3_bn_relu(*jargs, compute_bf16=False))
        np.testing.assert_allclose(got.numpy(), kern, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("H,W,C,K", [(14, 14, 128, 128), (12, 9, 3, 64)])
def test_plain_version_matches_jax_bf16(jax_side, H, W, C, K):
    jnp, jconv = jax_side
    args = _inputs(1, 1, H, W, C, K)
    got = fused_conv.conv3x3_bn_relu(*(torch.from_numpy(a) for a in args), True)
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a) for a in args]
    want = [np.asarray(jconv.xla_conv3x3_bn_relu(*jargs, compute_bf16=True), np.float32)]
    if C % 64 == 0:
        want.append(np.asarray(jconv.fused_conv3x3_bn_relu(*jargs, compute_bf16=True),
                               np.float32))
    for w in want:
        np.testing.assert_allclose(got.float().numpy(), w, atol=3e-2, rtol=3e-2)


def test_zero_padding_edges_exact():
    """Border pixels read the zero halo: with ones everywhere, an interior
    output sums 9 taps, an edge 6 and a corner 4, exactly; C = 3 too."""
    for c in (64, 3):
        x = torch.ones(1, 8, 8, c)
        w = torch.ones(3, 3, c, 64)
        out = fused_conv.conv3x3_bn_relu(x, w, torch.ones(64), torch.zeros(64), False)
        assert out[0, 4, 4, 0].item() == 9 * c
        assert out[0, 0, 0, 0].item() == 4 * c
        assert out[0, 0, 4, 0].item() == 6 * c
        assert out[0, 7, 7, 5].item() == 4 * c


def test_fold_bn_is_the_jax_bn_after_the_conv(jax_side):
    """relu(BN(conv + bias)) of the JAX package's Conv and BatchNormInference
    formulas equals the kernel's (scale, shift) epilogue within float32
    rounding; without BN, scale is one and shift the bias."""
    rng = np.random.default_rng(2)
    k = 16
    bias, gamma, beta, mean = (torch.from_numpy(rng.normal(size=k).astype(np.float32))
                               for _ in range(4))
    var = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32))     # conv output
    scale, shift = fused_conv.fold_bn(bias, k, (gamma, beta, mean, var), 1e-5)
    inv = gamma * torch.rsqrt(var + 1e-5)
    want = (y + bias) * inv + (beta - mean * inv)
    np.testing.assert_allclose((y * scale + shift).numpy(), want.numpy(), atol=1e-5)
    s0, b0 = fused_conv.fold_bn(bias, k)
    assert torch.equal(s0, torch.ones(k)) and torch.equal(b0, bias)


def test_gate_is_the_ports_own():
    """Any NHWC shape is served, C = 3 and widths that divide nothing
    included (the TPU gate wants C and K multiples of 64); not 3-D input."""
    assert fused_conv.conv3x3_ok((80, 224, 224, 3), 64)
    assert fused_conv.conv3x3_ok((2, 7, 10, 5), 7)
    assert not fused_conv.conv3x3_ok((80, 224, 224), 64)
    assert not fused_conv.conv3x3_ok((0, 8, 8, 3), 64)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(bf16):
    """The CUDA kernel against its plain version on the card at the TPU
    test's shapes, C = 3, channel counts that fill no tile (5 -> 7), and a
    channel chunk that is partly past C (C = 20). Bounds 1e-4 (float32) and
    3e-2 (bf16); the halo edges exactly."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    atol = 3e-2 if bf16 else 1e-4
    for n, h, w, c, k in ((2, 8, 8, 64, 64), (2, 14, 14, 128, 64), (2, 7, 10, 64, 128),
                          (1, 12, 9, 3, 64), (3, 5, 11, 5, 7), (1, 9, 9, 20, 70)):
        args = [torch.from_numpy(a).cuda() for a in _inputs(3, n, h, w, c, k)]
        before = fused_conv.conv3x3_bn_relu.launches
        got = fused_conv.conv3x3_bn_relu(*args, bf16)
        torch.cuda.synchronize()
        assert fused_conv.conv3x3_bn_relu.launches == before + 1
        want = fused_conv.conv3x3_bn_relu_reference(*args, bf16)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() <= atol, (n, h, w, c, k)
    x = torch.ones(1, 8, 8, 64, device="cuda")
    out = fused_conv.conv3x3_bn_relu(x, torch.ones(3, 3, 64, 64, device="cuda"),
                                     torch.ones(64, device="cuda"),
                                     torch.zeros(64, device="cuda"), bf16).float().cpu()
    assert (out[0, 4, 4, 0].item(), out[0, 0, 0, 0].item(), out[0, 0, 4, 0].item()) == \
        (9 * 64, 4 * 64, 6 * 64)
