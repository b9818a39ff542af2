"""The two routes of the port's fused 3x3 conv kernel (ops/fused_conv.py,
csrc/conv3x3_bn_relu.cu).

``conv3x3_route(C, K)`` sends C % 16 == 0 and K % 8 == 0 to the "mma" kernel
(an implicit GEMM on the tensor cores) and every other shape to the "direct"
kernel (CUDA cores). In float32 the mma kernel runs three TF32 passes: each
operand v splits into big = tf32(v) (``cvt.rna``'s rounding: 10 mantissa
bits, nearest, ties away from zero) and small = v - big, of which the tensor
cores read the upper 10 mantissa bits (truncation), and each 8-channel
slice sums small*big + big*small + big*big into a fresh float32 partial
that is added to the running sum. The CPU tests emulate that arithmetic in
numpy at every VGG16 layer's GEMM depth 9C, on chip_smoke.py's input
distribution (x ~ N(0, 1), w ~ N(0, 2/(9C))), and hold it to chip_smoke.py's
float32 bound, 1e-4 + 1e-4*|want|, against the float64 sum; one TF32 pass
breaks that bound at C = 512, which is why the kernel takes three.

The ``cuda``-marked tests hold each route to the plain version on the card,
in both types, within chip_smoke.py's bounds (allclose's atol = rtol: 1e-4
float32, 3e-2 bf16).
"""

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_conv

# VGG16's 13 conv layers at 224 x 224: (H = W, C, K)
VGG16_LAYERS = ((224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256),
                (56, 256, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512), (28, 512, 512),
                (14, 512, 512), (14, 512, 512), (14, 512, 512))
F32_TOL = 1e-4
BF16_TOL = 3e-2
SLICE_CHANNELS = 8        # channels per partial sum of the float32 mma kernel (m16n8k8)


@pytest.mark.parametrize("hw,C,K", VGG16_LAYERS, ids=[f"layer{i + 1}" for i in range(13)])
def test_route_of_vgg16_layers(hw, C, K):
    """Every layer but the first (C = 3) runs on the tensor cores."""
    assert fused_conv.conv3x3_route(C, K) == ("direct" if C == 3 else "mma")


@pytest.mark.parametrize("C,K,route", [(20, 70, "direct"), (20, 64, "direct"),
                                       (64, 70, "direct"), (5, 7, "direct"), (64, 7, "direct"),
                                       (16, 8, "mma"), (48, 72, "mma"), (512, 200, "mma")])
def test_route_of_ragged_widths(C, K, route):
    """C must fill 16-channel groups and K 8-channel groups for the mma
    kernel's 16-byte copies; anything else is the direct kernel's."""
    assert fused_conv.conv3x3_route(C, K) == route


def test_gate_follows_the_route():
    """On the card one mma launch takes up to 2^31 - 129 pixels N*H*W and
    one direct launch up to 65535 images; a larger batch is split into
    launches of that many images, so only an mma image beyond 2^31 - 129
    pixels is refused. The CPU takes every NHWC shape."""
    cuda = torch.device("cuda")
    assert fused_conv.conv3x3_ok((70000, 8, 8, 64), 64, cuda)          # mma
    assert fused_conv.conv3x3_ok((70000, 8, 8, 3), 64, cuda)           # direct, 2 launches
    assert fused_conv._images_per_launch((70000, 8, 8, 3), 64) == 65535
    assert fused_conv.conv3x3_ok((320, 224, 224, 64), 64, cuda)
    assert fused_conv.conv3x3_ok((43000, 224, 224, 64), 64, cuda)      # mma, 2 launches
    assert fused_conv._images_per_launch((43000, 224, 224, 64), 64) == 42799
    assert not fused_conv.conv3x3_ok((1, 50000, 50000, 64), 64, cuda)
    assert fused_conv.conv3x3_ok((1, 50000, 50000, 64), 64)
    assert fused_conv.conv3x3_ok((43000, 224, 224, 64), 64)


def test_cpu_calls_count_no_launch():
    before = (fused_conv.conv3x3_bn_relu.launches,
              dict(fused_conv.conv3x3_bn_relu.route_launches))
    x = torch.ones(1, 4, 4, 16)
    fused_conv.conv3x3_bn_relu(x, torch.ones(3, 3, 16, 8), torch.ones(8), torch.zeros(8))
    assert (fused_conv.conv3x3_bn_relu.launches,
            fused_conv.conv3x3_bn_relu.route_launches) == before


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on the int32 view: round the 23 mantissa bits to
    10, to nearest with ties away from zero (sign and magnitude are apart,
    so adding half of the dropped place to the bits rounds the magnitude)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(v: np.ndarray) -> np.ndarray:
    """What a TF32 tensor-core operand reads of the float ``v``: the upper 10
    mantissa bits (the lower 13 are ignored)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    """(big, small) as the kernel's operands read them."""
    big = tf32_rna(v)
    return big, tf32_read(v - big)


def three_tf32_sum(a, b, passes=3):
    """The float32 mma kernel's sum of a [R, D] @ b [D, K]: per slice of 8
    channels the TF32 products (exact in float32) summed into a float32
    partial, the partials added to the running float32 sum. ``passes=1``
    keeps big*big alone: plain TF32."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s in range(0, a.shape[1], SLICE_CHANNELS):
        cut = slice(s, s + SLICE_CHANNELS)
        part = a_big[:, cut] @ b_big[cut]
        if passes == 3:
            part = a_small[:, cut] @ b_big[cut] + a_big[:, cut] @ b_small[cut] + part
        acc += part.astype(np.float32)
    return acc


def _gemm_inputs(C, rows=128, cols=64, seed=0):
    """chip_smoke.py's conv_inputs distribution as GEMM operands of depth 9C."""
    rng = np.random.default_rng(seed + C)
    a = rng.normal(size=(rows, 9 * C)).astype(np.float32)
    b = (rng.normal(size=(9 * C, cols)) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    return a, b


def test_tf32_split_keeps_21_bits():
    v = np.random.default_rng(5).normal(size=4096).astype(np.float32) * 100
    big, small = split_tf32(v)
    for t in (big, small):
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()      # 10 mantissa bits
    assert np.all(np.abs(v - big) <= np.abs(v) * 2.0 ** -11)
    assert np.all(np.abs(v.astype(np.float64) - big - small) <= np.abs(v) * 2.0 ** -21)
    assert tf32_rna(np.float32([1 + 2 ** -11]))[0] == np.float32(1 + 2 ** -10)  # tie: away


@pytest.mark.parametrize("hw,C,K", VGG16_LAYERS, ids=[f"layer{i + 1}" for i in range(13)])
def test_3xtf32_within_f32_bound(hw, C, K):
    """Three TF32 passes stay inside chip_smoke.py's float32 bound of the
    float64 sum at every VGG16 layer's depth 9C."""
    a, b = _gemm_inputs(C)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = three_tf32_sum(a, b)
    excess = np.abs(got - want) - F32_TOL * (1 + np.abs(want))
    assert excess.max() <= 0, (C, np.abs(got - want).max())
    assert np.abs(got - want).max() < F32_TOL / 10       # with an order of magnitude to spare


def test_one_tf32_pass_breaks_the_f32_bound():
    """Plain TF32 (big*big alone) at C = 512, depth 4608: about three decimal
    digits per product, outside 1e-4 + 1e-4*|want| on these 8192 sums."""
    a, b = _gemm_inputs(512)
    want = a.astype(np.float64) @ b.astype(np.float64)
    excess = np.abs(three_tf32_sum(a, b, passes=1) - want) - F32_TOL * (1 + np.abs(want))
    assert excess.max() > 0
    assert (excess > 0).mean() > 0.01


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_inputs(n, h, w, c, k, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    wt = torch.randn(3, 3, c, k, device="cuda", generator=gen) * (2.0 / (9 * c)) ** 0.5
    scale = 1.0 + 0.3 * torch.randn(k, device="cuda", generator=gen)
    shift = 0.1 * torch.randn(k, device="cuda", generator=gen)
    return [x, wt, scale, shift]


def _check_route(args, bf16, route):
    """One launch on ``route`` against the plain version, allclose-style."""
    fn = fused_conv.conv3x3_bn_relu
    before, routes = fn.launches, dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    routes[route] += 1
    assert fn.launches == before + 1 and fn.route_launches == routes
    want = fused_conv.conv3x3_bn_relu_reference(*args, bf16)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = BF16_TOL if bf16 else F32_TOL
    excess = ((got.float() - want.float()).abs() - tol * (1 + want.float().abs())).max().item()
    assert excess <= 0 and bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 48, 512])
@pytest.mark.parametrize("K", [64, 72, 200])
def test_mma_route_matches_plain_on_card(C, K, bf16):
    """Ragged M (N*H*W = 143 and 189, not multiples of the 128-pixel tile),
    K with a ragged channel tile, C that leaves half a 32-channel bf16 step."""
    _card()
    for n, h, w in ((1, 11, 13), (3, 7, 9)):
        _check_route(_card_inputs(n, h, w, C, K, seed=C + K), bf16, "mma")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mma_route_takes_an_unaligned_view_on_card(bf16):
    """A contiguous view whose data starts off a 16-byte boundary is copied
    for the mma kernel's 16-byte loads, and gives the same result."""
    _card()
    args = _card_inputs(2, 7, 9, 16, 64, seed=7)
    flat = torch.zeros(1 + args[0].numel(), device="cuda",
                       dtype=torch.bfloat16 if bf16 else torch.float32)
    flat[1:] = args[0].flatten()
    x = flat[1:].view(args[0].shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check_route([x, *args[1:]], bf16, "mma")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,K", [(3, 64), (20, 70), (5, 7), (64, 7)])
def test_direct_route_matches_plain_on_card(C, K, bf16):
    _card()
    _check_route(_card_inputs(2, 9, 11, C, K, seed=C * K), bf16, "direct")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw,C,K", VGG16_LAYERS, ids=[f"layer{i + 1}" for i in range(13)])
def test_vgg16_layer_matches_plain_on_card(hw, C, K, bf16):
    _card()
    _check_route(_card_inputs(1, hw, hw, C, K, seed=hw + C), bf16,
                 fused_conv.conv3x3_route(C, K))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [64, 3])
def test_zero_halo_exact_on_card(C, bf16):
    """Ones everywhere: an interior output sums 9C, an edge 6C, a corner 4C,
    exactly, on both routes (the split of 1.0 has no small part)."""
    _card()
    x = torch.ones(2, 9, 7, C, device="cuda")
    out = fused_conv.conv3x3_bn_relu(x, torch.ones(3, 3, C, 64, device="cuda"),
                                     torch.ones(64, device="cuda"),
                                     torch.zeros(64, device="cuda"), bf16).float().cpu()
    want = torch.full((2, 9, 7, 64), 9.0 * C)
    want[:, [0, -1]] = 6.0 * C
    want[:, :, [0, -1]] = 6.0 * C
    for y in (0, -1):
        for xx in (0, -1):
            want[:, y, xx] = 4.0 * C
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_vgg16_forward_route_launches_on_card(bf16):
    """One VGG16 forward through extract/backbones.py: 13 launches, 12 on
    the mma kernel and the first layer on the direct kernel."""
    _card()
    from s2vt_tpu_torch.extract.backbones import VGG16
    torch.manual_seed(0)
    model = VGG16(compute_dtype=torch.bfloat16 if bf16 else None, use_pallas=True).cuda().eval()
    fn = fused_conv.conv3x3_bn_relu
    before, routes = fn.launches, dict(fn.route_launches)
    with torch.no_grad():
        feats = model(torch.rand(1, 224, 224, 3, device="cuda"))
    torch.cuda.synchronize()
    assert feats.shape == (1, 4096) and bool(torch.isfinite(feats).all())
    assert fn.launches - before == 13
    assert {k: fn.route_launches[k] - routes[k] for k in routes} == {"mma": 12, "direct": 1}


def test_variant_tool_undoes_each_choice_of_the_kernel_source():
    """tools/conv_mma_variants.py finds each float32 design choice in the
    kernel source (with the shared headers it includes written in place) by
    its exact text; each variant changes what it names."""
    from s2vt_tpu_torch.ops import _build
    from s2vt_tpu_torch.tools import conv_mma_variants as tool
    src = tool.kernel_source()
    assert '#include "mma.cuh"' not in src and "void split_tf32(" in src
    assert (_build.CSRC / "conv3x3_bn_relu.cu").read_text().count('#include "mma.cuh"') == 1
    got = tool.variants(src)
    assert got["as_built"] == src
    for name, gone in (("one_accumulator", "float part[4]"), ("cvt_rounding", "+ 0x1000u"),
                       ("rounded_small", tool._SMALL), ("warp_64x32", tool._MI),
                       ("warp_64x32_uncapped", tool._BOUNDS)):
        assert gone in src and gone not in got[name], name
    assert 'asm("cvt.rna.tf32.f32' in got["cvt_rounding"] and 'asm("cvt.rna' not in src
