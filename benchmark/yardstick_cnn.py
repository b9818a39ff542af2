"""The yardstick of feature extraction: operations and bytes of the fused
3x3 conv block and of VGG16's forward, counted from the shapes as the
model's equations define them (``benchmark/yardstick.py`` states the rule
and holds the card's peaks).

VGG16 is torchvision's cfg D (Simonyan & Zisserman, arXiv:1409.1556,
table 1, column D): 13 3x3 convs with stride 1 and SAME padding, five 2x2
max-pools, then fc6 (512*7*7 -> 4096) and fc7 (4096 -> 4096); the
extractor's ``last_linear`` (fc8) is the identity, so fc8 is not counted.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.yardstick import ITEMSIZE, Work

VGG16_CFG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")
FC_WIDTH = 4096


def conv3x3_bn_relu(N: int, H: int, W: int, C: int, K: int, dtype: str) -> Work:
    """#9, one conv block: reads x [N, H, W, C] (NHWC), w [3, 3, C, K] and
    the folded scale and shift [K] (float32); writes y [N, H, W, K]; the
    product of each output pixel's 9 C taps with w, 2 N H W 9 C K
    operations."""
    e = ITEMSIZE[dtype]
    nbytes = N * H * W * C * e + 9 * C * K * e + 2 * K * 4 + N * H * W * K * e
    return Work(2 * N * H * W * 9 * C * K, nbytes)


def vgg16_conv_shapes(input_size: int = 224) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, K) of VGG16's 13 conv blocks, in order, on a square input of
    ``input_size`` RGB pixels."""
    out, side, c = [], input_size, 3
    for v in VGG16_CFG_D:
        if v == "M":
            side //= 2
            continue
        out.append((side, side, c, v))
        c = v
    return out


def vgg16_conv_works(N: int, dtype: str, input_size: int = 224) -> List[Work]:
    """#9's work in each of the 13 blocks of a forward over N frames."""
    return [conv3x3_bn_relu(N, H, W, C, K, dtype) for H, W, C, K in vgg16_conv_shapes(input_size)]


def vgg16_frame_flops(input_size: int = 224) -> float:
    """Matrix-product operations of one frame through VGG16 up to fc7: the 13
    convs and the two fully connected layers (pools, BatchNorm and ReLU are
    not products)."""
    convs = sum(2 * H * W * 9 * C * K for H, W, C, K in vgg16_conv_shapes(input_size))
    side = input_size // 32
    flat = VGG16_CFG_D[-2] * side * side
    return convs + 2 * flat * FC_WIDTH + 2 * FC_WIDTH * FC_WIDTH
