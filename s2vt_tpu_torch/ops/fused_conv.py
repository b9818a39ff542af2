"""Fused 3x3 conv + folded BatchNorm + ReLU (NHWC, stride 1, SAME) in one
CUDA launch.

Counterpart of ``s2vt_tpu/ops/pallas_conv.py``. Inference BatchNorm folds
into a per-channel affine, so one conv block of VGG16 is

    y = relu(conv3x3_same(x, w) * scale + shift)

with ``scale = gamma / sqrt(var + eps)`` and ``shift = beta - mean * scale``
plus the conv bias folded through ``scale`` (``fold_bn``); without
BatchNorm, ``scale = 1`` and ``shift`` is the conv bias. x is [N, H, W, C],
w [3, 3, C, K] (HWIO, the JAX package's layout), scale and shift [K].

``conv3x3_bn_relu`` launches the hand-written kernel
(``csrc/conv3x3_bn_relu.cu``) for CUDA tensors and adds one to
``conv3x3_bn_relu.launches`` and to its route's entry of
``conv3x3_bn_relu.route_launches``. The route is ``conv3x3_route(C, K)``:
"mma", an implicit GEMM on the tensor cores (bf16, or float32 as three TF32
passes), where C % 16 == 0 and K % 8 == 0 (every VGG16 layer but the
first); "direct", a direct convolution on the CUDA cores, for every other
shape. For CPU tensors it runs
``conv3x3_bn_relu_reference``: the TPU kernel's own formulation, nine
shifted [N*H*W, C] x [C, K] matrix products over the zero-padded image with
float32 sums. A CUDA tensor reaches the kernel or an exception. With
``compute_bf16`` x and w are rounded to bf16, the sums stay float32, and the
output is bf16, as the TPU kernel's is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted

_LIB_NAME = "conv3x3_bn_relu"
_MAX_GRID_Z = 65535          # the direct kernel's grid holds one image per z index
_MAX_PIXELS = 2 ** 31 - 1 - 128   # the mma kernel indexes output pixels N*H*W by int
_ENTRY = {"mma": "conv3x3_bn_relu_mma", "direct": "conv3x3_bn_relu"}


def _check_args(x, weight, scale, shift):
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(f"x must be [N, H, W, C] and weight [3, 3, C, K]; got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    K = weight.shape[3]
    if weight.shape[2] != x.shape[3] or tuple(scale.shape) != (K,) or tuple(shift.shape) != (K,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"scale {tuple(scale.shape)}, shift {tuple(shift.shape)}")
    if len({t.device for t in (x, weight, scale, shift)}) != 1:
        raise ValueError("x, weight, scale and shift lie on several devices")


def fold_bn(conv_bias: Optional[torch.Tensor], channels: int,
            bn: Optional[Sequence[torch.Tensor]] = None, eps: float = 1e-5,
            device=None):
    """(scale, shift) [K] float32 of a conv block: ``bn`` is (weight, bias,
    running_mean, running_var) of an inference BatchNorm after the conv, or
    None. The JAX package's BN is ``x * inv + (bias - mean * inv)`` with
    ``inv = weight * rsqrt(var + eps)``; the conv bias goes through inv."""
    if bn is None:
        scale = torch.ones(channels, dtype=torch.float32, device=device)
        shift = (conv_bias.float() if conv_bias is not None
                 else torch.zeros(channels, dtype=torch.float32, device=device))
        return scale, shift
    gamma, beta, mean, var = (t.float() for t in bn)
    inv = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * inv
    if conv_bias is not None:
        shift = shift + conv_bias.float() * inv
    return inv, shift


@torch.no_grad()
def conv3x3_bn_relu_reference(x, weight, scale, shift, compute_bf16: bool = False):
    """Plain PyTorch version of the kernel: nine shifted matrix products
    (``pallas_conv.py::_conv_kernel``), then the affine and ReLU. Returns
    [N, H, W, K] in float32, or bf16 with ``compute_bf16``."""
    _check_args(x, weight, scale, shift)
    mmd = torch.bfloat16 if compute_bf16 else torch.float32
    N, H, W, C = x.shape
    K = weight.shape[3]
    xp = F.pad(x.to(mmd).float(), (0, 0, 1, 1, 1, 1))         # [N, H+2, W+2, C]
    wq = weight.to(mmd).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[:, dy:dy + H, dx:dx + W, :].reshape(N * H * W, C) @ wq[dy, dx]
            acc = part if acc is None else acc + part
    y = torch.relu(acc * scale.float() + shift.float())
    return y.reshape(N, H, W, K).to(mmd)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in _ENTRY.values():
        getattr(lib, entry).argtypes = [vp] * 5 + [ci] * 7 + [vp]
        getattr(lib, entry).restype = ci
    return lib


def conv3x3_route(in_channels: int, out_channels: int) -> str:
    """The kernel that serves C = ``in_channels`` -> K = ``out_channels`` on
    the card: "mma" (tensor cores; its 16-byte copies need C % 16 == 0 and
    K % 8 == 0) or "direct" (CUDA cores, any C and K)."""
    return "mma" if in_channels % 16 == 0 and out_channels % 8 == 0 else "direct"


def conv3x3_ok(x_shape: Sequence[int], out_channels: int,
               device: Optional[torch.device] = None) -> bool:
    """Whether the kernel serves input ``x_shape`` (NHWC) with
    ``out_channels`` outputs on ``device``: any H, W, C and K (the first VGG
    layer's C = 3 included) and any batch, split into launches of at most
    2^31 - 129 output pixels N*H*W on the mma route and at most 65535 images
    on the direct route; so on the mma route one image may hold at most
    2^31 - 129 pixels. On the CPU the plain version serves every NHWC
    shape. (The TPU gate ``conv3x3_shapes_ok`` -- C and K multiples of 64, a
    VMEM budget -- is a fact of the TPU's tiles and VMEM.)"""
    if len(x_shape) != 4 or min(*x_shape, out_channels) < 1:
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    return _images_per_launch(x_shape, out_channels) >= 1


def _images_per_launch(x_shape: Sequence[int], out_channels: int) -> int:
    """The most images of ``x_shape`` (NHWC) one launch of the route takes."""
    N, H, W, C = x_shape
    if conv3x3_route(C, out_channels) == "mma":
        return _MAX_PIXELS // (H * W)
    return _MAX_GRID_Z


def conv3x3_bn_relu(x, weight, scale, shift, compute_bf16: bool = False) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) * scale + shift) (the reference's
    contract): x [N, H, W, C] float32 or bf16, weight [3, 3, C, K], scale and
    shift [K]. CUDA tensors launch the kernel of ``conv3x3_route(C, K)`` once
    (a batch beyond one launch's grid: once per slice of the batch that fits
    it) and add one to ``conv3x3_bn_relu.launches`` and to
    ``conv3x3_bn_relu.route_launches[route]`` per launch; CPU tensors run the
    plain version."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, shift, compute_bf16)
    _check_args(x, weight, scale, shift)
    N, H, W, C = x.shape
    K = weight.shape[3]
    route = conv3x3_route(C, K)
    if not conv3x3_ok(x.shape, K, x.device):
        raise ValueError(f"conv3x3_bn_relu: an image of {tuple(x.shape)} exceeds the {route} "
                         f"kernel's grid ({_MAX_PIXELS} pixels)")
    mmd = torch.bfloat16 if compute_bf16 else torch.float32
    args = [x.to(mmd).contiguous(), weight.to(mmd).contiguous(),
            scale.float().contiguous(), shift.float().contiguous()]
    _build.check_cuda("conv3x3_bn_relu", args)
    if route == "mma":        # 16-byte copies: a view at an odd offset gets its own storage
        args[:2] = [t if t.data_ptr() % 16 == 0 else t.clone() for t in args[:2]]
    out = torch.empty(N, H, W, K, dtype=mmd, device=x.device)
    step = _images_per_launch(x.shape, K)
    for n0 in range(0, N, step):          # slices along N of contiguous NHWC stay contiguous
        n = min(step, N - n0)
        _build.launch(_kernel_lib(), _ENTRY[route], "conv3x3_bn_relu",
                      (args[0][n0:n0 + n], *args[1:], out[n0:n0 + n]),
                      (n, H, W, C, K, int(compute_bf16)))
        conv3x3_bn_relu.launches += 1
        conv3x3_bn_relu.route_launches[route] += 1
    return out


counted(conv3x3_bn_relu, "mma", "direct")
