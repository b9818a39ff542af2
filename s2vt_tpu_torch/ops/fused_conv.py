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
``conv3x3_bn_relu.launches``; for CPU tensors it runs
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

_LIB_NAME = "conv3x3_bn_relu"
_MAX_GRID_Z = 65535          # the kernel's grid holds one image per z index


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
    lib.conv3x3_bn_relu.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.conv3x3_bn_relu.restype = ci
    return lib


def conv3x3_ok(x_shape: Sequence[int], out_channels: int,
               device: Optional[torch.device] = None) -> bool:
    """Whether the kernel serves input ``x_shape`` (NHWC) with
    ``out_channels`` outputs on ``device``: any H, W, C and K (the first VGG
    layer's C = 3 included), at most 65535 images per launch. On the CPU the
    plain version serves every NHWC shape. (The TPU gate
    ``conv3x3_shapes_ok`` -- C and K multiples of 64, a VMEM budget -- is a
    fact of the TPU's tiles and VMEM.)"""
    if len(x_shape) != 4 or min(*x_shape, out_channels) < 1:
        return False
    device = torch.device(device if device is not None else "cpu")
    return device.type != "cuda" or x_shape[0] <= _MAX_GRID_Z


def conv3x3_bn_relu(x, weight, scale, shift, compute_bf16: bool = False) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) * scale + shift) (the reference's
    contract): x [N, H, W, C] float32 or bf16, weight [3, 3, C, K], scale and
    shift [K]. CUDA tensors launch the kernel once and add one to
    ``conv3x3_bn_relu.launches``; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, shift, compute_bf16)
    _check_args(x, weight, scale, shift)
    N, H, W, C = x.shape
    K = weight.shape[3]
    if not conv3x3_ok(x.shape, K, x.device):
        raise ValueError(f"conv3x3_bn_relu: {N} images exceed the kernel's {_MAX_GRID_Z} "
                         "per launch")
    mmd = torch.bfloat16 if compute_bf16 else torch.float32
    args = (x.to(mmd).contiguous(), weight.to(mmd).contiguous(),
            scale.float().contiguous(), shift.float().contiguous())
    _build.check_cuda("conv3x3_bn_relu", args)
    out = torch.empty(N, H, W, K, dtype=mmd, device=x.device)
    _build.launch(_kernel_lib(), "conv3x3_bn_relu", "conv3x3_bn_relu", (*args, out),
                  (N, H, W, C, K, int(compute_bf16)))
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0
