"""Plain VGG16-BN feature extraction in float32 PyTorch: the benchmark's
reference for the extraction cells.

Written from the definitions (the reference repo's extract_features.py:
38-143 with pretrainedmodels' ``vgg16_bn`` and its TransformImage;
torchvision's cfg D, Simonyan & Zisserman, arXiv:1409.1556); it imports
nothing of the program under test.

- Preprocess: uint8 RGB frames scaled to [0, 1]; the shorter side resized
  to int(input_size / 0.875) and the longer with it (truncated), by a
  bilinear resize with antialiasing: along each axis, output o samples the
  input at (o + 0.5) * in / out - 0.5 with the triangle filter widened by
  the downscale factor (never narrowed), each output's weights summing to
  one; as two separable matrix products, computed in float64 and rounded
  once. Then the centre crop of input_size, and (x - mean) / std.
- 13 x (3x3 conv with stride 1 and one pixel of zeros, its bias; BatchNorm
  as (x - running_mean) / sqrt(running_var + eps) * weight + bias; ReLU),
  a 2x2 max-pool after each stage; flatten in CHW order; fc6 + ReLU, fc7 +
  ReLU (``last_linear`` is the identity).

Every product runs in float32 with TF32 off (``precision="float32"``), or,
for the control, with both operands rounded to TF32 (``precision="tf32"``),
what the tensor cores' TF32 mode computes, on any device.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.s2vt import tf32_round
from benchmark.yardstick_cnn import VGG16_CFG_D

Params = Dict[str, torch.Tensor]


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if precision == "tf32":
        return tf32_round(x)
    if precision != "float32":
        raise ValueError(f"precision {precision!r}")
    return x


@functools.lru_cache(maxsize=16)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of the antialiased bilinear resize
    along one axis, from the triangle filter's definition."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    centre = (np.arange(out_size) + 0.5) * scale - 0.5
    dist = np.abs(centre[:, None] - np.arange(in_size)[None, :]) / support
    w = np.maximum(0.0, 1.0 - dist)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def preprocess(frames: torch.Tensor, cfg: dict, precision: str = "float32") -> torch.Tensor:
    """uint8 frames [N, H, W, 3] -> normalised float32 [N, 3, S, S] (NCHW)."""
    N, H, W, _ = frames.shape
    S = cfg["input_size"]
    side = int(S / cfg["resize_scale"])
    new_h, new_w = ((side, max(int(side * W / H), side)) if H <= W
                    else (max(int(side * H / W), side), side))
    top, left = (new_h - S) // 2, (new_w - S) // 2
    dev = frames.device
    rows = torch.from_numpy(resize_matrix(H, new_h)[top:top + S]).to(dev)
    cols = torch.from_numpy(resize_matrix(W, new_w)[left:left + S]).to(dev)
    x = frames.permute(0, 3, 1, 2).float() / 255.0                 # [N, 3, H, W]
    x = _operand(rows, precision) @ _operand(x, precision)         # [N, 3, S, W]
    x = _operand(x, precision) @ _operand(cols, precision).T       # [N, 3, S, S]
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=dev)[:, None, None]
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=dev)[:, None, None]
    return (x - mean) / std


def backbone(params: Params, x: torch.Tensor, cfg: dict, precision: str = "float32",
             skip_bn: Optional[int] = None) -> torch.Tensor:
    """Normalised frames [N, 3, S, S] -> fc7 features [N, 4096]. ``skip_bn``
    (a conv's place, 0-12) leaves that conv's BatchNorm out: a fault."""
    i, conv = 0, 0
    for v in VGG16_CFG_D:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            i += 1
            continue
        x = F.conv2d(_operand(x, precision), _operand(params[f"_features.{i}.weight"], precision),
                     params[f"_features.{i}.bias"], padding=1)
        if conv != skip_bn:
            bn = f"_features.{i + 1}."
            shape = (1, -1, 1, 1)
            x = ((x - params[bn + "running_mean"].view(shape))
                 / torch.sqrt(params[bn + "running_var"].view(shape) + cfg["bn_eps"])
                 * params[bn + "weight"].view(shape) + params[bn + "bias"].view(shape))
        x = torch.relu(x)
        i, conv = i + 3, conv + 1
    x = x.flatten(1)                                               # CHW order
    for name in ("linear0", "linear1"):
        x = _operand(x, precision) @ _operand(params[f"{name}.weight"], precision).T
        x = torch.relu(x + params[f"{name}.bias"])
    return x


@torch.no_grad()
def features(params: Params, frames: torch.Tensor, cfg: dict, precision: str = "float32",
             skip_bn: Optional[int] = None, block: int = 80) -> torch.Tensor:
    """uint8 frames [N, H, W, 3] -> features [N, 4096] float32, ``block``
    frames at a time so that it fits."""
    return torch.cat([backbone(params, preprocess(frames[k:k + block], cfg, precision), cfg,
                               precision, skip_bn)
                      for k in range(0, frames.shape[0], block)])
