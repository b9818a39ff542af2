"""Frame sampling and on-device image preprocessing.

Counterpart of ``s2vt_tpu/extract/preprocess.py``. The sampling indices are
copies (numpy, the reference's own math):

 - 'fix'  mode: ``np.linspace(0, N-1, frames_num).astype(int)``
 - 'free' mode: ``np.arange(0, N, interval)``

``preprocess_frames`` runs on tensors, on the frames' device: resize the
shorter side to ``int(input_size / 0.875)`` (bilinear with antialiasing),
center-crop ``input_size``, scale to [0, 1] and normalize. It reproduces
``jax.image.resize(..., "bilinear", antialias=True)``: the same per-axis
triangle-filter weight matrices (``jax._src.image.scale.compute_weight_mat``:
the filter widened by the downscale factor, each output's weights normalized
to sum to one), applied as two matrix products. Only the rows and columns
that survive the crop are computed.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

# pretrainedmodels preprocessing constants (TransformImage: scale 0.875,
# imagenet mean/std; inception uses 0.5/0.5 at 299 px).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def fix_sample_indices(num_frames: int, frames_num: int = 80) -> np.ndarray:
    """Evenly spaced, endpoints included (the reference's extract_features.py:98)."""
    return np.linspace(0, num_frames - 1, frames_num).astype(int)


def free_sample_indices(num_frames: int, interval: int = 10) -> np.ndarray:
    """Every ``interval``-th frame (the reference's extract_features.py:65)."""
    return np.arange(0, num_frames, interval).astype(int)


def resized_shape(height: int, width: int, input_size: int, scale: float = 0.875):
    """(new_h, new_w): the shorter side to int(input_size / scale), the longer
    scaled with it and truncated, as TransformImage and the JAX package do."""
    target = int(input_size / scale)
    if height <= width:
        return target, max(int(target * width / height), target)
    return max(int(target * height / width), target), target


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of a bilinear antialiased resize
    along one axis, computed in float32 as ``jax.image.resize`` computes them
    (a size kept as it is gives the identity)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - x).astype(np.float32)     # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32).T


def preprocess_frames(frames: torch.Tensor, mean: Sequence[float], std: Sequence[float],
                      input_size: int = 224, scale: float = 0.875) -> torch.Tensor:
    """uint8 RGB frames [N, H, W, 3] -> normalized float32 [N, S, S, 3] on
    the frames' device (S = ``input_size``)."""
    N, H, W, C = frames.shape
    new_h, new_w = resized_shape(H, W, input_size, scale)
    top, left = (new_h - input_size) // 2, (new_w - input_size) // 2
    dev = frames.device
    wh = torch.from_numpy(resize_weights(H, new_h)[top:top + input_size]).to(dev)
    ww = torch.from_numpy(resize_weights(W, new_w)[left:left + input_size]).to(dev)
    x = frames.float() / 255.0
    x = torch.einsum("nhwc,oh->nowc", x, wh)
    x = torch.einsum("nowc,pw->nopc", x, ww)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    return (x - mean_t) / std_t
