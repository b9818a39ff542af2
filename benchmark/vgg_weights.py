"""Seeded VGG16-BN weights and raw frames, made on the device from
``--seed`` in a few large calls, so that the program and the reference each
take them from here and nothing passes between them.

Names are those of a pretrainedmodels ``vgg16_bn`` state_dict with
``last_linear`` dropped: ``_features.<i>`` holds conv i's ``weight``
[K, C, 3, 3] and ``bias``, ``_features.<i+1>`` its BatchNorm's ``weight``,
``bias``, ``running_mean`` and ``running_var`` (then ReLU at i+2, a 2x2
max-pool after each stage), ``linear0`` is fc6 and ``linear1`` fc7.

Draws: conv weights He-normal (std sqrt(2 / (9 K)), fan_out with ReLU's
gain, as torchvision draws VGG's), conv biases U(-0.01, 0.01); BatchNorm
weight and running_var U(0.5, 1.5), bias and running_mean U(-0.1, 0.1), so
that the fold of BN does real work; each linear's weight and bias
U(-1/sqrt(in), 1/sqrt(in)). Frames are uniform uint8 RGB.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.weights import DATA, WEIGHTS, sub_seed
from benchmark.yardstick_cnn import FC_WIDTH, VGG16_CFG_D

CONV_BIAS = 0.01
BN_SCALE = (0.5, 1.5)       # BN weight and running_var
BN_SHIFT = (-0.1, 0.1)      # BN bias and running_mean


def conv_layers() -> List[Tuple[int, int, int]]:
    """(module index, C, K) of each conv, in order."""
    out, i, c = [], 0, 3
    for v in VGG16_CFG_D:
        if v == "M":
            i += 1
            continue
        out.append((i, c, v))
        c, i = v, i + 3
    return out


def _uniform_specs(input_size: int) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, low, high) of every uniformly drawn tensor."""
    specs = []
    for i, c, k in conv_layers():
        specs.append((f"_features.{i}.bias", (k,), -CONV_BIAS, CONV_BIAS))
        specs += [(f"_features.{i + 1}.weight", (k,), *BN_SCALE),
                  (f"_features.{i + 1}.bias", (k,), *BN_SHIFT),
                  (f"_features.{i + 1}.running_mean", (k,), *BN_SHIFT),
                  (f"_features.{i + 1}.running_var", (k,), *BN_SCALE)]
    side = input_size // 32
    for name, n_in in (("linear0", VGG16_CFG_D[-2] * side * side), ("linear1", FC_WIDTH)):
        b = 1.0 / math.sqrt(n_in)
        specs += [(f"{name}.weight", (FC_WIDTH, n_in), -b, b), (f"{name}.bias", (FC_WIDTH,), -b, b)]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's float32 weights on ``device``: one normal draw for every
    conv weight, one uniform draw for the rest."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    size = cfg["input_size"]
    convs = conv_layers()
    normal = torch.randn(sum(9 * c * k for _, c, k in convs), generator=gen, device=device)
    out, at = {}, 0
    for i, c, k in convs:
        out[f"_features.{i}.weight"] = normal[at:at + 9 * c * k].view(k, c, 3, 3).mul(
            math.sqrt(2.0 / (9 * k)))
        at += 9 * c * k
    specs = _uniform_specs(size)
    flat = torch.rand(sum(math.prod(s[1]) for s in specs), generator=gen, device=device)
    at = 0
    for name, shape, lo, hi in specs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul(hi - lo).add_(lo)
        at += n
    return out


def make_frames(traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of seeded clips [pool_clips, frames_per_clip, frame_h,
    frame_w, 3], uint8 on ``device``, in one draw."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    shape = (traffic["pool_clips"], traffic["frames_per_clip"], traffic["frame_h"],
             traffic["frame_w"], 3)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
