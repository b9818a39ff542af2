"""CNN backbones for frame feature extraction, as ``torch.nn`` modules.

Counterpart of ``s2vt_tpu/extract/backbones.py``: vgg16 (and vgg16_bn),
resnet152 and inception_v4 as the reference loads them from the
``pretrainedmodels`` zoo, with ``last_linear`` replaced by the identity, so
they emit penultimate features (4096-d VGG, 2048-d ResNet152, 1536-d
InceptionV4), and a ``tiny`` 8-d backbone for CPU smoke runs. Module names
follow pretrainedmodels (``_features.N``, ``linear0``, ``linear1``;
``conv1``, ``bn1``, ``layerL.B.convK``, ``downsample``;
``features.N.branchX[.M].conv/bn``), so a zoo checkpoint loads by name
(``torch_weights.py``).

Every backbone takes normalized frames NHWC [N, S, S, 3] float32 (the JAX
package's layout) and returns [N, feat_dim] float32. Inside, activations are
NCHW tensors in ``channels_last`` memory, so a view as NHWC needs no copy.
BatchNorm runs in inference mode with the JAX package's formula and eps
(1e-5; 1e-3 in InceptionV4's BasicConv2d). With ``compute_dtype`` bf16 the
operands of every conv and linear are rounded to bf16 and the products and
sums stay float32, as ``preferred_element_type=float32`` does there.

With ``use_pallas`` each of VGG16's 13 3x3 conv (+ BN) + ReLU blocks runs
one launch of the fused conv kernel (``ops/fused_conv.py``; on CPU tensors
its plain version), with BN and the conv bias folded into (scale, shift).
ResNet152 and InceptionV4 convs run ``F.conv2d``: the JAX package computes
them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2vt_tpu_torch.extract import preprocess as pp
from s2vt_tpu_torch.ops.layers import mm_operand


class Conv(nn.Conv2d):
    """torch Conv2d whose operands are rounded to ``compute_dtype`` and
    multiplied in float32."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, bias=True,
                 compute_dtype=None):
        super().__init__(in_ch, out_ch, kernel, stride, padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.conv2d(mm_operand(x, self.compute_dtype), mm_operand(self.weight,
                                                                      self.compute_dtype),
                        self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm with stored statistics, the JAX package's formula
    ``x * inv + (bias - mean * inv)``, ``inv = weight * rsqrt(var + eps)``.
    Its state_dict holds weight, bias, running_mean and running_var (no
    num_batches_tracked, which checkpoints drop)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def stats(self):
        return self.weight, self.bias, self.running_mean, self.running_var

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class Linear(nn.Linear):
    """torch Linear whose operands are rounded to ``compute_dtype``."""

    def __init__(self, in_f, out_f, compute_dtype=None):
        super().__init__(in_f, out_f)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = mm_operand(x, self.compute_dtype) @ mm_operand(self.weight, self.compute_dtype).T
        return y + self.bias


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC frames -> an NCHW view in channels_last memory (no copy)."""
    return x_nhwc.float().permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# VGG-16 (torchvision cfg D), pretrainedmodels layout.
# ---------------------------------------------------------------------------

_VGG_CFG_D = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16(nn.Module):
    def __init__(self, batch_norm: bool = False, compute_dtype=None, use_pallas: bool = False):
        super().__init__()
        self.batch_norm, self.compute_dtype, self.use_pallas = (batch_norm, compute_dtype,
                                                                use_pallas)
        layers, in_ch = [], 3
        for v in _VGG_CFG_D:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(Conv(in_ch, v, 3, padding=1, compute_dtype=compute_dtype))
            if batch_norm:
                layers.append(BatchNorm(v))
            layers.append(nn.ReLU())
            in_ch = v
        self._features = nn.Sequential(*layers)
        self.linear0 = Linear(512 * 7 * 7, 4096, compute_dtype)
        self.linear1 = Linear(4096, 4096, compute_dtype)

    def blocks(self):
        """(conv, bn or None) of each conv block, or "M" for each max-pool, in
        order."""
        mods, out, i = list(self._features), [], 0
        while i < len(mods):
            if isinstance(mods[i], nn.MaxPool2d):
                out.append("M")
                i += 1
                continue
            bn = mods[i + 1] if self.batch_norm else None
            out.append((mods[i], bn))
            i += 3 if self.batch_norm else 2
        return out

    def _block_kernel(self, x, conv, bn):
        from s2vt_tpu_torch.ops.fused_conv import conv3x3_bn_relu, fold_bn
        scale, shift = fold_bn(conv.bias, conv.out_channels,
                               bn.stats() if bn is not None else None,
                               bn.eps if bn is not None else 0.0, x.device)
        y = conv3x3_bn_relu(x.permute(0, 2, 3, 1).contiguous(),
                            conv.weight.permute(2, 3, 1, 0).contiguous(), scale, shift,
                            self.compute_dtype == torch.bfloat16)
        return y.permute(0, 3, 1, 2)

    def forward(self, x):
        x = _nchw(x)
        for block in self.blocks():
            if block == "M":
                x = F.max_pool2d(x, 2, 2)
            elif self.use_pallas:
                x = self._block_kernel(x, *block)
            else:
                conv, bn = block
                x = conv(x)
                x = torch.relu(bn(x) if bn is not None else x)
        x = x.float().reshape(x.shape[0], -1)      # torch flattens CHW
        x = torch.relu(self.linear0(x))
        return torch.relu(self.linear1(x))         # last_linear == Identity


# ---------------------------------------------------------------------------
# ResNet-152 (bottleneck [3, 8, 36, 3]).
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False, compute_dtype=None):
        super().__init__()
        cdt = compute_dtype
        self.conv1 = Conv(inplanes, planes, 1, bias=False, compute_dtype=cdt)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False, compute_dtype=cdt)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, compute_dtype=cdt)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(Conv(inplanes, planes * 4, 1, stride, bias=False,
                                              compute_dtype=cdt), BatchNorm(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet152(nn.Module):
    def __init__(self, layers=(3, 8, 36, 3), compute_dtype=None):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, compute_dtype=compute_dtype)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for li, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
            stride = 1 if li == 1 else 2
            mods = [Bottleneck(inplanes, planes, stride, True, compute_dtype)]
            inplanes = planes * 4
            mods += [Bottleneck(inplanes, planes, compute_dtype=compute_dtype)
                     for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(_nchw(x))))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))                  # last_linear == Identity


# ---------------------------------------------------------------------------
# Inception-V4 (pretrainedmodels layout: features.0..21), input 299 x 299.
# ---------------------------------------------------------------------------


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + ReLU, named 'conv' and 'bn'."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, compute_dtype=None):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, padding, bias=False,
                         compute_dtype=compute_dtype)
        self.bn = BatchNorm(out_ch, eps=1e-3)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class Mixed3a(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.conv = BasicConv2d(64, 96, 3, 2, compute_dtype=cdt)

    def forward(self, x):
        return torch.cat([_max_pool(x), self.conv(x)], 1)


class Mixed4a(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(160, 64, 1, compute_dtype=cdt),
                                     BasicConv2d(64, 96, 3, compute_dtype=cdt))
        self.branch1 = nn.Sequential(
            BasicConv2d(160, 64, 1, compute_dtype=cdt),
            BasicConv2d(64, 64, (1, 7), padding=(0, 3), compute_dtype=cdt),
            BasicConv2d(64, 64, (7, 1), padding=(3, 0), compute_dtype=cdt),
            BasicConv2d(64, 96, 3, compute_dtype=cdt))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class Mixed5a(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.conv = BasicConv2d(192, 192, 3, 2, compute_dtype=cdt)

    def forward(self, x):
        return torch.cat([self.conv(x), _max_pool(x)], 1)


def _pooled(conv: BasicConv2d) -> nn.Sequential:
    """branch3 of the Inception blocks: an average pool without padding in
    its counts, then a 1x1 BasicConv2d (named ``branch3.1``)."""
    return nn.Sequential(nn.AvgPool2d(3, 1, 1, count_include_pad=False), conv)


class InceptionA(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.branch0 = BasicConv2d(384, 96, 1, compute_dtype=cdt)
        self.branch1 = nn.Sequential(BasicConv2d(384, 64, 1, compute_dtype=cdt),
                                     BasicConv2d(64, 96, 3, padding=1, compute_dtype=cdt))
        self.branch2 = nn.Sequential(BasicConv2d(384, 64, 1, compute_dtype=cdt),
                                     BasicConv2d(64, 96, 3, padding=1, compute_dtype=cdt),
                                     BasicConv2d(96, 96, 3, padding=1, compute_dtype=cdt))
        self.branch3 = _pooled(BasicConv2d(384, 96, 1, compute_dtype=cdt))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class ReductionA(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.branch0 = BasicConv2d(384, 384, 3, 2, compute_dtype=cdt)
        self.branch1 = nn.Sequential(BasicConv2d(384, 192, 1, compute_dtype=cdt),
                                     BasicConv2d(192, 224, 3, padding=1, compute_dtype=cdt),
                                     BasicConv2d(224, 256, 3, 2, compute_dtype=cdt))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool(x)], 1)


class InceptionB(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.branch0 = BasicConv2d(1024, 384, 1, compute_dtype=cdt)
        self.branch1 = nn.Sequential(
            BasicConv2d(1024, 192, 1, compute_dtype=cdt),
            BasicConv2d(192, 224, (1, 7), padding=(0, 3), compute_dtype=cdt),
            BasicConv2d(224, 256, (7, 1), padding=(3, 0), compute_dtype=cdt))
        self.branch2 = nn.Sequential(
            BasicConv2d(1024, 192, 1, compute_dtype=cdt),
            BasicConv2d(192, 192, (7, 1), padding=(3, 0), compute_dtype=cdt),
            BasicConv2d(192, 224, (1, 7), padding=(0, 3), compute_dtype=cdt),
            BasicConv2d(224, 224, (7, 1), padding=(3, 0), compute_dtype=cdt),
            BasicConv2d(224, 256, (1, 7), padding=(0, 3), compute_dtype=cdt))
        self.branch3 = _pooled(BasicConv2d(1024, 128, 1, compute_dtype=cdt))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class ReductionB(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(1024, 192, 1, compute_dtype=cdt),
                                     BasicConv2d(192, 192, 3, 2, compute_dtype=cdt))
        self.branch1 = nn.Sequential(
            BasicConv2d(1024, 256, 1, compute_dtype=cdt),
            BasicConv2d(256, 256, (1, 7), padding=(0, 3), compute_dtype=cdt),
            BasicConv2d(256, 320, (7, 1), padding=(3, 0), compute_dtype=cdt),
            BasicConv2d(320, 320, 3, 2, compute_dtype=cdt))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cdt=None):
        super().__init__()
        b = lambda i, o, k, p=0: BasicConv2d(i, o, k, padding=p, compute_dtype=cdt)  # noqa: E731
        self.branch0 = b(1536, 256, 1)
        self.branch1_0 = b(1536, 384, 1)
        self.branch1_1a = b(384, 256, (1, 3), (0, 1))
        self.branch1_1b = b(384, 256, (3, 1), (1, 0))
        self.branch2_0 = b(1536, 384, 1)
        self.branch2_1 = b(384, 448, (3, 1), (1, 0))
        self.branch2_2 = b(448, 512, (1, 3), (0, 1))
        self.branch2_3a = b(512, 256, (1, 3), (0, 1))
        self.branch2_3b = b(512, 256, (3, 1), (1, 0))
        self.branch3 = _pooled(b(1536, 256, 1))

    def forward(self, x):
        b1 = self.branch1_0(x)
        b1 = torch.cat([self.branch1_1a(b1), self.branch1_1b(b1)], 1)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        b2 = torch.cat([self.branch2_3a(b2), self.branch2_3b(b2)], 1)
        return torch.cat([self.branch0(x), b1, b2, self.branch3(x)], 1)


class InceptionV4(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        cdt = compute_dtype
        self.features = nn.Sequential(
            BasicConv2d(3, 32, 3, 2, compute_dtype=cdt),
            BasicConv2d(32, 32, 3, compute_dtype=cdt),
            BasicConv2d(32, 64, 3, padding=1, compute_dtype=cdt),
            Mixed3a(cdt), Mixed4a(cdt), Mixed5a(cdt),
            *(InceptionA(cdt) for _ in range(4)),
            ReductionA(cdt),
            *(InceptionB(cdt) for _ in range(7)),
            ReductionB(cdt),
            *(InceptionC(cdt) for _ in range(3)))

    def forward(self, x):
        return self.features(_nchw(x)).mean(dim=(2, 3))   # last_linear == Identity


class TinyConv(nn.Module):
    """Minimal conv backbone (16 x 16 input -> 8-d features), a registry
    entry so that ``--backbone tiny`` works for smoke runs and CPU demos. Its
    conv keeps float32 operands, as the JAX package's does."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 8, 3, 2, 1)

    def forward(self, x):
        return torch.relu(self.conv(_nchw(x)).mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# name: (factory(compute_dtype, use_pallas), input_size, feat_dim, mean, std)
BACKBONE_SPECS: Dict[str, Tuple[Callable, int, int, tuple, tuple]] = {
    "vgg16": (lambda cdt, k: VGG16(False, cdt, k), 224, 4096, pp.IMAGENET_MEAN,
              pp.IMAGENET_STD),
    "vgg16_bn": (lambda cdt, k: VGG16(True, cdt, k), 224, 4096, pp.IMAGENET_MEAN,
                 pp.IMAGENET_STD),
    "resnet152": (lambda cdt, k: ResNet152(compute_dtype=cdt), 224, 2048, pp.IMAGENET_MEAN,
                  pp.IMAGENET_STD),
    "inception_v4": (lambda cdt, k: InceptionV4(cdt), 299, 1536, pp.INCEPTION_MEAN,
                     pp.INCEPTION_STD),
    "tiny": (lambda cdt, k: TinyConv(), 16, 8, pp.IMAGENET_MEAN, pp.IMAGENET_STD),
}


def build_backbone(name: str, compute_dtype: Optional[torch.dtype] = None,
                   use_pallas: bool = False, seed: int = 0):
    """(model, spec) with random weights drawn from ``seed`` (torch's default
    init; BN statistics at their identity values). Load pretrained weights
    with ``torch_weights.load_torch_checkpoint``."""
    if name not in BACKBONE_SPECS:
        raise ValueError(f"unknown backbone {name!r}; choose from {sorted(BACKBONE_SPECS)}")
    factory, size, feat_dim, mean, std = BACKBONE_SPECS[name]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = factory(compute_dtype, use_pallas)
    spec = {"input_size": size, "feat_dim": feat_dim, "mean": mean, "std": std}
    return model.eval(), spec
