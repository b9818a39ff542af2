"""Torch-layout dense / embedding layers with the reference's init.

Counterpart of ``s2vt_tpu/ops/layers.py``. Weights keep the torch layout
([out, in]); ``compute_dtype`` casts matmul operands while products are
summed in float32, as ``jax.lax.dot_general(..., preferred_element_type=
float32)`` does there. The bf16 operands are widened to float32 before the
product, which is exact, so the only rounding is the cast itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

NEG_INF = -1e30


def mm_operand(x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A matmul operand rounded to ``compute_dtype`` and held in float32."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return x.float()


def apply_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W^T (+ b): operands in ``compute_dtype``, float32 accumulate."""
    y = mm_operand(x, compute_dtype) @ mm_operand(weight, compute_dtype).T
    if bias is not None:
        y = y + bias
    return y


def mask_invalid_vocab(logits: torch.Tensor, valid_vocab: Optional[int]) -> torch.Tensor:
    """Mask the padding rows of a padded vocab (Opt.vocab_pad_multiple) out
    of decode-time logits."""
    if valid_vocab is None or valid_vocab >= logits.shape[-1]:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) < valid_vocab
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (torch nn.Dropout semantics) drawing its mask from an
    explicit generator, which may live on another device than ``x``."""
    if deterministic or rate <= 0.0:
        return x
    gen_device = generator.device if generator is not None else x.device
    keep = torch.rand(x.shape, generator=generator, device=gen_device).to(x.device)
    keep = keep < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TorchLinear(nn.Module):
    """y = x @ W^T (+ b) with torch layout and init, ``compute_dtype`` matmul.
    Without ``use_bias`` there is no ``bias`` entry in the state_dict, as in
    the JAX tree."""

    def __init__(self, out_features: int, in_features: int, use_bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_linear(x, self.weight, self.bias, self.compute_dtype)


class TorchEmbedding(nn.Module):
    """Lookup table with torch's N(0, 1) init. With ``padding_idx`` that row
    is zero at init and gets no gradient (``nn.Embedding``'s padding_idx; the
    attention baseline uses 0)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: Optional[int] = None):
        super().__init__()
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.padding_idx is not None:
                self.weight[self.padding_idx] = 0.0

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight, padding_idx=self.padding_idx)
