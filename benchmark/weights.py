"""Seeded S2VT weights, made on the device from ``--seed`` in a few large
calls, under the parameter names of the model's state_dict. The same seed
gives the same tensors on the same device, so the program and the
reference each take them from here and nothing passes between them.

Initial values follow PyTorch's defaults, as the reference's modules draw
them: every RNN tensor U(-1/sqrt(H), 1/sqrt(H)), a linear layer's weight
and bias U(-1/sqrt(in), 1/sqrt(in)), the embedding N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one of a run's random streams."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


# The run's random streams.
WEIGHTS, DATA, WORDS, ORDER, SAMPLE = range(5)


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, bound) of every parameter; bound 0 marks N(0, 1)."""
    H, E, F, V = cfg["dim_hidden"], cfg["dim_embed"], cfg["feat_dim"], cfg["vocab_size"]
    G = (4 if cfg["rnn_type"] == "lstm" else 3) * H
    k = 1.0 / math.sqrt(H)
    specs = []
    for chain, n_in in (("vid_rnn", H), ("word_rnn", E + H)):
        specs += [(f"{chain}.l0.w_ih", (G, n_in), k), (f"{chain}.l0.w_hh", (G, H), k),
                  (f"{chain}.l0.b_ih", (G,), k), (f"{chain}.l0.b_hh", (G,), k)]
    specs += [("feat_linear.weight", (H, F), 1.0 / math.sqrt(F)),
              ("feat_linear.bias", (H,), 1.0 / math.sqrt(F)),
              ("out_linear.weight", (V, H), k), ("out_linear.bias", (V,), k),
              ("embedding.weight", (V, E), 0.0)]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's float32 weights on ``device``: one uniform draw for every
    bounded tensor, one normal draw for the embedding."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    specs = param_specs(cfg)
    uniform = [s for s in specs if s[2] > 0]
    flat = torch.rand(sum(math.prod(s[1]) for s in uniform), generator=gen, device=device)
    flat = flat.mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, bound in uniform:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul(bound)
        at += n
    for name, shape, _ in specs:
        if name not in out:
            out[name] = torch.randn(shape, generator=gen, device=device)
    return out
