"""Pretrained backbone checkpoints (``pretrainedmodels`` state_dicts) for the
port's backbones.

Counterpart of ``s2vt_tpu/extract/torch_weights.py``. The reference loads
imagenet weights from the ``pretrainedmodels`` zoo; those checkpoints are
torch state_dicts already, and the port's backbones use the zoo's module
names, so the mapping is the identity but for what the reference replaces:
``last_linear`` / ``fc`` / ``classifier`` entries are dropped (the
classifier head becomes the identity) and so are ``num_batches_tracked``
counters. ``check_state_dict`` holds a checkpoint to the backbone's keys and
shapes, as ``s2vt_tpu/extract/pipeline.py::_merge_check`` does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

_DROP_PREFIXES = ("last_linear", "fc", "classifier")
_LEAVES = ("weight", "bias", "running_mean", "running_var")


def params_from_torch_backbone(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A pretrainedmodels state_dict -> the port backbone's state_dict: the
    classifier head and the BN batch counters dropped, float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked" or parts[0] in _DROP_PREFIXES:
            continue
        if parts[-1] not in _LEAVES:
            raise KeyError(f"unrecognized backbone checkpoint key: {key!r}")
        out[key] = torch.as_tensor(val).detach().to("cpu", torch.float32)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth state_dict (or a pickled module) and convert it."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return params_from_torch_backbone(obj)


def check_state_dict(model: nn.Module, loaded: Mapping[str, torch.Tensor], name: str) -> None:
    """Raise unless ``loaded`` has exactly the backbone's keys and shapes."""
    want = model.state_dict()
    missing, extra = set(want) - set(loaded), set(loaded) - set(want)
    if missing or extra:
        raise ValueError(f"checkpoint does not match backbone {name!r}: "
                         f"missing={sorted(missing)[:8]} extra={sorted(extra)[:8]}")
    for key, val in loaded.items():
        if tuple(val.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(val.shape)} vs "
                             f"model {tuple(want[key].shape)}")
