"""Weight bridge between the JAX parameter tree and the port's state_dict.

Counterpart of ``s2vt_tpu/utils/torch_import.py`` and of
``_flatten_params`` / ``_unflatten_params`` in ``s2vt_tpu/serving/export.py``.
Both packages keep every weight in torch layout ([out, in] linears,
[gates*H, .] RNNs), and the port's module tree mirrors the JAX one, so the
bridge is a renaming of keys: JAX ``vid_rnn/l0/w_ih`` is the port's
``vid_rnn.l0.w_ih``. No value is transposed or cast, so a round trip is
exact.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_SEP = "//"   # params.npz key separator (s2vt_tpu/serving/export.py)


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a//b//c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_params_npz(path: str, tree: Mapping) -> None:
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dict of arrays, without the outer
    ``params`` collection) -> the port's state_dict."""
    return {key.replace(_SEP, "."): torch.from_numpy(np.array(val))
            for key, val in flatten_params(tree).items()}


def params_to_jax(module_or_state_dict) -> dict:
    """The port's module (or state_dict) -> JAX parameter tree of numpy arrays."""
    sd = (module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    return unflatten_params({key.replace(".", _SEP): val.detach().cpu().numpy()
                             for key, val in sd.items()})


_RNN_KEY = re.compile(
    r"^(?P<mod>\w+)\.(?P<kind>weight|bias)_(?P<gate>ih|hh)_l(?P<layer>\d+)(?P<rev>_reverse)?$")
_LIN_KEY = re.compile(r"^(?P<mod>\w+)\.(?P<kind>weight|bias)$")


def params_from_reference_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference-model state_dict (``nn.LSTM`` / ``nn.Linear`` /
    ``nn.Embedding`` keys such as ``vid_rnn.weight_ih_l0``) -> the port's
    state_dict (``vid_rnn.l0.w_ih``)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        val = torch.as_tensor(val).detach().cpu().clone()
        m = _RNN_KEY.match(key)
        if m:
            layer = f"l{m.group('layer')}" + ("_reverse" if m.group("rev") else "")
            leaf = ("w_" if m.group("kind") == "weight" else "b_") + m.group("gate")
            out[f"{m.group('mod')}.{layer}.{leaf}"] = val
            continue
        if _LIN_KEY.match(key):
            out[key] = val
            continue
        raise KeyError(f"unrecognized reference checkpoint key: {key!r}")
    return out
