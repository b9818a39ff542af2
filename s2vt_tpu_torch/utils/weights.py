"""Weight bridge between the JAX parameter tree and the port's state_dict.

Counterpart of ``s2vt_tpu/utils/torch_import.py`` and of
``_flatten_params`` / ``_unflatten_params`` in ``s2vt_tpu/serving/export.py``.
Both packages keep every captioner weight in torch layout ([out, in]
linears, [gates*H, .] RNNs), and the port's module tree mirrors the JAX one,
so the bridge is a renaming of keys: JAX ``vid_rnn/l0/w_ih`` is the port's
``vid_rnn.l0.w_ih``. No value is transposed or cast, so a round trip is
exact.

The extraction backbones differ (``backbone_params_from_jax``): the JAX
trees hold convolutions as HWIO ``kernel``s and BatchNorm as
``scale/bias/mean/var``, and merge numeric path parts into their parent
(``features_4/branch0_0/conv``), as ``s2vt_tpu/extract/torch_weights.py``
builds them from a pretrainedmodels state_dict; the carry undoes each step.
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


_JAX_LEAF = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def _jax_backbone_key(key: str, ndim: int) -> str:
    """The JAX tree path of a port backbone entry (``s2vt_tpu/extract/
    torch_weights.py``'s rule): numeric parts merge into their parent with
    ``_``; a 4-D weight is a ``kernel``, a 1-D one a BN ``scale``."""
    *parts, leaf = key.split(".")
    path = []
    for p in parts:
        if p.isdigit() and path:
            path[-1] = f"{path[-1]}_{p}"
        else:
            path.append(p)
    if leaf == "weight":
        leaf = {4: "kernel", 1: "scale"}.get(ndim, "weight")
    else:
        leaf = _JAX_LEAF[leaf]
    return _SEP.join([*path, leaf])


def backbone_params_from_jax(tree: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX backbone param tree (``s2vt_tpu/extract/backbones.py``, nested
    dict of arrays) -> the state_dict of the port's backbone ``module``: HWIO
    kernels become OIHW conv weights, ``scale/bias/mean/var`` BN
    ``weight/bias/running_mean/running_var``, linears stay as they are. The
    module's own keys resolve the ``_`` merges, which are ambiguous
    (InceptionV4's ``branch1_0`` is an attribute where ``branch0_0`` is
    ``branch0.0``). Raises unless the tree holds exactly the module's
    entries."""
    flat = flatten_params(tree)
    out: Dict[str, torch.Tensor] = {}
    for key, ref in module.state_dict().items():
        jkey = _jax_backbone_key(key, ref.dim())
        if jkey not in flat:
            raise KeyError(f"the JAX tree has no {jkey!r} for {key!r}")
        val = np.array(flat.pop(jkey), dtype=np.float32)
        if ref.dim() == 4:
            val = val.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(val))
    if flat:
        raise KeyError(f"JAX entries without a port counterpart: {sorted(flat)[:8]}")
    return out
