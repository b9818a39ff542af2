"""Checkpoint directories: ``opt.json`` + ``params.npz``.

Counterpart of ``s2vt_tpu/training/checkpoint.py`` for reading. A directory
holds the config snapshot ``opt.json`` and the parameters as ``params.npz``
in the ``//``-keyed flat layout of ``s2vt_tpu/serving/export.py``, so a JAX
serving artifact's ``params.npz`` next to its checkpoint's ``opt.json``
loads here without orbax or JAX. Orbax restore is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from s2vt_tpu_torch.utils.weights import load_params_npz, save_params_npz

PARAMS_FILE = "params.npz"
CONFIG_FILE = "opt.json"


def load_config(path: str) -> Optional[dict]:
    """The ``opt.json`` of a checkpoint directory as a dict, or None."""
    p = os.path.join(os.path.abspath(path), CONFIG_FILE)
    if not os.path.exists(p):
        return None
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def load_checkpoint(path: str) -> dict:
    """The parameter tree (nested dict of numpy arrays) of a checkpoint."""
    return load_params_npz(os.path.join(os.path.abspath(path), PARAMS_FILE))


def save_checkpoint(path: str, tree: dict, config_json: Optional[str] = None) -> str:
    """Write ``tree`` (and ``config_json``) as a checkpoint directory."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_params_npz(os.path.join(path, PARAMS_FILE), tree)
    if config_json is not None:
        with open(os.path.join(path, CONFIG_FILE), "w", encoding="utf-8") as f:
            f.write(config_json)
    return path
