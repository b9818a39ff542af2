"""Checkpoint directories: ``opt.json`` + ``params.npz`` (+ training state).

Counterpart of ``s2vt_tpu/training/checkpoint.py``. A directory holds the
config snapshot ``opt.json`` and the parameters as ``params.npz`` in the
``//``-keyed flat layout of ``s2vt_tpu/serving/export.py``, so a JAX serving
artifact's ``params.npz`` next to its checkpoint's ``opt.json`` loads here
without orbax or JAX. A training checkpoint (``save_training_state``) adds
the optimizer's moments and step (``optimizer.npz``, the same layout) and the
learning rate, callback state and epoch count (``trainer.json``). Saves are
blocking and land whole: the directory is written under a temporary name and
renamed. Orbax checkpoints are not read or written.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

from s2vt_tpu_torch.utils.weights import load_params_npz, save_params_npz

PARAMS_FILE = "params.npz"
CONFIG_FILE = "opt.json"
OPTIM_FILE = "optimizer.npz"
STATE_FILE = "trainer.json"


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


def save_training_state(path: str, params: dict, optim: dict, state: dict,
                        config_json: Optional[str] = None) -> str:
    """Write a training checkpoint: ``params`` and ``optim`` (nested dicts of
    arrays), ``state`` (JSON-able) and the config. An existing directory at
    ``path`` is replaced once the new one is complete."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    save_checkpoint(tmp, params, config_json)
    save_params_npz(os.path.join(tmp, OPTIM_FILE), optim)
    with open(os.path.join(tmp, STATE_FILE), "w", encoding="utf-8") as f:
        json.dump(state, f)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return path


def load_training_state(path: str) -> Tuple[dict, dict, dict]:
    """(params, optim, state) of a checkpoint written by ``save_training_state``."""
    path = os.path.abspath(path)
    with open(os.path.join(path, STATE_FILE), encoding="utf-8") as f:
        state = json.load(f)
    return (load_checkpoint(path), load_params_npz(os.path.join(path, OPTIM_FILE)), state)
