"""Checkpoint directories: ``opt.json`` + ``params.npz`` (+ training state).

Counterpart of ``s2vt_tpu/training/checkpoint.py``. A directory holds the
config snapshot ``opt.json`` and the parameters as ``params.npz`` in the
``//``-keyed flat layout of ``s2vt_tpu/serving/export.py``, so a JAX serving
artifact's ``params.npz`` next to its checkpoint's ``opt.json`` loads here
without orbax or JAX. A training checkpoint (``save_training_state``) adds
the optimizer's moments and step (``optimizer.npz``, the same layout) and the
learning rate, callback state and epoch count (``trainer.json``). Orbax
checkpoints are not read or written.

A directory lands whole: it is written under a temporary name and renamed.
``save_training_state(..., blocking=False)`` returns at once and writes on a
thread of its own (the JAX package's async checkpoints): the trees it is
given must be a snapshot that nothing changes later (the Trainer passes
device clones), their device-to-host copies run on a stream of the thread's
own once the work queued before the call is done, and at most one such save
is in flight. ``wait_for_saves`` blocks until every save has landed and
raises if a write failed; every later save, ``load_training_state`` and
``load_config`` call it first, so a failure is never lost.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Callable, List, Mapping, Optional, Tuple

import torch

from s2vt_tpu_torch.utils.weights import load_params_npz, save_params_npz

PARAMS_FILE = "params.npz"
CONFIG_FILE = "opt.json"
OPTIM_FILE = "optimizer.npz"
STATE_FILE = "trainer.json"


class _AsyncSave(threading.Thread):
    """One background write; keeps the exception it ends with."""

    def __init__(self, path: str, write: Callable[[], None]):
        super().__init__(name=f"checkpoint {path}")
        self.path, self._write, self.error = path, write, None

    def run(self) -> None:
        try:
            self._write()
        except Exception as e:              # surfaced by wait_for_saves
            self.error = e


_pending: List[_AsyncSave] = []


def wait_for_saves() -> None:
    """Block until every async save has landed; raise ``RuntimeError`` from
    the first that failed."""
    failed = None
    while _pending:
        save = _pending.pop(0)
        save.join()
        if save.error is not None and failed is None:
            failed = save
    if failed is not None:
        raise RuntimeError(f"the async checkpoint write to {failed.path} failed: "
                           f"{failed.error!r}") from failed.error


def _to_host(tree: Mapping) -> dict:
    """A nested dict whose torch tensors become numpy arrays."""
    return {k: _to_host(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _cuda_device(tree: Mapping) -> Optional[torch.device]:
    """The device of the tree's first CUDA tensor, or None."""
    for v in tree.values():
        dev = (_cuda_device(v) if isinstance(v, Mapping)
               else v.device if isinstance(v, torch.Tensor) and v.is_cuda else None)
        if dev is not None:
            return dev
    return None


def load_config(path: str) -> Optional[dict]:
    """The ``opt.json`` of a checkpoint directory as a dict, or None."""
    wait_for_saves()
    p = os.path.join(os.path.abspath(path), CONFIG_FILE)
    if not os.path.exists(p):
        return None
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def load_checkpoint(path: str) -> dict:
    """The parameter tree (nested dict of numpy arrays) of a checkpoint."""
    wait_for_saves()
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


def _write_training_state(path: str, params: dict, optim: dict, state: dict,
                          config_json: Optional[str]) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    save_checkpoint(tmp, _to_host(params), config_json)
    save_params_npz(os.path.join(tmp, OPTIM_FILE), _to_host(optim))
    with open(os.path.join(tmp, STATE_FILE), "w", encoding="utf-8") as f:
        json.dump(state, f)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)


def save_training_state(path: str, params: dict, optim: dict, state: dict,
                        config_json: Optional[str] = None, blocking: bool = True) -> str:
    """Write a training checkpoint: ``params`` and ``optim`` (nested dicts of
    numpy arrays or torch tensors), ``state`` (JSON-able) and the config. An
    existing directory at ``path`` is replaced once the new one is complete.
    Waits for the saves in flight first (raising if one failed); with
    ``blocking=False`` the write then runs on a thread of its own (module
    docstring) and this returns at once. Returns the absolute path."""
    path = os.path.abspath(path)
    wait_for_saves()
    if blocking:
        _write_training_state(path, params, optim, state, config_json)
        return path
    # The snapshot is taken by work already queued on the caller's stream:
    # the writer's copies wait for it on a stream of their own, off the
    # caller's.
    dev = _cuda_device(params) or _cuda_device(optim)
    ready = torch.cuda.current_stream(dev).record_event() if dev is not None else None

    def write():
        if ready is None:
            _write_training_state(path, params, optim, state, config_json)
            return
        stream = torch.cuda.Stream(dev)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            _write_training_state(path, params, optim, state, config_json)

    save = _AsyncSave(path, write)
    _pending.append(save)
    save.start()
    return path


def load_training_state(path: str) -> Tuple[dict, dict, dict]:
    """(params, optim, state) of a checkpoint written by ``save_training_state``
    (after the saves in flight have landed)."""
    wait_for_saves()
    path = os.path.abspath(path)
    with open(os.path.join(path, STATE_FILE), encoding="utf-8") as f:
        state = json.load(f)
    return (load_checkpoint(path), load_params_npz(os.path.join(path, OPTIM_FILE)), state)
