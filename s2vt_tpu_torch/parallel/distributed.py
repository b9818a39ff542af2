"""Multi-process runtime: the process group and each process's rows.

Counterpart of ``s2vt_tpu/parallel/distributed.py`` over
``torch.distributed``. Each process calls :func:`initialize` once (under
``python -m torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, or with the arguments), builds the
mesh (``parallel/mesh.py::make_mesh``) and takes its rows of each global
batch. NCCL on the card (one card per process, ``LOCAL_RANK``'s), gloo
across CPU processes; a failed NCCL initialisation raises, with no gloo
fallback.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from s2vt_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = 600.0) -> None:
    """Initialize the default process group. ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` default to
    torchrun's ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    ``device``: "cuda" (the default: NCCL, each process on card
    ``LOCAL_RANK``; without a card it raises, through
    ``utils/device.py::resolve_device``) or "cpu" (gloo, asked for).

    As JAX's: a second call does nothing; a single process with no
    coordinator does nothing; an explicit multi-process configuration that
    fails raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address")
        return                                   # one process, no coordinator: nothing to do
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    device = resolve_device(device)
    card = None
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        card = torch.device("cuda", local)
    dist.init_process_group("nccl" if card is not None else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), device_id=card)


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The default process group's size, 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group, 0 where there is none."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_size(global_batch: int) -> int:
    """The rows of a global batch that each process takes; raises when the
    process count does not divide it."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def host_local_batch(*arrays):
    """This process's rows of each global array: rows [p n/P, (p + 1) n/P)
    for process p of P. The counterpart of JAX's
    ``host_local_batch_to_global``, read the other way: there each host
    hands in its rows and gets a global array; here every process computes
    on its own rows, and the collectives (gradients over the data group)
    make the global result."""
    p = process_index()
    out = []
    for a in arrays:
        lb = local_batch_size(len(a))
        out.append(a[p * lb:(p + 1) * lb])
    return tuple(out)
