"""Device mesh and the sharding layout for data- and vocab-parallel runs.

Counterpart of ``s2vt_tpu/parallel/mesh.py``, over ``torch.distributed``:

 - axis ``data``: the batch. Data rank r takes rows [r B/dp, (r + 1) B/dp)
   of every global batch of B rows; gradients are summed over the data
   group (the JAX package's XLA-inserted ``psum``).
 - axis ``model``: the vocabulary dimension of the embedding table, the
   output projection and its bias (``VOCAB_SHARDED``), the only weights
   that grow with the corpus. Model rank r holds rows [r V/tp, (r + 1) V/tp)
   of each. The collectives that XLA inserts from the shardings in JAX are
   the autograd functions of ``parallel/vocab.py`` here.

Everything else is replicated. A mesh is a ``DeviceMesh`` with
``mesh_dim_names=("data", "model")`` over the ranks of the default process
group (``parallel/distributed.py::initialize``), rank = d * tp + m.
AdamW's moments follow their parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from s2vt_tpu_torch.parallel.distributed import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Leaves sharded along the vocab on the model axis: (module, leaf) -> the
# vocab dimension.
VOCAB_SHARDED = {
    ("embedding", "weight"): 0,   # [V, E]
    ("out_linear", "weight"): 0,  # [V, H]
    ("out_linear", "bias"): 0,    # [V]
}


def make_mesh(shape: Optional[Sequence[int]] = None, device=None):
    """A (data, model) ``DeviceMesh`` over the default group's ranks; by
    default all of them on the data axis. ``device``: the ranks' device
    type (by default "cuda" under NCCL, else "cpu"). Raises
    ``ValueError`` when the world size is not the product of ``shape``, or
    when no process group is initialized."""
    from torch.distributed.device_mesh import DeviceMesh

    n_ranks = process_count()
    if shape is None:
        shape = (n_ranks, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape must be (data, model) with positive sizes, got {shape}")
    n = int(np.prod(shape))
    if n != n_ranks:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the process group has "
                         f"{n_ranks}; run under torch.distributed.run --nproc_per_node {n}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs an initialized process group: call "
                         "parallel.distributed.initialize() first")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_type = torch.device(device).type
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def vocab_dim(key: str) -> Optional[int]:
    """The vocab dimension of state_dict entry ``key`` (``embedding.weight``,
    ``out_linear.weight``, ``out_linear.bias``), None for a replicated leaf."""
    parts = key.split(".")
    return VOCAB_SHARDED.get((parts[-2], parts[-1])) if len(parts) >= 2 else None


def vocab_sharded(key: str, shape: Sequence[int], model_size: int) -> bool:
    """Whether the full leaf ``key`` of ``shape`` is split over a model axis
    of ``model_size``: a vocab leaf whose vocab the model size divides. Any
    other vocab stays replicated, as in JAX (pad it with
    ``Opt.vocab_pad_multiple`` to shard it)."""
    dim = vocab_dim(key)
    return model_size > 1 and dim is not None and shape[dim] % model_size == 0


def shard_rows(n: int, size: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of part ``index`` of ``size`` equal parts of ``n`` rows."""
    if n % size:
        raise ValueError(f"{n} rows do not split into {size} equal parts")
    step = n // size
    return index * step, (index + 1) * step


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole state_dict (parameters, or AdamW's
    moments keyed like them): each vocab leaf the model size divides, its
    rows of the model rank; every other leaf as it is. The counterpart of
    ``param_shardings`` / ``opt_state_shardings``."""
    tp, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    out = {}
    for key, t in state.items():
        if vocab_sharded(key, t.shape, tp):
            lo, hi = shard_rows(t.shape[vocab_dim(key)], tp, r)
            t = t.narrow(vocab_dim(key), lo, hi - lo).contiguous()
        out[key] = t
    return out


def gather_state_dict(state: Mapping[str, torch.Tensor], mesh,
                      vocab_size: int) -> Dict[str, torch.Tensor]:
    """The whole state_dict from every rank's part (``shard_state_dict``'s
    inverse): the vocab leaves of a ``vocab_size`` vocab that the model size
    divides are all-gathered over the model group. A collective: every rank
    of the mesh calls it."""
    tp = axis_size(mesh, MODEL_AXIS)
    out = dict(state)
    group = mesh.get_group(MODEL_AXIS) if tp > 1 else None
    for key, t in state.items():
        dim = vocab_dim(key)
        if dim is None or tp == 1 or vocab_size % tp:
            continue
        parts = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[key] = torch.cat(parts, dim=dim)
    return out


def batch_rows(batch_size: int, mesh, even: bool = True) -> Tuple[int, int]:
    """[lo, hi): the rows of a global batch that this data rank takes (the
    counterpart of ``batch_sharding`` / ``shard_batch_arrays``). Raises when
    the data axis does not divide the batch, unless ``even`` is False: then
    each rank takes ceil(B / dp) rows and the last ones fewer, or none (for
    work on independent rows, such as a decode)."""
    dp, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    if batch_size % dp == 0:
        return shard_rows(batch_size, dp, r)
    if even:
        raise ValueError(f"batch size {batch_size} is not divisible by the data axis {dp}")
    step = -(-batch_size // dp)
    lo = min(r * step, batch_size)
    return lo, min(lo + step, batch_size)


def device_put_chunked(x: np.ndarray, device, dtype: Optional[torch.dtype] = None,
                       chunk_bytes: int = 32 << 20) -> torch.Tensor:
    """A host array on ``device`` (cast to ``dtype``), copied in leading-dim
    chunks of about ``chunk_bytes`` into a tensor allocated there first, so
    that a multi-GB feature bank needs no second whole-size host copy for
    the cast; the values are those of one ``.to(device, dtype)``."""
    src = torch.from_numpy(x)
    dtype = src.dtype if dtype is None else dtype
    if x.nbytes <= chunk_bytes or x.ndim == 0 or x.shape[0] <= 1:
        return src.to(device, dtype)
    out = torch.empty(x.shape, dtype=dtype, device=device)
    rows = max(1, chunk_bytes // max(x.nbytes // x.shape[0], 1))
    for start in range(0, x.shape[0], rows):
        out[start:start + rows].copy_(src[start:start + rows])
    return out
