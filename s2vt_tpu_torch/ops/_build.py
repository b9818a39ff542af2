"""Build the port's CUDA sources into shared libraries, load them, and
launch their kernels.

Each ``s2vt_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the root of the
checkout, on first use, and loaded with ``ctypes``. The hash covers the
source, the shared device helpers of ``csrc/common.cuh`` and the flags, so
an edited source or header builds anew; a finished library is
reused by later processes. Each library exports a launch function with a
plain C interface (pointers, ints, the card's index and a stream) that
returns a ``cudaError_t``, and ``s2vt_cuda_error_string``. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Callable, Dict, List, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: Dict[str, str] = {}   # name -> nvcc's output (ptxas register and
#   shared-memory report), for the libraries this process built

OPS_NAMESPACE = "s2vt_tpu_torch"
_OPS = torch.library.Library(OPS_NAMESPACE, "DEF")   # the kernels' operators (define_op)


def define_op(name: str, schema: str, impl: Callable, fake: Callable):
    """Register ``s2vt_tpu_torch::<name>`` with ``schema`` (e.g. ``"(Tensor
    x, bool flag) -> Tensor"``): ``impl`` serves CPU and CUDA tensors (it
    dispatches on the device itself), ``fake`` gives the output shapes for
    tracing, so that ``torch.export`` holds the operator as one node. A
    plain ``torch.library.Library`` definition, not ``custom_op``: it costs
    a few microseconds per call where ``custom_op`` costs tens. Returns the
    operator."""
    _OPS.define(name + schema)
    for key in ("CPU", "CUDA"):
        _OPS.impl(name, impl, key)
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", fake, lib=_OPS)
    return getattr(getattr(torch.ops, OPS_NAMESPACE), name)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's default install, else PATH."""
    for cand in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> pathlib.Path:
    """The library's path: its hash covers the source, the shared headers
    (``csrc/*.cuh``, which every source may include) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """(library path, temporary output, nvcc process or None if built)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)


def build_all(names: Sequence[str]) -> List[pathlib.Path]:
    """Compile ``csrc/<name>.cu`` for each name whose library does not exist
    yet, one ``nvcc`` per source, all running at once."""
    started = [(name, *_start(name)) for name in names]
    try:
        for name, out, tmp, proc in started:
            if proc is None:
                continue
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
            build_logs[name] = stdout + stderr
            os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    finally:
        for _, _, tmp, proc in started:     # after a failure: stop the other compiles
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    return [out for _, out, _, _ in started]


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if it does not exist yet.
    Every source exports ``s2vt_cuda_error_string(int)``."""
    lib = ctypes.CDLL(str(build(name)))
    lib.s2vt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.s2vt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def smem_optin(device: torch.device) -> int:
    """The opt-in shared memory a block may use on card ``device``."""
    return _smem_optin(device.index if device.index is not None else torch.cuda.current_device())


def check_device(name: str, tensor) -> None:
    """Raise unless ``tensor`` lies on the CPU or a card: an operator's
    wrapper checks this before the dispatcher could send another device
    (meta, say) to the operator's shape-only implementation."""
    if tensor.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {tensor.device}")


def check_cuda(name: str, tensors) -> None:
    """Raise unless ``tensors`` are contiguous CUDA tensors: what a kernel
    wrapper checks before it loads or launches anything."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def launch(lib: ctypes.CDLL, entry: str, name: str, tensors, ints) -> None:
    """Call the C entry point ``entry`` of ``lib`` with the pointers of
    ``tensors`` (checked by ``check_cuda``), ``ints``, the card's index and
    PyTorch's current stream, and raise if it returns a CUDA error."""
    dev = tensors[0].device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints, index,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.s2vt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
