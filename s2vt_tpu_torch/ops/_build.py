"""Build the port's CUDA sources into shared libraries and load them.

Each ``s2vt_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the root of the
checkout, on first use, and loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source builds anew; a finished library is
reused by later processes. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: Dict[str, str] = {}   # name -> nvcc's output (ptxas register and
#   shared-memory report), for the libraries this process built


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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if it does not exist yet."""
    return ctypes.CDLL(str(build(name)))
