"""Build the port's host-side C++ sources (``s2vt_tpu_torch/native/*.cpp``)
into shared libraries for ``ctypes``.

``build_native(name)`` compiles ``native/<name>.cpp`` with ``g++ -O3
-std=c++17 -shared -fPIC -pthread`` (the feature loader runs a
``std::thread`` pool) into ``build/native/lib<name>-<hash>.so`` at the
root of the checkout, on first use. The hash covers the source and the
flags, so an edited source builds anew and a finished library is reused by
later processes. The compiler writes a temporary file of its own, which is
then renamed into place (``os.replace``), so a process that builds the same
library at the same time, or loads it, never sees a half-written file. A
failed build raises with g++'s output; nothing falls back. Nothing here runs
at import time.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path(name: str) -> pathlib.Path:
    """Where ``native/<name>.cpp``'s library lives: named by the hash of the
    source and the flags."""
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_native(name: str) -> pathlib.Path:
    """Compile ``native/<name>.cpp`` unless its library exists; returns the
    library's path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
