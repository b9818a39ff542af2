"""What the variant tools share: a kernel source in one file, edited by exact
text, and its variants compiled side by side.

A variant tool builds ``csrc/<name>.cu`` as it is and with one design choice
changed at a time, then checks and times each build on the card
(``conv_mma_variants``, ``argmax_mma_variants``).
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
from typing import Dict, Tuple

from s2vt_tpu_torch.ops import _build


def source_with_headers(name: str) -> str:
    """``csrc/<name>.cu`` with each ``#include "<header>.cuh"`` of a shared
    header replaced by the header's text: one file that builds anywhere and
    holds every line a variant may change."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for header in sorted(_build.CSRC.glob("*.cuh")):
        src = src.replace(f'#include "{header.name}"', header.read_text())
    return src


def replace_once(text: str, *pairs) -> str:
    """``text`` with each (old, new) pair replaced; each old text must occur
    exactly once, so that a variant changes what it names or fails."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(sources: Dict[str, str], out_dir: pathlib.Path) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """{name: (loaded library, nvcc's report)} for {name: source}: each
    source compiled into ``out_dir/<name>.so``, one nvcc per variant, all
    started together. The caller sets its entry points' signatures."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.s2vt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.s2vt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, out)
    return libs


def sass_sizes(library: pathlib.Path) -> str:
    """Machine instructions of each mma-route kernel of ``library``, by
    cuobjdump (beside nvcc)."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    sizes, fn = {}, None
    for line in sass.splitlines():
        if (m := re.search(r"Function : (\S+)", line)):
            fn = _build.kernel_symbol_name(m.group(1))
            sizes[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[fn] += 1
    return ", ".join(f"{k} {v}" for k, v in sizes.items() if "_mma" in k)
