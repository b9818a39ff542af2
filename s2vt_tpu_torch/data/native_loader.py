"""ctypes bindings for the native C++ prefetching feature-batch loader.

Counterpart of ``s2vt_tpu/data/native_loader.py``. ``native/s2vt_loader.cpp``
runs a C++ reader pool that assembles fixed-shape [B, T, D] float32 batches
into a bounded ring ahead of consumption. ``utils/native_build.py`` compiles
it on first use (to a temporary file that is then renamed into place, so
concurrent builds in several processes never load a half-written library)
and this module exposes it as an iterator. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from s2vt_tpu_torch.utils.native_build import build_native
    lib = ctypes.CDLL(str(build_native("s2vt_loader")))
    lib.s2vt_loader_create.restype = ctypes.c_void_p
    lib.s2vt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.s2vt_loader_begin.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    lib.s2vt_loader_next.restype = ctypes.c_int
    lib.s2vt_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.s2vt_loader_failed.restype = ctypes.c_long
    lib.s2vt_loader_failed.argtypes = [ctypes.c_void_p]
    lib.s2vt_loader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the loader's library builds and loads."""
    try:
        _load_lib()
        return True
    except Exception:
        return False


class NativeFeatureLoader:
    """Prefetching batch iterator over a fixed list of .npy feature files."""

    def __init__(self, paths: Sequence[str], feat_len: int, feat_dim: int,
                 n_threads: int = 4, queue_depth: int = 3):
        self._lib = _load_lib()
        self.paths = [str(p) for p in paths]
        self.feat_len, self.feat_dim = feat_len, feat_dim
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._handle = self._lib.s2vt_loader_create(
            arr, len(self.paths), feat_len, feat_dim, n_threads, queue_depth)
        if not self._handle:
            raise RuntimeError("s2vt_loader_create failed")
        # Epoch generation: each iter_batches() call supersedes the previous
        # one. The C++ begin() safely abandons an in-flight epoch, so an
        # abandoned Python generator (a consumer that broke mid-epoch) must
        # not poison the next epoch; it simply stops if ever resumed.
        self._epoch_gen = 0

    def iter_batches(self, order: Sequence[int], batch: int,
                     alloc: Optional[Callable[[], np.ndarray]] = None
                     ) -> Iterator[np.ndarray]:
        """Yield [batch, feat_len, feat_dim] float32 arrays following
        ``order`` (indices into ``paths``); the last batch is zero-padded.
        Each batch is written into a fresh array: ``alloc()``'s (a C-order
        float32 array of that shape, e.g. a view of pinned host memory), or
        a new numpy array. Raises ``RuntimeError`` when a file is missing,
        truncated, or not a little-endian float32 2-D .npy of width
        ``feat_dim``."""
        self._epoch_gen += 1
        gen = self._epoch_gen
        shape = (batch, self.feat_len, self.feat_dim)
        order_arr = np.ascontiguousarray(order, np.int32)
        # Snapshot BEFORE begin(): the pool starts loading immediately, so
        # reading the counter afterwards races the first failures.
        failed0 = self._lib.s2vt_loader_failed(self._handle)
        self._lib.s2vt_loader_begin(
            self._handle, order_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(order_arr), batch)
        while True:
            if self._epoch_gen != gen:
                return  # superseded by a newer epoch; don't steal its batches
            out = np.empty(shape, np.float32) if alloc is None else alloc()
            if (out.shape != shape or out.dtype != np.float32
                    or not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]):
                raise ValueError(f"alloc() gave {out.dtype} {out.shape}; want a writeable "
                                 f"C-order float32 {shape}")
            valid = self._lib.s2vt_loader_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            n_failed = self._lib.s2vt_loader_failed(self._handle) - failed0
            if n_failed:
                raise RuntimeError(f"{n_failed} feature file(s) failed to load "
                                   f"(missing, wrong dtype/shape, or truncated .npy)")
            if valid == 0:
                break
            yield out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.s2vt_loader_destroy(handle)
            self._handle = None
