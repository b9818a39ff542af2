"""RLE mask API, pycocotools.mask-compatible, backed by C++.

Counterpart of ``s2vt_tpu/utils/mask.py``, over the port's own copy of the
C++ source (``s2vt_tpu_torch/native/s2vt_mask.cpp``), which
``utils/native_build.py`` compiles on first use and this module loads
through ctypes, under a lock. Nothing builds at import time, and a failed
build raises with g++'s output: there is no Python fallback. Host-side
numpy and C++; no device work.

    encode(mask) / decode(rle) / area(rle) / merge(rles, intersect)
    iou(dt, gt, iscrowd) / bbox_iou(dt, gt, iscrowd) / toBbox(rle)
    frBbox(bbox, h, w) / toString(rle) / frString(s, h, w)
    frUncompressedRLE(rle) / frPyObjects(obj, h, w) / frPoly(polys, h, w)

RLE objects are dicts {'size': [h, w], 'counts': np.uint32 array}, the
uncompressed form of the COCO convention (column-major, starts with a
zero-run).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence

import numpy as np

_LOCK = threading.Lock()
_LIB = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_DP = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rle_encode": (ctypes.c_long, [_U8P, ctypes.c_long, ctypes.c_long, _U32P, ctypes.c_long]),
    "rle_decode": (ctypes.c_int, [_U32P, ctypes.c_long, ctypes.c_long, ctypes.c_long, _U8P]),
    "rle_area": (ctypes.c_long, [_U32P, ctypes.c_long]),
    "rle_merge": (ctypes.c_long, [_U32P, ctypes.c_long, _U32P, ctypes.c_long, ctypes.c_int,
                                  _U32P, ctypes.c_long]),
    "rle_iou": (ctypes.c_double, [_U32P, ctypes.c_long, _U32P, ctypes.c_long, ctypes.c_int]),
    "rle_to_bbox": (None, [_U32P, ctypes.c_long, ctypes.c_long, ctypes.c_long, _DP]),
    "bb_iou": (ctypes.c_double, [_DP, _DP, ctypes.c_int]),
    "rle_to_string": (ctypes.c_long, [_U32P, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]),
    "rle_from_string": (ctypes.c_long, [ctypes.c_char_p, ctypes.c_long, _U32P, ctypes.c_long]),
    "poly_to_mask": (None, [_DP, ctypes.c_long, ctypes.c_long, ctypes.c_long, _U8P]),
}


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            from s2vt_tpu_torch.utils.native_build import build_native
            lib = ctypes.CDLL(str(build_native("s2vt_mask")))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint32)


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def encode(mask: np.ndarray) -> Dict:
    """Binary mask [h, w] -> RLE (column-major runs)."""
    h, w = mask.shape
    flat = np.ascontiguousarray(mask.T.reshape(-1), np.uint8)  # col-major
    out = np.zeros(h * w + 2, np.uint32)
    n = _load().rle_encode(_ptr(flat, ctypes.c_uint8), h, w, _ptr(out, ctypes.c_uint32),
                           len(out))
    if n <= 0:
        raise RuntimeError("rle_encode overflowed its buffer")
    return {"size": [h, w], "counts": out[:n].copy()}


def decode(rle: Dict) -> np.ndarray:
    """RLE -> binary mask [h, w] (uint8)."""
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    out = np.zeros(h * w, np.uint8)
    rc = _load().rle_decode(_ptr(counts, ctypes.c_uint32), len(counts), h, w,
                            _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError("invalid RLE")
    return out.reshape(w, h).T  # back to row-major [h, w]


def area(rle: Dict) -> int:
    counts = _u32(rle["counts"])
    return int(_load().rle_area(_ptr(counts, ctypes.c_uint32), len(counts)))


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    """Union (or intersection) of RLEs of one size."""
    if not rles:
        raise ValueError("merge of zero masks")
    acc = _u32(rles[0]["counts"])
    size = rles[0]["size"]
    lib = _load()
    for r in rles[1:]:
        b = _u32(r["counts"])
        out = np.zeros(len(acc) + len(b) + 2, np.uint32)
        n = lib.rle_merge(_ptr(acc, ctypes.c_uint32), len(acc), _ptr(b, ctypes.c_uint32),
                          len(b), 1 if intersect else 0, _ptr(out, ctypes.c_uint32), len(out))
        if n <= 0:
            raise RuntimeError("rle_merge overflowed its buffer")
        acc = out[:n].copy()
    return {"size": size, "counts": acc}


def _crowd(iscrowd: Sequence[int], j: int) -> int:
    return int(iscrowd[j]) if j < len(iscrowd) else 0


def iou(dt: List[Dict], gt: List[Dict], iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise IoU matrix [len(dt), len(gt)] (RLE form); a crowd gt divides
    by the detection's area."""
    lib = _load()
    out = np.zeros((len(dt), len(gt)))
    gcs = [_u32(g["counts"]) for g in gt]
    for i, d in enumerate(dt):
        dc = _u32(d["counts"])
        for j, gc in enumerate(gcs):
            out[i, j] = lib.rle_iou(_ptr(dc, ctypes.c_uint32), len(dc),
                                    _ptr(gc, ctypes.c_uint32), len(gc), _crowd(iscrowd, j))
    return out


def bbox_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise IoU of [x, y, w, h] boxes."""
    lib = _load()
    dt = np.ascontiguousarray(dt, np.float64)
    gt = np.ascontiguousarray(gt, np.float64)
    out = np.zeros((len(dt), len(gt)))
    for i in range(len(dt)):
        for j in range(len(gt)):
            out[i, j] = lib.bb_iou(_ptr(dt[i], ctypes.c_double), _ptr(gt[j], ctypes.c_double),
                                   _crowd(iscrowd, j))
    return out


def toBbox(rle: Dict) -> np.ndarray:
    """Tight [x, y, w, h] box of an RLE (zeros for an empty mask)."""
    counts = _u32(rle["counts"])
    out = np.zeros(4, np.float64)
    _load().rle_to_bbox(_ptr(counts, ctypes.c_uint32), len(counts), rle["size"][0],
                        rle["size"][1], _ptr(out, ctypes.c_double))
    return out


def frBbox(bbox: Sequence[float], h: int, w: int) -> Dict:
    """[x, y, w, h] -> RLE of the filled box, clipped to the image; each
    coordinate rounds half to even (Python's ``round``)."""
    x, y, bw, bh = (int(round(v)) for v in bbox)
    mask = np.zeros((h, w), np.uint8)
    mask[max(y, 0):min(y + bh, h), max(x, 0):min(x + bw, w)] = 1
    return encode(mask)


def toString(rle: Dict) -> bytes:
    """Counts -> COCO compressed RLE string (pycocotools rleToString:
    LEB128 base-48 with delta coding from the second-previous count)."""
    counts = _u32(rle["counts"])
    # worst case 7 base-48 chars per count (a 33-bit signed delta, 5 bits a char)
    buf = ctypes.create_string_buffer(7 * max(len(counts), 1) + 8)
    n = _load().rle_to_string(_ptr(counts, ctypes.c_uint32), len(counts), buf, len(buf))
    if n < 0:
        raise ValueError("RLE string encoding overflow")
    return buf.raw[:n]


def frString(s: bytes, h: int, w: int) -> Dict:
    """COCO compressed RLE string -> counts RLE."""
    out = np.zeros(max(len(s), 1) + 2, np.uint32)
    n = _load().rle_from_string(s, len(s), _ptr(out, ctypes.c_uint32), len(out))
    if n < 0:
        raise ValueError("invalid RLE string")
    return {"size": [h, w], "counts": out[:n].copy()}


def frUncompressedRLE(rle: Dict) -> Dict:
    """COCO 'uncompressed RLE' ({'counts': list, 'size': [h, w]}) -> the
    counts-array RLE used by this module."""
    h, w = rle["size"]
    return {"size": [h, w], "counts": _u32(rle["counts"])}


def frPyObjects(pyobj, h: int, w: int):
    """pycocotools.mask.frPyObjects dispatcher: polygons (list of float
    lists), an [N, 4] bbox array, a single polygon or box, or an
    uncompressed-RLE dict (or a list of them) -> RLE(s). Lists map
    elementwise."""
    if isinstance(pyobj, np.ndarray) and pyobj.ndim == 2:
        return [frBbox(b, h, w) for b in pyobj]
    if isinstance(pyobj, dict) and "counts" in pyobj:
        return frUncompressedRLE(pyobj)
    if isinstance(pyobj, (list, tuple)):
        if len(pyobj) == 0:
            return []
        first = pyobj[0]
        if isinstance(first, dict):
            return [frUncompressedRLE(o) for o in pyobj]
        if isinstance(first, (list, tuple, np.ndarray)):
            out = []
            for o in pyobj:
                o = np.asarray(o, np.float64).reshape(-1)
                out.append(frBbox(o, h, w) if o.size == 4 else frPoly([o], h, w))
            return out
        arr = np.asarray(pyobj, np.float64).reshape(-1)
        return frBbox(arr, h, w) if arr.size == 4 else frPoly([arr], h, w)
    raise TypeError(f"unsupported segmentation object {type(pyobj)!r}")


def frPoly(polys: Sequence[Sequence[float]], h: int, w: int) -> Dict:
    """Polygon(s) [x0,y0,x1,y1,...] -> RLE (union of filled polygons,
    even-odd scanline rasterization); no polygon gives the empty mask."""
    if not polys:
        return {"size": [h, w], "counts": np.asarray([h * w], np.uint32)}
    lib = _load()
    rles = []
    for poly in polys:
        xy = np.ascontiguousarray(poly, np.float64)
        if xy.size % 2 or xy.size < 6:
            raise ValueError(f"a polygon needs at least 3 (x, y) points, got {xy.size} values")
        out = np.zeros(h * w, np.uint8)
        lib.poly_to_mask(_ptr(xy, ctypes.c_double), xy.size // 2, h, w,
                         _ptr(out, ctypes.c_uint8))
        rles.append(encode(out.reshape(h, w)))
    return merge(rles) if len(rles) > 1 else rles[0]
