"""Host-side video decoding: ffmpeg -> in-memory RGB frame arrays.

A copy of ``s2vt_tpu/extract/video.py``, which imports no JAX (the port keeps
its own copy). The reference dumps JPEGs to a temp dir and re-reads them with
PIL (its extract_features.py:27-35,63-71). Here ffmpeg pipes raw RGB straight
into memory, scaled to the same 400x300 the reference uses. A frame-directory
reader provides the same interface for pre-extracted frames and for machines
without ffmpeg.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

FRAME_W, FRAME_H = 400, 300  # reference's scale=400:300 (extract_features.py:31)


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def decode_video(video_path: str, width: int = FRAME_W,
                 height: int = FRAME_H) -> np.ndarray:
    """Decode all frames of a video to uint8 [N, height, width, 3] via an
    ffmpeg rawvideo pipe."""
    if not have_ffmpeg():
        raise RuntimeError(
            "ffmpeg not found; decode videos elsewhere or pass a directory "
            "of frame images instead (read_frame_dir)")
    cmd = ["ffmpeg", "-v", "error", "-i", str(video_path),
           "-vf", f"scale={width}:{height}",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, check=True)
    buf = np.frombuffer(proc.stdout, np.uint8)
    frame_size = width * height * 3
    n = len(buf) // frame_size
    if n == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    return buf[:n * frame_size].reshape(n, height, width, 3)


def read_frame_dir(frame_dir: str, pattern: str = "*.jpg",
                   size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Read sorted frame images from a directory (the reference's
    '%06d.jpg' layout) to uint8 [N, H, W, 3]."""
    from PIL import Image

    paths = sorted(pathlib.Path(frame_dir).glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} frames under {frame_dir}")
    frames = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if size is not None:
            img = img.resize(size, Image.BILINEAR)
        frames.append(np.asarray(img, np.uint8))
    return np.stack(frames)


VIDEO_SUFFIXES = {".avi", ".mp4", ".mkv", ".webm", ".mov", ".mpg", ".mpeg",
                  ".wmv", ".flv", ".m4v", ".3gp"}


def load_clip(path: str) -> np.ndarray:
    """Video file -> decoded frames; directory -> frame images."""
    p = pathlib.Path(path)
    if p.is_dir():
        return read_frame_dir(str(p))
    return decode_video(str(p))
