"""Feature-extraction pipeline: videos -> per-clip [T, feat_dim] .npy files.

Counterpart of ``s2vt_tpu/extract/pipeline.py`` (the reference's
extract_features.py:113-143):

 - the backbone is built once and streamed over the clips (the reference
   reloads the CNN for every video),
 - frames go ffmpeg (or a frame directory) -> host memory -> one
   preprocess + forward per clip on the device; only the sampled frames are
   uploaded,
 - 'free' mode pads the sampled frame count to a bucket multiple, so a run
   sees a handful of batch shapes, not one per video,
 - 'fix'-mode clips of one raw frame size are forwarded ``clip_batch`` at a
   time, and the decode of the next group runs on a worker thread while the
   device forwards the current one.

With ``use_pallas`` (the default) VGG16's conv blocks run the fused conv
kernel (``ops/fused_conv.py``). With a mesh (``parallel/mesh.py``) extraction
is data-parallel, as JAX's: each data rank forwards its share of the frames
and the features are all-gathered in order, on every rank; ``extract``
writes the files from rank 0.
"""

from __future__ import annotations

import pathlib
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from s2vt_tpu_torch.extract import video as video_lib
from s2vt_tpu_torch.extract.backbones import build_backbone
from s2vt_tpu_torch.extract.preprocess import (fix_sample_indices, free_sample_indices,
                                               preprocess_frames)
from s2vt_tpu_torch.parallel import mesh as mesh_lib
from s2vt_tpu_torch.parallel.distributed import process_index
from s2vt_tpu_torch.utils.device import resolve_device

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


class FeatureExtractor:
    """The backbone, built once on ``device`` (default: the CUDA card), and
    the frames -> features function. ``mesh``: a (data, model) ``DeviceMesh``
    over which the frames are split (the frame count must divide by the
    data axis); the backbone is replicated."""

    def __init__(self, model_name: str = "vgg16", weights: Optional[str] = None,
                 compute_dtype: Optional[str] = None, bucket: int = 16, mesh=None,
                 use_pallas: bool = True, device=None):
        self.mesh = mesh
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be None, 'float32' or 'bfloat16', got "
                             f"{compute_dtype!r}")
        self.model_name = model_name
        self.device = resolve_device(device)
        self.model, self.spec = build_backbone(model_name, _DTYPES[compute_dtype], use_pallas)
        if weights is not None:
            from s2vt_tpu_torch.extract.torch_weights import (check_state_dict,
                                                              load_torch_checkpoint)
            loaded = load_torch_checkpoint(weights)
            check_state_dict(self.model, loaded, model_name)
            self.model.load_state_dict(loaded)
        self.model = self.model.to(self.device).eval()
        self.bucket = bucket

    @torch.no_grad()
    def _features(self, frames: torch.Tensor) -> torch.Tensor:
        x = preprocess_frames(frames, self.spec["mean"], self.spec["std"],
                              self.spec["input_size"])
        return self.model(x)

    def _gathered(self, feats: torch.Tensor) -> torch.Tensor:
        """The data ranks' features in rank order (``feats`` without a mesh)."""
        if self.mesh is None:
            return feats
        parts = [torch.empty_like(feats)
                 for _ in range(mesh_lib.axis_size(self.mesh, mesh_lib.DATA_AXIS))]
        dist.all_gather(parts, feats.contiguous(),
                        group=self.mesh.get_group(mesh_lib.DATA_AXIS))
        return torch.cat(parts)

    def _rows(self, n: int) -> slice:
        """This data rank's frames of ``n``."""
        return slice(0, n) if self.mesh is None else slice(*mesh_lib.batch_rows(n, self.mesh))

    @torch.no_grad()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames [T, H, W, 3] on the device -> features [T, feat_dim].
        With a mesh, this data rank forwards its frames and the ranks'
        features are gathered in order."""
        return self._gathered(self._features(frames[self._rows(frames.shape[0])]))

    def __call__(self, frames: np.ndarray, valid_count: Optional[int] = None) -> np.ndarray:
        """uint8 frames [T, H, W, 3] -> features [T, feat_dim] float32 (or
        [valid_count, feat_dim] when the batch was padded). With a mesh only
        this rank's frames are uploaded."""
        local = np.ascontiguousarray(frames[self._rows(len(frames))])
        feats = self._gathered(self._features(torch.from_numpy(local).to(self.device)))
        feats = feats.float().cpu().numpy()
        return feats if valid_count is None else feats[:valid_count]

    def extract_clip(self, clip_path: str, mode: str = "fix", frames_num: int = 80,
                     interval: int = 10) -> np.ndarray:
        frames = video_lib.load_clip(clip_path)
        if mode == "fix":
            return self(frames[fix_sample_indices(len(frames), frames_num)])
        if mode == "free":
            sampled = frames[free_sample_indices(len(frames), interval)]
            n = len(sampled)
            padded_n = -(-n // self.bucket) * self.bucket
            if padded_n != n:
                pad = np.zeros((padded_n - n,) + sampled.shape[1:], np.uint8)
                sampled = np.concatenate([sampled, pad])
            return self(sampled, valid_count=n)
        raise ValueError(f"unknown mode {mode!r} (expected 'fix' or 'free')")


def extract(video_path: str, feats_path: str, model: str = "vgg16", mode: str = "fix",
            frames_num: int = 80, interval: int = 10, weights: Optional[str] = None,
            compute_dtype: Optional[str] = None, overwrite: bool = True,
            clips: Optional[Iterable[pathlib.Path]] = None, clip_batch: int = 4,
            device=None, mesh=None) -> int:
    """Extract features for every clip under ``video_path``; returns the
    count. Each clip's features go to ``{feats_path}/{clip_stem}.npy``
    ([T, feat_dim]), as the reference's CLI writes them. With ``mesh`` every
    rank calls it, the frames of each forward are split over the data
    ranks, and rank 0 writes the files."""
    feats_dir = pathlib.Path(feats_path)
    writes = process_index() == 0
    if overwrite and feats_dir.is_dir() and writes:
        import shutil
        shutil.rmtree(feats_dir)
    if writes:
        feats_dir.mkdir(parents=True, exist_ok=True)

    def save(clip, feats):
        if writes:
            np.save(feats_dir / f"{clip.stem}.npy", feats)

    src = pathlib.Path(video_path)
    if clips is None:
        clips = sorted(p for p in src.iterdir()
                       if p.is_dir() or p.suffix.lower() in video_lib.VIDEO_SUFFIXES)
    clips = list(clips)
    extractor = FeatureExtractor(model, weights, compute_dtype, device=device, mesh=mesh)

    if mode != "fix" or clip_batch <= 1:
        for clip in clips:
            save(clip, extractor.extract_clip(str(clip), mode, frames_num, interval))
        return len(clips)

    from concurrent.futures import ThreadPoolExecutor

    def load_group(group):
        out = []
        for clip in group:
            frames = video_lib.load_clip(str(clip))
            out.append(frames[fix_sample_indices(len(frames), frames_num)])
        return out

    groups = [clips[i:i + clip_batch] for i in range(0, len(clips), clip_batch)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load_group, groups[0]) if groups else None
        for gi, group in enumerate(groups):
            frames_list = fut.result()
            if gi + 1 < len(groups):
                fut = pool.submit(load_group, groups[gi + 1])
            if len({f.shape for f in frames_list}) == 1 and len(frames_list) > 1:
                per_clip = np.split(extractor(np.concatenate(frames_list)), len(frames_list))
            else:  # mixed raw resolutions: forward per clip
                per_clip = [extractor(f) for f in frames_list]
            for clip, feats in zip(group, per_clip):
                save(clip, feats)
    return len(clips)
