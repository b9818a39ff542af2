"""The feature-extraction loop: one client sends requests of ``clip_batch``
clips back to back, each doing what the 'fix'-mode group body of
``s2vt_tpu_torch/extract/pipeline.py::extract`` does: concatenate the
clips' sampled frames, make one ``FeatureExtractor`` call (the frames
uploaded, preprocessed on the card, the backbone's forward, the features
copied to the host) and split the features per clip. What ``extract()``
does besides, the ffmpeg decode and sampling on a worker thread and
``np.save``, is left out.

Set-up builds the program's ``FeatureExtractor`` on the card, loads the
seed's weights into it, and makes the seed's pool of raw uint8 clips in
host memory; request i takes the i-th block of a seeded permutation of the
pool (cycling), so no two requests in a row see the same clips. After the
window a seeded sample of the served requests, the window's last among
them, is judged: the reference extracts the same clips from weights and
frames made again from the seed, and ``feature_gap`` reads how far the
served features lie from its own.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, vgg_weights
from benchmark.reference import vgg16 as ref
from benchmark.trace import traced
from benchmark.weights import ORDER, SAMPLE, sub_seed

KERNEL = "conv3x3_bn_relu"
FAULT_BN_LAYER = 12          # the conv whose BatchNorm the reading's fault leaves out


def build_extractor(job):
    """The program's ``FeatureExtractor`` with the seed's weights."""
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor

    with torch.device(job.device):
        extractor = FeatureExtractor(job.cfg["backbone"], use_pallas=True, device=job.device)
    extractor.model.load_state_dict(vgg_weights.make_weights(job.cfg, job.seed, job.device))
    return extractor


def make_pool(job) -> np.ndarray:
    """The seed's raw clips [pool_clips, frames, H, W, 3] uint8, in host memory."""
    return vgg_weights.make_frames(job.traffic, job.seed, job.device).cpu().numpy()


def request_clips(job, i: int) -> np.ndarray:
    """The pool's clips of request i."""
    B, n = job.traffic["clip_batch"], job.traffic["pool_clips"]
    order = np.random.default_rng(sub_seed(job.seed, ORDER)).permutation(n)
    block = i % (n // B)
    return order[block * B:(block + 1) * B]


def requester(job, extractor, pool: np.ndarray):
    """request(i) -> the features of request i's clips, one array a clip."""
    blocks = [request_clips(job, i) for i in range(job.traffic["pool_clips"]
                                                    // job.traffic["clip_batch"])]

    def request(i: int) -> list:
        # the benchmark's own spans, which name the card's idle gaps
        clips = blocks[i % len(blocks)]
        with record_function("bench.concat"):
            frames = np.concatenate([pool[c] for c in clips])
        with record_function("bench.extract"):
            feats = extractor(frames)
        with record_function("bench.split"):
            return np.split(feats, len(clips))
    return request


def run(job) -> dict:
    cfg, tr = job.cfg, job.traffic
    cuda = torch.device(job.device).type == "cuda"
    extractor = build_extractor(job)
    pool = make_pool(job)
    job.log("extractor and pool made")
    request = requester(job, extractor, pool)
    for i in range(tr["warmup_requests"]):
        request(i)
    job.log("warmed up")
    if cuda:
        torch.cuda.synchronize(job.device)
        torch.cuda.reset_peak_memory_stats(job.device)

    B, want = tr["clip_batch"], (tr["frames_per_clip"], cfg["feat_dim"])
    served, failed = [], 0
    with harness.quiet_host():
        t_start = time.perf_counter()
        setup_s = t_start - job.t0
        while time.perf_counter() - t_start < job.seconds:
            per_clip = request(len(served))
            served.append(per_clip)
            failed += int(len(per_clip) != B or any(f.shape != want for f in per_clip))
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(job.device) if cuda else 0
    failed += sum(not all(np.isfinite(f).all() for f in per_clip) for per_clip in served)

    span, audit, launches = None, [], {}
    if job.trace:
        before = harness.launch_counts()
        at = len(served)
        with tempfile.TemporaryDirectory(dir=job.workdir) as tmp:
            span = traced(lambda: [request(at + k) for k in range(tr["traced_requests"])],
                          os.path.join(tmp, "trace.json"), job.device)
        after = harness.launch_counts()
        audit = harness.audit_lines(before, after, span)
        launches = {op: after[op] - before[op] for op in after}

    del extractor, request
    if cuda:
        torch.cuda.empty_cache()
    job.log("window closed")
    judged = [(i, np.concatenate(served[i])) for i in sample_of(job, len(served))]
    numbers = {"feature_gap": check_gap(job, judged)}
    job.log("reference compared")
    return {"attempted": len(served), "failed": failed, "memory_peak_bytes": peak,
            "e2e": {"extract_clips_per_s": len(served) * B / window_s, "setup_s": setup_s},
            "ctx": {"loop": "extract", "cfg": cfg, "traffic": tr,
                    "frames": B * tr["frames_per_clip"], "window_s": window_s,
                    "window_units": len(served), "span": span,
                    "span_units": tr["traced_requests"], "launches": launches},
            "span": span, "audit": audit, "numbers": numbers}


def sample_of(job, n: int) -> list:
    """The requests judged, of the ``n`` served: the window's last and a
    seeded sample of the others, ``check_requests`` in all."""
    rng = np.random.default_rng(sub_seed(job.seed, SAMPLE))
    rest = [i for i in rng.permutation(n).tolist() if i != n - 1]
    return [n - 1] + rest[:job.traffic["check_requests"] - 1]


def feature_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of a frame's features [N, F]: max |got - want| of the
    frame over the larger of its own max |want| and the median frame's."""
    if got.shape != want.shape:
        return float("inf")
    scale = want.abs().amax(dim=1)
    gap = (got - want).abs().amax(dim=1) / torch.maximum(scale, scale.median())
    return float(gap.max()) if bool(torch.isfinite(gap).all()) else float("inf")


def check_gap(job, requests, precision: str = "float32", skip_bn=None,
              stand_in: bool = False) -> float:
    """The widest ``feature_gap`` over the given (request index, served
    features [clips * frames, F]) against the reference; with ``stand_in``
    the reference in ``precision`` with ``skip_bn`` stands in the program's
    place (the control and a fault)."""
    params = vgg_weights.make_weights(job.cfg, job.seed, job.device)
    pool = vgg_weights.make_frames(job.traffic, job.seed, job.device)
    widest = 0.0
    for i, feats in requests:
        frames = pool[torch.from_numpy(request_clips(job, i)).to(job.device)].flatten(0, 1)
        want = ref.features(params, frames, job.cfg)
        got = (ref.features(params, frames, job.cfg, precision, skip_bn) if stand_in
               else torch.from_numpy(feats).to(job.device))
        widest = max(widest, feature_gap(got, want))
    return widest


def readings(job, control: bool) -> dict:
    """The calibration's readings at the cell's size (``benchmark/calibrate.py``):
    ``check_requests`` requests served by the program and judged; with
    ``control``, the reference in TF32 in the program's place, the
    reference with one conv's BatchNorm left out in its place, and the
    served features with the request's clips rotated by one."""
    extractor = build_extractor(job)
    request = requester(job, extractor, make_pool(job))
    served = [(i, np.concatenate(request(i))) for i in range(job.traffic["check_requests"])]
    del extractor, request
    out = {"program": {"feature_gap": check_gap(job, served)}}
    if control:
        F = job.traffic["frames_per_clip"]
        out["control"] = {"feature_gap": check_gap(job, served, "tf32", stand_in=True)}
        out["bn_left_out"] = {"feature_gap": check_gap(job, served, skip_bn=FAULT_BN_LAYER,
                                                       stand_in=True)}
        out["clips_rotated"] = {"feature_gap": check_gap(
            job, [(i, np.roll(f, F, axis=0)) for i, f in served])}
    return out
