"""Data- and vocab-parallel runs on several cards over NCCL, against one card.

    python -m torch.distributed.run --nproc_per_node 4 -m s2vt_tpu_torch.tools.parallel_check

Rank 0 writes a seeded corpus of chip_smoke.py's phase-4 shape (128 clips of
[80, 4096] float32) and trains it on its card alone, without a process
group's collectives (the one-card run). Then every rank trains the same
corpus, 2 epochs at H = E = 512, V = 10240, B = 16 (global), f32,
``use_pallas``, at the meshes (world / 2, 2) and (world, 1), from the same
seeded weights; the (world / 2, 2) checkpoint is captioned through
``greedy_eval`` and ``beam_eval`` (the mesh read from its opt.json) and
against the one-card decode of the same checkpoint; and one seeded clip goes
through ``FeatureExtractor("vgg16", mesh=(world, 1))`` against
``mesh=None``. Each rank prints its kernel launches; rank 0 prints the
losses, the clips/s of each run's second epoch, the sentences' agreement
and the features' error, then one JSON line. Exits 1 when a run's losses
are off the one-card run's by more than rtol 1e-4 (the JAX Trainer's
bound), when fewer than 0.99 of the sentences agree (float32 sums of a
local batch may take another order than the one-card batch's, so a
near-tie may flip), or when the features are off by more than 1e-5 of the
largest. Needs a card per rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch.distributed as dist

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
from s2vt_tpu_torch.evaluation.decode import (CaptionDecoder, beam_eval, greedy_eval,
                                              model_from_checkpoint)
from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
from s2vt_tpu_torch.ops import fused_decode, fused_s2vt
from s2vt_tpu_torch.parallel import distributed, make_mesh
from s2vt_tpu_torch.training import Trainer

H, FEAT, LENGTH, VOCAB, BATCH, EPOCHS, CLIPS = 512, 4096, 80, 10240, 16, 2, 128
LOSS_RTOL, SENTENCES_MIN, FEAT_RTOL = 1e-4, 0.99, 1e-5


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.splitlines()[0].strip()


def _launches() -> dict:
    return {"fused_s2vt_fwd": fused_s2vt.fused_s2vt_fwd.launches,
            "fused_s2vt_bwd": fused_s2vt.fused_s2vt_bwd.launches,
            "argmax_linear": fused_decode.argmax_linear.launches}


def _reset() -> None:
    fused_s2vt.fused_s2vt_fwd.launches = fused_s2vt.fused_s2vt_bwd.launches = 0
    fused_decode.argmax_linear.launches = 0


def _broadcast(obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    distributed.initialize(device="cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world < 2 or world % 2:
        raise SystemExit(f"parallel_check needs an even world of 2 or more ranks, got {world}")
    card = _card()
    tmp = tempfile.TemporaryDirectory(prefix="parallel_check-") if rank == 0 else None
    try:
        failures = _check(args.seed, rank, world, card, _broadcast(tmp and tmp.name))
    finally:
        dist.barrier()
        if tmp is not None:
            tmp.cleanup()
        distributed.shutdown()
    return 1 if failures else 0


def _check(seed: int, rank: int, world: int, card: str, root: str) -> list:
    """Every check of the module docstring on this rank; returns the
    failures of all ranks."""
    out, failures = {"world": world, "card": card}, []
    if rank == 0:
        meta = make_synthetic_corpus(root, n_videos=CLIPS, vocab_extra=8, max_caption_words=24,
                                     feat_len=LENGTH, feat_dim=FEAT, seed=seed)
    meta = _broadcast(meta if rank == 0 else None)
    base = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
               gts_file=meta["gts_file"], train_length=LENGTH, dim_hidden=H, dim_embed=H,
               feat_dim=FEAT, vocab_pad_multiple=VOCAB, batch_size=BATCH, use_pallas=True,
               compute_dtype="float32", EPOCHS=EPOCHS, lr=1e-3, seed=seed,
               log_dir=os.path.join(root, "runs"))

    one = None
    if rank == 0:                      # the one-card run: no collective
        tr = Trainer(base.replace(save_path=os.path.join(root, "one")), writer=None)
        one = {k: tr.fit()[k] for k in ("train_loss", "valid_loss", "lr", "clips_per_sec")}
    one = _broadcast(one)
    out["one_card"] = one
    finals = {}
    for shape in ((world // 2, 2), (world, 1)):
        _reset()
        tr = Trainer(base.replace(save_path=os.path.join(root, f"mesh{shape[0]}x{shape[1]}"),
                                  mesh_shape=shape), writer=None)
        hist = tr.fit()
        launches = _launches()
        print(f"rank {rank}: mesh {shape} fit launches {launches} [{card}]", flush=True)
        finals[shape] = os.path.join(tr.opt.save_path, tr.opt.start_time + "final")
        rel = max(_rel(hist[k], one[k]) for k in ("train_loss", "valid_loss", "lr"))
        out[f"mesh {shape}"] = {"train_loss": hist["train_loss"],
                                "valid_loss": hist["valid_loss"], "loss_rel_err": rel,
                                "clips_per_sec": hist["clips_per_sec"], "launches": launches}
        if rel > LOSS_RTOL:
            failures.append(f"mesh {shape}: losses off the one-card run by {rel:.3g}")

    tp_final = finals[(world // 2, 2)]
    ds = VideoDataset(meta["captions_file"], meta["feat_path"], max_len=LENGTH, mode="test",
                      seed=seed)
    for name, entry, kw in (("greedy", greedy_eval, {}), ("beam", beam_eval, {})):
        _reset()
        preds = entry(tp_final, batch_size=BATCH, **kw)
        launches = _launches()
        want = None
        if rank == 0:
            _, model = model_from_checkpoint(tp_final, ds.vocab_size)
            dec = CaptionDecoder(model, ds)
            want = dec.greedy(BATCH) if name == "greedy" else dec.beam(BATCH)
        want = _broadcast(want)
        same = sum(preds.get(k) == v for k, v in want.items()) / max(len(want), 1)
        print(f"rank {rank}: {name}_eval over mesh {(world // 2, 2)} launches {launches}, "
              f"sentences equal to one card: {same:.4f} [{card}]", flush=True)
        out[f"{name}_eval"] = {"clips": len(preds), "same": same, "launches": launches}
        if same < SENTENCES_MIN or len(preds) != len(want):
            failures.append(f"{name}_eval: {same:.4f} of the sentences agree")

    clip = np.random.default_rng(seed).integers(0, 256, (LENGTH, 300, 400, 3), np.uint8)
    want = _broadcast(FeatureExtractor("vgg16")(clip) if rank == 0 else None)
    feats = FeatureExtractor("vgg16", mesh=make_mesh((world, 1)))(clip)
    rel = _rel(feats, want)
    out["extract"] = {"frames": LENGTH, "rel_err": rel}
    if rel > FEAT_RTOL:
        failures.append(f"extraction off mesh=None by {rel:.3g}")

    parts = [None] * world
    dist.all_gather_object(parts, failures)
    failures = [f for part in parts for f in part]
    if rank == 0:
        print(json.dumps(out), flush=True)
        for f in failures:
            print(f"FAILED: {f}", flush=True)
    return failures


if __name__ == "__main__":
    sys.exit(main())
