"""The training loop: ``Trainer.train_epoch`` back to back, as
``Trainer.fit`` runs it each epoch, from the Trainer's device feature bank.

Set-up writes the seeded corpus, builds the model with the seed's weights
and one ``Trainer``, and runs its epoch 0 and epoch 1 with ``train_epoch``.
The window runs whole epochs of that same Trainer until ``seconds`` have
passed; each ends on the epoch's one synchronise.

Two stages are judged, each over its first ``CHECK_STEPS`` steps, which a
``Recorder`` watches inside ``train_epoch`` (the window's own call and
feed): the start, epoch 0 from the seed's weights, and the window's first
epoch, from the parameters and AdamW state the window started with (a host
copy taken in set-up). After the window the program is freed and the
reference follows both stages over the same clips, with the captions the
benchmark wrote for them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, corpus, harness, weights
from benchmark.reference import s2vt as ref
from benchmark.trace import traced

CHECK_STEPS = 3
BETA1 = 0.9


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def build_trainer(job, paths: dict):
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.training.loop import Trainer, build_model

    cfg, tr = job.cfg, job.traffic
    opt = Opt(caption_file=paths["captions_file"], feats_path=paths["feats_path"],
              train_length=cfg["length"], dim_hidden=cfg["dim_hidden"],
              dim_embed=cfg["dim_embed"], feat_dim=cfg["feat_dim"], rnn_type=cfg["rnn_type"],
              num_layers=1, batch_size=tr["batch"], lr=cfg["lr"],
              weight_decay=cfg["weight_decay"], compute_dtype=cfg["dtype"], use_pallas=True,
              seed=weights.sub_seed(job.seed, weights.ORDER), device_feature_bank="on",
              sos_ix=corpus.SOS_IX, eos_ix=corpus.EOS_IX,
              save_path=os.path.join(job.workdir, "ckpt"),
              log_dir=os.path.join(job.workdir, "runs"))
    with torch.device(job.device):
        model = build_model(opt, cfg["vocab_size"], valid_vocab=cfg["vocab_size"])
    model.load_state_dict(weights.make_weights(cfg, job.seed, job.device))
    return Trainer(opt, model=model, device=job.device, writer=None)


class Recorder:
    """Watches the Trainer's next ``train_epoch`` and records, of its first
    ``n`` steps, the host batches fed, each step's loss, the parameters
    after the n-th step and, with ``first_moment``, AdamW's first moment
    after the first; then it takes itself out of the Trainer."""

    def __init__(self, trainer, n: int, first_moment: bool):
        self.trainer, self.n, self.first_moment = trainer, n, first_moment
        self.fed, self.losses, self.exp_avg, self.params = [], [], None, None
        trainer._batches = self._batches
        trainer.train_step = self._step

    def _batches(self, split: str, epoch: int):
        for batch, sent in type(self.trainer)._batches(self.trainer, split, epoch):
            if len(self.fed) < self.n:
                self.fed.append(batch)
            yield batch, sent

    def _step(self, *args, **kw):
        t = self.trainer
        loss = type(t).train_step(t, *args, **kw)
        self.losses.append(loss)
        named = dict(t.model.named_parameters())
        if len(self.losses) == 1 and self.first_moment:
            state = t.optimizer.state
            self.exp_avg = {k: state[p]["exp_avg"].clone() for k, p in named.items()
                            if p in state}
        if len(self.losses) == self.n:
            self.params = {k: p.detach().clone() for k, p in named.items()}
            del t.train_step, t._batches     # the epoch's feed runs on unwatched
        return loss

    def readings(self, before: dict) -> dict:
        """The losses, the first gradient's norm per leaf (from AdamW's first
        moment after one step from fresh moments), and the norm per leaf of
        the change from ``before`` over the ``n`` steps."""
        out = {"losses": [float(x) for x in self.losses[:self.n]],
               "update": _norms({k: p - before[k].to(p.device) for k, p in self.params.items()})}
        if self.exp_avg is not None:
            out["grad"] = {k: float(torch.linalg.vector_norm(self.exp_avg[k].double()))
                           / (1 - BETA1) if k in self.exp_avg else 0.0 for k in self.params}
        return out


def snapshot(trainer) -> dict:
    """A host copy of the parameters and of AdamW's moments and step count
    (fresh moments where AdamW holds no state)."""
    def copy(t):
        return t.detach().to("cpu", copy=True)
    named = dict(trainer.model.named_parameters())
    state = {k: trainer.optimizer.state.get(p, {}) for k, p in named.items()}
    zero = {k: torch.zeros_like(p, device="cpu") for k, p in named.items()}
    return {"params": {k: copy(p) for k, p in named.items()},
            "m": {k: copy(st["exp_avg"]) if st else zero[k] for k, st in state.items()},
            "v": {k: copy(st["exp_avg_sq"]) if st else zero[k] for k, st in state.items()},
            "t": max((int(float(st["step"])) for st in state.values() if st), default=0)}


def fed_captions(fed, captions: dict, length: int) -> list:
    """Per fed batch, each row's (label, mask) as the benchmark encodes the
    clip's caption that the row's label matches; None where it matches
    none of the clip's own captions."""
    out = []
    for batch in fed:
        rows = []
        for row, vid in enumerate(batch.ids):
            want = [corpus.encode(c, length) for c in captions.get(vid, [])]
            rows.append(next(((lab, m) for lab, m in want
                              if np.array_equal(batch.labels[row], lab)
                              and np.array_equal(batch.mask[row], m)), None))
        out.append(rows)
    return out


def feed_mismatches(fed, paths: dict, length: int) -> int:
    return sum(r is None for rows in fed_captions(fed, paths["captions"], length) for r in rows)


def reference_readings(job, paths: dict, fed, start: dict = None,
                       precision: str = "float32", half_batch: bool = False) -> dict:
    """The reference over the fed clips, with the captions the benchmark
    wrote for them (a row that matches none takes the clip's first, and
    ``feed_mismatches`` counts it): from the seed's weights and fresh
    moments, or from ``start`` (a ``snapshot``)."""
    cfg, dev = job.cfg, job.device
    batches = []
    for batch, rows in zip(fed, fed_captions(fed, paths["captions"], cfg["length"])):
        feats = np.stack([np.load(os.path.join(paths["feats_path"], f"{v}.npy"))
                          for v in batch.ids]).astype(np.float32)
        own = [r or corpus.encode(paths["captions"][v][0], cfg["length"])
               for r, v in zip(rows, batch.ids)]
        batches.append((torch.from_numpy(feats).to(dev),
                        torch.from_numpy(np.stack([lab for lab, _ in own])).to(dev),
                        torch.from_numpy(np.stack([m for _, m in own])).to(dev),
                        torch.from_numpy(batch.valid).to(dev)))
    if start is None:
        params, state = weights.make_weights(cfg, job.seed, dev), None
    else:
        params = {k: v.to(dev, copy=True) for k, v in start["params"].items()}
        state = ({k: v.to(dev, copy=True) for k, v in start["m"].items()},
                 {k: v.to(dev, copy=True) for k, v in start["v"].items()}, start["t"])
    w0 = {k: v.clone() for k, v in params.items()}
    losses, grads, after = ref.train_steps(params, batches, cfg, precision, half_batch, state)
    return {"losses": losses, "grad": _norms(grads),
            "update": _norms({k: after[k] - w0[k] for k in after})}


def judge(job, paths: dict, stages: dict, **fault) -> dict:
    """The numbers a run compares, from the program's readings of each stage
    (``stages``: name -> (readings, fed, start)) against the reference's;
    with ``fault`` (``precision``, ``half_batch``) the reference so changed
    stands in the program's place."""
    numbers = {}
    for name, (prog, fed, start) in stages.items():
        want = reference_readings(job, paths, fed, start)
        if fault:
            prog = dict(reference_readings(job, paths, fed, start, **fault))
            if start is not None:
                prog.pop("grad")
        prefix = "" if start is None else "window_"
        numbers.update({prefix + k: v for k, v in compare.train_numbers(prog, want).items()})
    return numbers


def run(job) -> dict:
    """One run. With ``job.faults`` (a list of keyword sets for ``judge``)
    the result's ``faults`` holds the numbers with each in the program's
    place (``benchmark/calibrate.py``)."""
    cfg, tr = job.cfg, job.traffic
    cuda = torch.device(job.device).type == "cuda"
    root = tempfile.mkdtemp(prefix="corpus-", dir=job.workdir)
    try:
        gen = torch.Generator(device=job.device).manual_seed(
            weights.sub_seed(job.seed, weights.DATA))
        paths = corpus.write_corpus(root, cfg, tr, weights.sub_seed(job.seed, weights.WORDS),
                                    gen, job.device)
        job.log("corpus written")
        trainer = build_trainer(job, paths)
        job.log("Trainer built, feature bank uploaded")
        first = Recorder(trainer, CHECK_STEPS, first_moment=True)
        trainer.train_epoch(0)
        trainer.train_epoch(1)                      # warm-up: a whole epoch more
        start = snapshot(trainer)
        job.log("epochs 0 and 1 run")
        clips_per_epoch = len(trainer.train_ds)
        steps_per_epoch = trainer.train_ds.steps_per_epoch(tr["batch"])
        if cuda:
            torch.cuda.synchronize(job.device)
            torch.cuda.reset_peak_memory_stats(job.device)

        window = Recorder(trainer, CHECK_STEPS, first_moment=False)
        epoch, steps, clips, failed = 2, 0, 0, 0
        with harness.quiet_host():
            t_start = time.perf_counter()
            setup_s = t_start - job.t0
            while True:
                loss, _ = trainer.train_epoch(epoch)    # ends on the epoch's one sync
                epoch += 1
                steps += steps_per_epoch
                clips += clips_per_epoch
                failed += 0 if np.isfinite(loss) else steps_per_epoch
                if time.perf_counter() - t_start >= job.seconds:
                    break
            window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated(job.device) if cuda else 0

        span, audit, span_steps = None, [], 0
        if job.trace:
            before = harness.launch_counts()
            span_epochs, at = tr["traced_epochs"], epoch

            def work():
                for k in range(span_epochs):
                    with record_function("bench.train_epoch"):
                        trainer.train_epoch(at + k)
            span = traced(work, os.path.join(root, "trace.json"), job.device)
            audit = harness.audit_lines(before, harness.launch_counts(), span)
            span_steps = span_epochs * steps_per_epoch

        stages = {"start": (first.readings(weights.make_weights(cfg, job.seed, job.device)),
                            first.fed, None),
                  "window": (window.readings(start["params"]), window.fed, start)}
        del trainer, first, window
        if cuda:
            torch.cuda.empty_cache()
        job.log("window closed")
        numbers = judge(job, paths, stages)
        numbers["feed_mismatches"] = float(sum(
            feed_mismatches(fed, paths, cfg["length"]) for _, fed, _ in stages.values()))
        faults = [judge(job, paths, stages, **f) for f in getattr(job, "faults", [])]
        job.log("reference compared")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"attempted": steps, "failed": failed, "memory_peak_bytes": peak,
            "e2e": {"train_clips_per_s": clips / window_s, "setup_s": setup_s},
            "ctx": {"loop": "train", "cfg": cfg, "traffic": tr, "batch": tr["batch"],
                    "window_s": window_s, "window_units": steps, "span": span,
                    "span_units": span_steps},
            "span": span, "audit": audit, "numbers": numbers, "faults": faults}
