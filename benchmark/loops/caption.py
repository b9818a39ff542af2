"""The offline captioning loop: one client sends requests of ``batch`` clips
back to back, each doing what ``CaptionDecoder._run`` does for one batch:
gather the rows from a device feature bank, ``model.greedy``, copy the
tokens to the host, and turn each row into a sentence with the program's
``ids_to_sentence``.

Set-up builds the model with the seed's weights and a pool of seeded clips
on the device; request i takes the i-th block of a seeded permutation of
the pool (cycling), so no two requests in a row see the same clips. After
the window a seeded sample of the finished requests is judged: the
reference follows each decode's served tokens and reads how far a served
token's logit lies below its step's best.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import corpus, harness, weights
from benchmark.reference import s2vt as ref
from benchmark.trace import traced


def build_model(job):
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.training.loop import build_model as build

    cfg = job.cfg
    opt = Opt(train_length=cfg["length"], dim_hidden=cfg["dim_hidden"],
              dim_embed=cfg["dim_embed"], feat_dim=cfg["feat_dim"], rnn_type=cfg["rnn_type"],
              num_layers=1, compute_dtype=cfg["dtype"], use_pallas=True,
              sos_ix=corpus.SOS_IX, eos_ix=corpus.EOS_IX)
    with torch.device(job.device):
        model = build(opt, cfg["vocab_size"], valid_vocab=cfg["vocab_size"])
    model.load_state_dict(weights.make_weights(cfg, job.seed, job.device))
    return model.eval()


def make_pool(job) -> torch.Tensor:
    """The pool of seeded clips [pool_clips, L, F], float32 on the device."""
    cfg = job.cfg
    gen = torch.Generator(device=job.device).manual_seed(
        weights.sub_seed(job.seed, weights.DATA))
    return corpus.clip_features(gen, job.traffic["pool_clips"], cfg["length"],
                                cfg["feat_dim"], job.device).float()


def request_rows(job, i: int) -> np.ndarray:
    tr = job.traffic
    B, n = tr["batch"], tr["pool_clips"]
    order = np.random.default_rng(weights.sub_seed(job.seed, weights.ORDER)).permutation(n)
    block = i % (n // B)
    return order[block * B:(block + 1) * B]


def run(job) -> dict:
    from s2vt_tpu_torch.data.corpus import ids_to_sentence

    cfg, tr = job.cfg, job.traffic
    cuda = torch.device(job.device).type == "cuda"
    model = build_model(job)
    pool = make_pool(job)
    job.log("model and pool made")
    ix2word = dict(enumerate(corpus.vocabulary(cfg["vocab_size"])))
    blocks = [request_rows(job, i) for i in range(tr["pool_clips"] // tr["batch"])]

    def request(i: int):
        # the benchmark's own spans, which name the card's idle gaps
        with record_function("bench.gather"):
            idx = torch.from_numpy(blocks[i % len(blocks)]).to(job.device, torch.long)
            feats = pool[idx]
        with record_function("bench.greedy"):
            tokens = model.greedy(feats)
        with record_function("bench.tokens_to_host"):
            out = tokens.cpu().numpy()
        with record_function("bench.sentences"):
            sentences = [ids_to_sentence(row, ix2word, corpus.EOS_IX, pad_ix=corpus.PAD_IX)
                         for row in out]
        return out, sentences

    for i in range(tr["warmup_requests"]):
        request(i)
    job.log("warmed up")
    if cuda:
        torch.cuda.synchronize(job.device)
        torch.cuda.reset_peak_memory_stats(job.device)

    served, latency, failed = [], [], 0
    want = (tr["batch"], cfg["length"] - 1)
    with harness.quiet_host():
        t_start = time.perf_counter()
        setup_s = t_start - job.t0
        while time.perf_counter() - t_start < job.seconds:
            t0 = time.perf_counter()
            tokens, sentences = request(len(served))
            latency.append(time.perf_counter() - t0)
            served.append(tokens)
            failed += int(tokens.shape != want or len(sentences) != want[0]
                          or tokens.min() < 0 or tokens.max() >= cfg["vocab_size"])
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(job.device) if cuda else 0

    span, audit = None, []
    span_requests = tr["traced_requests"]
    if job.trace:
        before = harness.launch_counts()
        at = len(served)
        with tempfile.TemporaryDirectory(dir=job.workdir) as tmp:
            span = traced(lambda: [request(at + k) for k in range(span_requests)],
                          os.path.join(tmp, "trace.json"), job.device)
        audit = harness.audit_lines(before, harness.launch_counts(), span)

    del model, pool
    if cuda:
        torch.cuda.empty_cache()
    job.log("window closed")
    numbers = {"logit_gap": check_gap(job, [(i, served[i]) for i in sample_of(job, served)])}
    job.log("reference compared")
    B = tr["batch"]
    return {"attempted": len(served), "failed": failed, "memory_peak_bytes": peak,
            "e2e": {"caption_clips_per_s": len(served) * B / window_s,
                    "caption_p95_ms": float(np.percentile(latency, 95)) * 1e3,
                    "setup_s": setup_s},
            "ctx": {"loop": "caption", "cfg": cfg, "traffic": tr, "batch": B,
                    "window_s": window_s, "window_units": len(served), "span": span,
                    "span_units": span_requests},
            "span": span, "audit": audit, "numbers": numbers}


def sample_of(job, served) -> list:
    """The requests judged: a seeded sample of ``check_requests`` of those
    served, with the one whose captions run longest before <eos> in it."""
    words = [int((np.cumprod(t != corpus.EOS_IX, axis=1)).sum()) for t in served]
    longest = int(np.argmax(words))
    rng = np.random.default_rng(weights.sub_seed(job.seed, weights.SAMPLE))
    rest = [i for i in rng.permutation(len(served)).tolist() if i != longest]
    return [longest] + rest[:job.traffic["check_requests"] - 1]


def check_gap(job, requests, control=None) -> float:
    """The widest gap over the given (request index, served tokens) of a
    served token's reference logit below its step's best; with
    ``control``, of the token that precision puts first."""
    params = weights.make_weights(job.cfg, job.seed, job.device)
    pool = make_pool(job)
    cfg = dict(job.cfg, sos_ix=corpus.SOS_IX)
    widest = 0.0
    for i, tokens in requests:
        rows = torch.from_numpy(request_rows(job, i)).to(job.device, torch.long)
        widest = max(widest, ref.decode_gaps(params, pool[rows],
                                             torch.from_numpy(tokens).to(job.device),
                                             cfg, control))
    return widest
