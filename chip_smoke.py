#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2vt_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases; a failure in any of them exits non-zero before the result line:
  1. device   the card's name and power limit; build every CUDA kernel of the
              port from s2vt_tpu_torch/csrc with nvcc (sm_90a), one nvcc per
              source, all started together.
  2. kernels  each kernel against its plain PyTorch version at the MSVD width
              (H = 512, T = 2L - 1 = 159) for B in {1, 16, 96, 200} in float32
              and bf16; kernel, plain and library (cuDNN nn.LSTM) times beside
              the bound.
  3. slice    greedy_eval -> model_from_checkpoint on a corpus and a
              checkpoint made from --seed at H = E = 512, F = 4096, L = 80
              (the serving path; the kernel launch counts are read around it),
              then S2VT.greedy at V = 10240, B in {16, 96}, float32 and bf16,
              against the same model with the plain fused kernels.
  4. train    s2vt_tpu_torch.cli.train -> Trainer.fit on a corpus made from
              --seed at H = E = 512, F = 4096, L = 80, V = 10240, B = 16 (the
              main path; launch counts read around it), its final checkpoint
              through greedy_eval, the kernel route's gradients against the
              plain route's, and train-step times at B in {16, 96}, float32
              and bf16.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

H = E = 512            # MSVD width (bench.py:56)
FEAT = 4096
LENGTH = 80            # T = 2L - 1 = 159
VOCAB = 10240
KERNEL_BATCHES = (1, 16, 96, 200)
TIMED_BATCHES = (16, 96)
MAIN_BATCH = 16        # greedy_eval and training batch of the main paths
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
ROW_MATCH_MIN_F32 = 0.99
GRAD_TOL = 2e-3        # kernel vs plain route gradients, f32 (tests/test_pallas_s2vt.py:122)
LOSS_TOL = 1e-4        # kernel vs plain route loss, f32 (fused logits, test_pallas_s2vt.py:103)
TRAIN_CLIPS = 128      # corpus clips: 64 train (4 steps of 16), 32 valid, 32 test
TRAIN_EPOCHS = 2
KERNELS = ("fused_s2vt_fwd", "fused_s2vt_bwd")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the fused forward: each input read once (x1, x2, three
    [4H, H] weights), each output written once (gates and c of both layers,
    six [B, H] finals), against the 2*T*B*12*H^2 operations of the two
    chains' recurrent products at the peak rate of the operand type."""
    es = 2 if dtype_name == "bfloat16" else 4
    G = 4 * hid
    nbytes = (2 * T * B * G * es + 3 * G * hid * es       # x1, x2, weights
              + 2 * T * B * G * es + 2 * T * B * hid * 4  # gates, c
              + 6 * B * hid * 4)                          # finals, snapshot
    flops = 2 * T * B * (G * hid + G * 2 * hid)
    return _bound(nbytes, flops, dtype_name)


def fused_bwd_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the fused backward: g1, g2, c1, c2, dout2 and the three
    [4H, H] weights read once, dxp1 and dxp2 written once, against the
    2*T*B*12*H^2 operations of the [B, 8H] x [8H, H] and [B, 4H] x [4H, H]
    products at the peak rate of the operand type."""
    es = 2 if dtype_name == "bfloat16" else 4
    G = 4 * hid
    nbytes = (2 * T * B * G * es + 3 * T * B * hid * 4    # g1, g2; c1, c2, dout2
              + 3 * G * hid * es + 2 * T * B * G * es)    # weights; dxp1, dxp2
    flops = 2 * T * B * 12 * hid * hid
    return _bound(nbytes, flops, dtype_name)


def _bound(nbytes: int, flops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def fused_inputs(torch, B, T, hid, dtype, device, gen):
    k = 1.0 / math.sqrt(hid)
    x1 = torch.randn(T, B, 4 * hid, device=device, generator=gen).to(dtype)
    x2 = torch.randn(T, B, 4 * hid, device=device, generator=gen).to(dtype)
    ws = [((torch.rand(4 * hid, hid, device=device, generator=gen) * 2 - 1) * k).to(dtype)
          for _ in range(3)]
    return [x1, x2, *ws]


def cudnn_lstms(torch, hid, emb, dtype, device):
    """The vid and word nn.LSTM at the fused kernels' shapes, made on the card
    in their dtype, each with its weights in one buffer as cuDNN wants.
    flatten_parameters() leaves bf16 weights apart (bf16 is not in
    torch.backends.cudnn.CUDNN_TENSOR_DTYPES) although cuDNN runs bf16 LSTMs
    and then warns that the weights are not contiguous; bf16 is admitted for
    the call. A yardstick only: the port never calls it."""
    lstm1 = torch.nn.LSTM(hid, hid, batch_first=True, device=device, dtype=dtype)
    lstm2 = torch.nn.LSTM(emb + hid, hid, batch_first=True, device=device, dtype=dtype)
    accepted = torch.backends.cudnn.CUDNN_TENSOR_DTYPES
    added = dtype not in accepted
    accepted.add(dtype)
    try:
        for lstm in (lstm1, lstm2):
            lstm.flatten_parameters()
    finally:
        if added:
            accepted.discard(dtype)
    for lstm in (lstm1, lstm2):
        if len({w.untyped_storage().data_ptr() for w in lstm._flat_weights}) != 1:
            raise SystemExit(f"cuDNN yardstick: {dtype} LSTM weights are not one buffer")
    return lstm1, lstm2


def cuda_ms_quiet(torch, fn, reps: int, label: str, warmup: int = 2) -> float:
    """``cuda_ms``, failing if the call raises any warning (a cuDNN LSTM whose
    weights are not one buffer warns, and its time would be too high)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ms = cuda_ms(torch, fn, reps, warmup)
    if caught:
        raise SystemExit(f"{label} warned: {caught[0].message}")
    return ms


def library_lstm_ms(torch, B, T, hid, emb, dtype, device, reps) -> float:
    """Two cuDNN nn.LSTM calls, vid then word on [x2 part | out1], at the
    fused forward's shapes, inference only."""
    lstm1, lstm2 = cudnn_lstms(torch, hid, emb, dtype, device)
    x = torch.randn(B, T, hid, device=device, dtype=dtype)
    x2 = torch.zeros(B, T, emb, device=device, dtype=dtype)

    def run():
        out1, _ = lstm1(x)
        lstm2(torch.cat([x2, out1], dim=-1))

    with torch.no_grad():
        return cuda_ms_quiet(torch, run, reps, f"cuDNN LSTM forward B={B} {dtype}")


def library_lstm_bwd_ms(torch, B, T, hid, emb, dtype, device, reps) -> float:
    """The backward of the same two cuDNN nn.LSTM calls: forward + backward
    less the forward, both with autograd on. cuDNN's backward also forms the
    weight gradients and the input gradients through W_ih."""
    lstm1, lstm2 = cudnn_lstms(torch, hid, emb, dtype, device)
    x = torch.randn(B, T, hid, device=device, dtype=dtype, requires_grad=True)
    x2 = torch.zeros(B, T, emb, device=device, dtype=dtype, requires_grad=True)
    dout = torch.randn(B, T, hid, device=device, dtype=dtype)

    def fwd():
        out1, _ = lstm1(x)
        return lstm2(torch.cat([x2, out1], dim=-1))[0]

    label = f"cuDNN LSTM B={B} {dtype}"
    both = cuda_ms_quiet(torch, lambda: fwd().backward(dout), reps, label)
    return both - cuda_ms_quiet(torch, fwd, reps, label)


@contextlib.contextmanager
def plain_fused_kernels():
    """Route the fused forward and backward to their plain PyTorch versions,
    on any device."""
    from s2vt_tpu_torch.ops import fused_s2vt
    kernels = fused_s2vt.fused_s2vt_fwd, fused_s2vt.fused_s2vt_bwd
    fused_s2vt.fused_s2vt_fwd = fused_s2vt.fused_s2vt_fwd_reference
    fused_s2vt.fused_s2vt_bwd = fused_s2vt.fused_s2vt_bwd_reference
    try:
        yield
    finally:
        fused_s2vt.fused_s2vt_fwd, fused_s2vt.fused_s2vt_bwd = kernels


def reset_launches():
    from s2vt_tpu_torch.ops import fused_s2vt
    fused_s2vt.fused_s2vt_fwd.launches = fused_s2vt.fused_s2vt_bwd.launches = 0


def read_launches() -> dict:
    from s2vt_tpu_torch.ops import fused_s2vt
    return {name: getattr(fused_s2vt, name).launches for name in KERNELS}


def _check(torch, kernel, B, name, hid, T, got, want, errors):
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    finite = all(torch.isfinite(g.float()).all().item() for g in got)
    ok = finite and err <= ATOL[name]
    errors[(kernel, B, name)] = err
    print(f"kernel {kernel} B={B} {name} H={hid} T={T}: max_abs_err={err:.3e} "
          f"(bound {ATOL[name]:.0e}; max |output| {scale:.3g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{kernel} disagrees with its plain version at B={B} {name}: "
                         f"max_abs_err={err}, finite={finite}")


def phase_kernels(torch, device, hid, length, batches, timed, reps, card):
    """Each kernel against its plain version at every batch and dtype; times
    at ``timed``. The backward's inputs come from a forward run of the same
    weights, so its gates and c are real LSTM states."""
    from s2vt_tpu_torch.ops import fused_s2vt as fs
    T = 2 * length - 1
    snap = length - 1
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(1234)
    errors, times = {}, {}
    for B in batches:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            args = fused_inputs(torch, B, T, hid, dtype, device, gen)
            got = fs.fused_s2vt_fwd(*args, snap)
            sync()
            _check(torch, "fused_s2vt_fwd", B, name, hid, T, got,
                   fs.fused_s2vt_fwd_reference(*args, snap), errors)
            g1, c1, g2, c2 = got[:4]
            dout2 = torch.randn(T, B, hid, device=device, generator=gen)
            bargs = (g1, c1, g2, c2, dout2, *args[2:])
            dxp = fs.fused_s2vt_bwd(*bargs)
            sync()
            _check(torch, "fused_s2vt_bwd", B, name, hid, T, dxp, fs.fused_s2vt_bwd_reference(*bargs),
                   errors)
            if B not in timed:
                continue
            k_ms = cuda_ms(torch, lambda: fs.fused_s2vt_fwd(*args, snap), reps)
            p_ms = cuda_ms(torch, lambda: fs.fused_s2vt_fwd_reference(*args, snap),
                           max(1, reps // 5), warmup=1)
            lib_ms = library_lstm_ms(torch, B, T, hid, hid, dtype, device, reps)
            bound, bound_by, nbytes, flops = fused_bound_ms(B, T, hid, name)
            times[("fused_s2vt_fwd", B, name)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                      bound_ms=bound, bound_by=bound_by)
            print(f"time fused_s2vt_fwd B={B} {name}: kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                  f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)

            # The backward; cuDNN's backward also forms dW, so the kernel is
            # timed again with the three dW products of the autograd Function.
            h1 = fs._h_from(g1, c1)
            h1p, h2p = fs._shift_in_zero(h1), fs._shift_in_zero(fs._h_from(g2, c2))

            def bwd_and_dw():
                d1, d2 = (d.float() for d in fs.fused_s2vt_bwd(*bargs))
                fs._outer_sum(d1, h1p), fs._outer_sum(d2, h1), fs._outer_sum(d2, h2p)

            k_ms = cuda_ms(torch, lambda: fs.fused_s2vt_bwd(*bargs), reps)
            kdw_ms = cuda_ms(torch, bwd_and_dw, reps)
            p_ms = cuda_ms(torch, lambda: fs.fused_s2vt_bwd_reference(*bargs),
                           max(1, reps // 5), warmup=1)
            lib_ms = library_lstm_bwd_ms(torch, B, T, hid, hid, dtype, device, reps)
            bound, bound_by, nbytes, flops = fused_bwd_bound_ms(B, T, hid, name)
            times[("fused_s2vt_bwd", B, name)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                      bound_ms=bound, bound_by=bound_by,
                                                      with_dw_ms=kdw_ms)
            print(f"time fused_s2vt_bwd B={B} {name}: kernel_ms={k_ms:.4f} "
                  f"kernel_plus_3dW_ms={kdw_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_bwd_ms={lib_ms:.4f} (cuDNN fwd+bwd less fwd) bound_ms={bound:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                  f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)
    return errors, times


def profile_call(torch, fn, wall_ms, label, card) -> dict:
    """One call of ``fn`` under torch.profiler: device busy time (sum of the
    kernels' own device time), each fused kernel's share of it, and the top
    three device operations. The idle share is taken against ``wall_ms``, the
    unprofiled time of the call, since the profiler slows the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    own = {k: sum(e.self_device_time_total for e in kernels
                  if k.replace("fused_s2vt", "s2vt_fused") + "_kernel" in e.key) / 1e3
           for k in KERNELS}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower() or "xmma" in e.key) / 1e3
    print(f"profile {label}: wall_ms={wall_ms:.3f} (profiled {prof_ms:.3f}) "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.4f} "
          + " ".join(f"{k}_ms={v:.3f} ({v / max(busy_ms, 1e-9):.4f} of busy)"
                     for k, v in own.items())
          + f" gemm_ms={gemm_ms:.3f} other_ms={busy_ms - gemm_ms - sum(own.values()):.3f}"
          + f" launches={sum(e.count for e in kernels)} top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top) + f" [{card}]", flush=True)
    return dict(busy_ms=busy_ms, **own)


def make_checkpoint(torch, root, seed, opt, vocab_size):
    """Random weights from ``seed`` written as opt.json + params.npz."""
    from s2vt_tpu_torch.training import build_model, save_checkpoint
    from s2vt_tpu_torch.utils.weights import params_to_jax
    model = build_model(opt, vocab_size)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return save_checkpoint(f"{root}/ckpt", params_to_jax(model), opt.to_json())


def phase_slice(torch, device, seed, hid, feat, length, vocab, n_videos, batches, reps, card):
    """The main path through greedy_eval, then S2VT.greedy kernel vs plain.
    Returns the kernel's launches in the main-path run."""
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.evaluation.decode import greedy_eval
    from s2vt_tpu_torch.models import S2VT

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"   # None: the entry points' default
    with tempfile.TemporaryDirectory() as root:
        meta = make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=200,
                                     feat_len=length, feat_dim=feat, seed=seed)
        opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
                  train_length=length, dim_hidden=hid, dim_embed=hid, feat_dim=feat,
                  use_pallas=True, seed=seed)
        ckpt = make_checkpoint(torch, root, seed, opt, meta["vocab_size"])

        reset_launches()
        t0 = time.perf_counter()
        preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()["fused_s2vt_fwd"]
        with plain_fused_kernels():
            plain_preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
    n_batches = -(-len(preds) // MAIN_BATCH)
    same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
    print(f"slice greedy_eval: {len(preds)} clips in {n_batches} requests of B={MAIN_BATCH}, "
          f"{wall:.3f} s wall, fused_s2vt_fwd launches={launches}, "
          f"sentences equal to the plain route: {same:.4f} [{card}]", flush=True)
    if launches < n_batches:
        raise SystemExit(f"the main path launched fused_s2vt_fwd {launches} times for "
                         f"{n_batches} requests")
    if not preds or not all(isinstance(s, str) and s for s in preds.values()):
        raise SystemExit("greedy_eval returned no or empty captions")
    if same < ROW_MATCH_MIN_F32:
        raise SystemExit(f"greedy_eval sentences differ from the plain route: {same:.4f}")

    gen = torch.Generator().manual_seed(seed + 1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        model = S2VT(vocab, feat, length, hid, hid, use_pallas=True, compute_dtype=(
            None if dtype == torch.float32 else dtype), sos_ix=3, eos_ix=4)
        model.reset_parameters(gen)
        model = model.to(device).eval()
        for B in batches:
            feats = torch.randn(B, length, feat, generator=gen).to(device)
            tokens = model.greedy(feats)
            with plain_fused_kernels():
                plain = model.greedy(feats)
            sync()
            if tokens.shape != (B, length - 1) or not ((tokens >= 0) & (tokens < vocab)).all():
                raise SystemExit(f"greedy tokens malformed: {tuple(tokens.shape)}")
            rows = (tokens == plain).all(dim=1).float().mean().item()
            secs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                model.greedy(feats)
                sync()
                secs.append(time.perf_counter() - t0)
            with plain_fused_kernels():
                t0 = time.perf_counter()
                model.greedy(feats)
                sync()
                plain_s = time.perf_counter() - t0
            med = sorted(secs)[len(secs) // 2]
            print(f"slice S2VT.greedy V={vocab} B={B} {name}: rows equal to the plain route "
                  f"{rows:.4f}, {B / med:.1f} clips/s ({med * 1e3:.3f} ms per request, median "
                  f"of {reps}; plain route {B / plain_s:.1f} clips/s) [{card}]", flush=True)
            if name == "float32" and rows < ROW_MATCH_MIN_F32:
                raise SystemExit(f"float32 greedy rows equal to the plain route: {rows:.4f}")
            if device.type == "cuda" and B == MAIN_BATCH:
                profile_call(torch, lambda: model.greedy(feats), med * 1e3,
                             f"S2VT.greedy B={B} {name}", card)
    return launches


def _random_batch(torch, B, length, feat, real_vocab, device, gen):
    """(feats, labels, mask, valid) on the device: random tokens of the real
    vocab, captions of 4..26 tokens."""
    feats = torch.randn(B, length, feat, generator=gen).to(device)
    mask = (torch.arange(length)[None, :] < torch.randint(4, 27, (B, 1), generator=gen)).float()
    labels = torch.randint(0, real_vocab, (B, length), generator=gen) * mask.long()
    return feats, labels.to(device), mask.to(device), torch.ones(B).to(device)


def _grads(model, batch):
    from s2vt_tpu_torch.training import batch_loss
    feats, labels, mask, valid = batch
    model.zero_grad(set_to_none=True)
    logits = model(feats, labels[:, :-1], mode="train", deterministic=True)
    loss = batch_loss(logits, labels, mask, valid)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_train(torch, device, seed, hid, feat, length, vocab, n_videos, epochs, batches, reps,
                card):
    """The main path: s2vt_tpu_torch.cli.train's main -> Trainer.fit, with the
    launch counts read around it; its final checkpoint through greedy_eval;
    the kernel route's loss and gradients against the plain route's; then
    train-step times. Returns the launches of the main-path run."""
    from s2vt_tpu_torch.cli import train as train_cli
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.evaluation.decode import greedy_eval
    from s2vt_tpu_torch.training import Trainer

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_flag = [] if device.type == "cuda" else ["--device", "cpu"]   # default: the card
    with tempfile.TemporaryDirectory() as root:
        # Few distinct words with long captions, so that after a few steps
        # the most likely token is a word, not <eos>, and captions are not empty.
        meta = make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=8,
                                     max_caption_words=24, feat_len=length, feat_dim=feat,
                                     seed=seed)
        argv = dev_flag + [
            "--caption_file", meta["captions_file"], "--feats_path", meta["feat_path"],
            "--gts_file", meta["gts_file"], "--train_length", str(length),
            "--dim_hidden", str(hid), "--dim_embed", str(hid), "--feat_dim", str(feat),
            "--vocab_pad_multiple", str(vocab), "--batch_size", str(MAIN_BATCH),
            "--use_pallas", "true", "--compute_dtype", "float32", "--EPOCHS", str(epochs),
            "--lr", "1e-3", "--seed", str(seed), "--save_path", f"{root}/ckpt",
            "--log_dir", f"{root}/runs"]
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()
        hist = trainer.history
        n_train, n_valid = len(trainer.train_ds), len(trainer.valid_ds)
        train_steps = epochs * -(-n_train // MAIN_BATCH)
        valid_steps = epochs * -(-n_valid // MAIN_BATCH)
        print(f"train cli.train -> Trainer.fit: V={trainer.vocab_size} H={hid} F={feat} "
              f"L={length} B={MAIN_BATCH} f32, {epochs} epochs of {n_train} clips "
              f"({train_steps} train steps, {valid_steps} valid steps) in {wall:.3f} s; "
              f"train_loss={hist['train_loss']} valid_loss={hist['valid_loss']} "
              f"launches={launches} bank={trainer.use_feature_bank} [{card}]", flush=True)
        if launches["fused_s2vt_bwd"] != train_steps:
            raise SystemExit(f"the training path launched fused_s2vt_bwd "
                             f"{launches['fused_s2vt_bwd']} times for {train_steps} train steps")
        if launches["fused_s2vt_fwd"] < train_steps + valid_steps:
            raise SystemExit(f"the training path launched fused_s2vt_fwd "
                             f"{launches['fused_s2vt_fwd']} times for "
                             f"{train_steps + valid_steps} steps")
        losses = hist["train_loss"] + hist["valid_loss"]
        if len(hist["train_loss"]) != epochs or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"training losses missing or not finite: {hist}")
        if not hist["train_loss"][-1] < hist["train_loss"][0]:
            raise SystemExit(f"the train loss did not fall: {hist['train_loss']}")

        final = os.path.join(trainer.opt.save_path, trainer.opt.start_time + "final")
        preds = greedy_eval(final, batch_size=MAIN_BATCH, device=None if dev_flag == [] else "cpu")
        n_test = len(trainer.train_ds.splits["test"])
        print(f"train final checkpoint -> greedy_eval: {len(preds)} of {n_test} test clips, "
              f"e.g. {next(iter(preds.items()), None)}", flush=True)
        if len(preds) != n_test or not all(isinstance(c, str) and c for c in preds.values()):
            raise SystemExit(f"the final checkpoint decoded to missing or empty captions: {preds}")

        # Kernel route against plain route, full width, one batch, f32.
        batch = next(trainer.train_ds.batches(MAIN_BATCH, epoch=0))
        dev_batch = trainer._put(batch, "train")
        k_loss, k_grads = _grads(trainer.model, dev_batch)
        with plain_fused_kernels():
            p_loss, p_grads = _grads(trainer.model, dev_batch)
        worst, worst_key = 0.0, None
        for key, pg in p_grads.items():
            excess = ((k_grads[key] - pg).abs() - GRAD_TOL * (1 + pg.abs())).max().item()
            if worst_key is None or excess > worst:
                worst, worst_key = excess, key
        max_err = max((k_grads[k] - p_grads[k]).abs().max().item() for k in p_grads)
        print(f"train kernel route vs plain route (B={MAIN_BATCH} f32): loss {k_loss:.6f} vs "
              f"{p_loss:.6f}; max |dgrad| {max_err:.3e} over {len(p_grads)} parameters "
              f"(bound {GRAD_TOL:g} + {GRAD_TOL:g}*|g|; closest to it: {worst_key}) [{card}]",
              flush=True)
        if abs(k_loss - p_loss) > LOSS_TOL or worst > 0:
            raise SystemExit(f"kernel route disagrees with the plain route: loss {k_loss} vs "
                             f"{p_loss}, gradient {worst_key} over its bound by {worst}")

        # Train-step times: forward, loss, backward, AdamW.
        gen = torch.Generator().manual_seed(seed + 2)
        for dtype in ("float32", "bfloat16"):
            tr = Trainer(trainer.opt.replace(compute_dtype=dtype, resume_path=""),
                         device=trainer.device)
            for B in batches:
                args = _random_batch(torch, B, length, feat, trainer.train_ds.vocab_size,
                                     device, gen)
                for _ in range(2):
                    tr.train_step(*args)
                secs = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    tr.train_step(*args).item()
                    sync()
                    secs.append(time.perf_counter() - t0)
                med = sorted(secs)[len(secs) // 2]
                print(f"train step V={tr.vocab_size} B={B} {dtype}: {med * 1e3:.3f} ms "
                      f"(median of {reps}), {B / med:.1f} clips/s [{card}]", flush=True)
                if device.type == "cuda":
                    profile_call(torch, lambda: tr.train_step(*args), med * 1e3,
                                 f"train step B={B} {dtype}", card)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    # 1. device + build
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    from s2vt_tpu_torch.ops import _build, fused_s2vt
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    print(f"built {', '.join(_build.library_path(k).name for k in KERNELS)} from "
          f"s2vt_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s, in parallel "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    for name in KERNELS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
    if not fused_s2vt.fused_shapes_ok(H, 1, "lstm", device):
        raise SystemExit("fused_shapes_ok refuses the MSVD width on this card")

    # 2. kernels against their plain versions
    errors, times = phase_kernels(torch, device, H, LENGTH, KERNEL_BATCHES, TIMED_BATCHES,
                                  reps=20, card=card)

    # 3. the serving slice
    phase_slice(torch, device, args.seed, H, FEAT, LENGTH, VOCAB, n_videos=96,
                batches=TIMED_BATCHES, reps=5, card=card)

    # 4. the training slice: the main path
    launches = phase_train(torch, device, args.seed, H, FEAT, LENGTH, VOCAB, TRAIN_CLIPS,
                           TRAIN_EPOCHS, batches=TIMED_BATCHES, reps=5, card=card)

    rows = []
    for name, replaces in zip(KERNELS, ("s2vt_tpu/ops/pallas_s2vt.py:118",
                                        "s2vt_tpu/ops/pallas_s2vt.py:238")):
        t = times[(name, MAIN_BATCH, "float32")]
        rows.append({"name": name, "route": "cuda", "source": f"s2vt_tpu_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errors[(name, MAIN_BATCH, "float32")], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"], "ok": True})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
