#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2vt_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases; a failure in any of them exits non-zero before the result line:
  1. device   the card's name and power limit; build every CUDA kernel of the
              port from s2vt_tpu_torch/csrc with nvcc (sm_90a), one nvcc per
              source, all started together.
  2. kernels  each kernel against its plain PyTorch version at the MSVD width
              (H = 512) for B in {1, 16, 96, 200} in float32 and bf16: the
              fused kernels at T = 2L - 1 = 159, the per-layer sequence
              kernels at T = L = 80 (beam encode) and T = 159 (training);
              kernel, plain and library (cuDNN nn.LSTM) times beside the bound.
  3. slice    greedy_eval -> model_from_checkpoint on a corpus and a
              checkpoint made from --seed at H = E = 512, F = 4096, L = 80
              (the serving path; the kernel launch counts are read around it),
              then S2VT.greedy at V = 10240, B in {16, 96}, float32 and bf16,
              against the same model with the plain kernels.
  4. train    s2vt_tpu_torch.cli.train -> Trainer.fit on a corpus made from
              --seed at H = E = 512, F = 4096, L = 80, V = 10240, B = 16 (the
              main path; launch counts read around it), its final checkpoint
              through greedy_eval, the kernel route's gradients against the
              plain route's, and train-step times at B in {16, 96}, float32
              and bf16.
  5. beam     beam_eval -> model_from_checkpoint on the corpus and checkpoint
              of phase 3 at B = 16, width 3, depth 30 (the beam slice's main
              path; launch counts read around it) against the plain route,
              then S2VT.beam at V = 10240, B in {16, 96}, float32 and bf16.
  6. train2   phase 4 with --num_layers 2: each layer of both RNNs runs the
              per-layer sequence kernels; one timed train step at B = 16.

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
# The sequence kernels store every value in float32 and round only product
# operands to bf16: a flipped rounding shows (7.1e-4 measured), a value stored
# in bf16 would be off by about one bf16 ulp of it (~4e-3 at |v| ~ 1).
SEQ_ATOL = {"float32": 1e-4, "bfloat16": 1.5e-3}
ROW_MATCH_MIN_F32 = 0.99
GRAD_TOL = 2e-3        # kernel vs plain route gradients, f32 (tests/test_pallas_s2vt.py:122)
LOSS_TOL = 1e-4        # kernel vs plain route loss, f32 (fused logits, test_pallas_s2vt.py:103)
TRAIN_CLIPS = 128      # corpus clips: 64 train (4 steps of 16), 32 valid, 32 test
TRAIN_EPOCHS = 2
SERVE_CLIPS = 96       # serving corpus: 24 test clips, 2 requests of 16
BEAM_WIDTH, BEAM_DEPTH = 3, 30   # Opt.beam_width, Opt.max_beam_depth
KERNELS = ("fused_s2vt_fwd", "fused_s2vt_bwd", "lstm_seq_fwd", "lstm_seq_bwd")
MODULES = {"fused_s2vt_fwd": "fused_s2vt", "fused_s2vt_bwd": "fused_s2vt",
           "lstm_seq_fwd": "fused_rnn", "lstm_seq_bwd": "fused_rnn"}
# The device symbol of each kernel, as torch.profiler names it.
SYMBOLS = {"fused_s2vt_fwd": "s2vt_fused_fwd_kernel", "fused_s2vt_bwd": "s2vt_fused_bwd_kernel",
           "lstm_seq_fwd": "lstm_seq_fwd_kernel", "lstm_seq_bwd": "lstm_seq_bwd_kernel"}
REPLACES = {"fused_s2vt_fwd": "s2vt_tpu/ops/pallas_s2vt.py:118",
            "fused_s2vt_bwd": "s2vt_tpu/ops/pallas_s2vt.py:238",
            "lstm_seq_fwd": "s2vt_tpu/ops/pallas_rnn.py:80",
            "lstm_seq_bwd": "s2vt_tpu/ops/pallas_rnn.py:175"}

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


def seq_fwd_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the per-layer forward: x_proj [T, B, 4H], W_hh and
    h0, c0 read once; the h, gate and c sequences and hT, cT written once,
    all float32; against the 2*T*B*4H*H operations of the recurrent product
    at the peak rate of its operand type (bf16 operands in bf16 mode)."""
    G = 4 * hid
    nbytes = 4 * (T * B * G + G * hid + 2 * B * hid            # x_proj, W_hh, h0, c0
                  + T * B * G + 2 * T * B * hid + 2 * B * hid)  # gates; h, c seqs; hT, cT
    return _bound(nbytes, 2 * T * B * G * hid, dtype_name)


def seq_bwd_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the per-layer backward: gates [T, B, 4H], c, c_prev and
    dout [T, B, H], W_hh, dhT and dcT read once; dxp [T, B, 4H], dh0 and dc0
    written once, all float32; against the 2*T*B*4H*H operations of
    dgates @ W_hh at the peak rate of its operand type."""
    G = 4 * hid
    nbytes = 4 * (T * B * G + 3 * T * B * hid + G * hid + 2 * B * hid   # inputs
                  + T * B * G + 2 * B * hid)                          # dxp, dh0, dc0
    return _bound(nbytes, 2 * T * B * G * hid, dtype_name)


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


def cudnn_lstm(torch, in_size, hid, dtype, device):
    """One nn.LSTM layer made on the card in its dtype, with its weights in
    one buffer as cuDNN wants. flatten_parameters() leaves bf16 weights apart
    (bf16 is not in torch.backends.cudnn.CUDNN_TENSOR_DTYPES) although cuDNN
    runs bf16 LSTMs and then warns that the weights are not contiguous; bf16
    is admitted for the call. A yardstick only: the port never calls it."""
    lstm = torch.nn.LSTM(in_size, hid, batch_first=True, device=device, dtype=dtype)
    accepted = torch.backends.cudnn.CUDNN_TENSOR_DTYPES
    added = dtype not in accepted
    accepted.add(dtype)
    try:
        lstm.flatten_parameters()
    finally:
        if added:
            accepted.discard(dtype)
    if len({w.untyped_storage().data_ptr() for w in lstm._flat_weights}) != 1:
        raise SystemExit(f"cuDNN yardstick: {dtype} LSTM weights are not one buffer")
    return lstm


def cudnn_lstms(torch, hid, emb, dtype, device):
    """The vid and word nn.LSTM at the fused kernels' shapes."""
    return (cudnn_lstm(torch, hid, hid, dtype, device),
            cudnn_lstm(torch, emb + hid, hid, dtype, device))


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


def library_seq_ms(torch, B, T, hid, dtype, device, reps):
    """One cuDNN nn.LSTM layer at the sequence kernels' shapes (input width
    H): (forward ms with autograd off, forward + backward less forward ms).
    cuDNN's forward also forms the input projection, and its backward the
    weight and input gradients."""
    lstm = cudnn_lstm(torch, hid, hid, dtype, device)
    x = torch.randn(B, T, hid, device=device, dtype=dtype, requires_grad=True)
    dout = torch.randn(B, T, hid, device=device, dtype=dtype)
    label = f"cuDNN LSTM layer B={B} T={T} {dtype}"
    with torch.no_grad():
        fwd = cuda_ms_quiet(torch, lambda: lstm(x), reps, label)
    both = cuda_ms_quiet(torch, lambda: lstm(x)[0].backward(dout), reps, label)
    return fwd, both - cuda_ms_quiet(torch, lambda: lstm(x), reps, label)


def _module(name: str):
    import importlib
    return importlib.import_module(f"s2vt_tpu_torch.ops.{MODULES[name]}")


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain PyTorch version, on any device."""
    kernels = {name: getattr(_module(name), name) for name in KERNELS}
    for name in KERNELS:
        setattr(_module(name), name, getattr(_module(name), name + "_reference"))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(_module(name), name, fn)


def reset_launches():
    for name in KERNELS:
        getattr(_module(name), name).launches = 0


def read_launches() -> dict:
    return {name: getattr(_module(name), name).launches for name in KERNELS}


def _check(torch, kernel, B, name, hid, T, got, want, errors, atol=ATOL):
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    finite = all(torch.isfinite(g.float()).all().item() for g in got)
    ok = finite and err <= atol[name]
    errors[(kernel, B, name, T)] = err
    print(f"kernel {kernel} B={B} {name} H={hid} T={T}: max_abs_err={err:.3e} "
          f"(bound {atol[name]:.1e}; max |output| {scale:.3g}) {'ok' if ok else 'FAIL'}",
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
            times[("fused_s2vt_fwd", B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
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
            times[("fused_s2vt_bwd", B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                      bound_ms=bound, bound_by=bound_by,
                                                      with_dw_ms=kdw_ms)
            print(f"time fused_s2vt_bwd B={B} {name}: kernel_ms={k_ms:.4f} "
                  f"kernel_plus_3dW_ms={kdw_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_bwd_ms={lib_ms:.4f} (cuDNN fwd+bwd less fwd) bound_ms={bound:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                  f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)
    return errors, times


def seq_inputs(torch, B, T, hid, device, gen):
    """(x_proj_t [T, B, 4H], w_hh [4H, H], h0, c0 [B, H]), float32."""
    k = 1.0 / math.sqrt(hid)
    x = torch.randn(T, B, 4 * hid, device=device, generator=gen)
    w_hh = (torch.rand(4 * hid, hid, device=device, generator=gen) * 2 - 1) * k
    h0, c0 = (0.5 * torch.randn(B, hid, device=device, generator=gen) for _ in range(2))
    return [x, w_hh, h0, c0]


def phase_seq_kernels(torch, device, hid, seq_lens, batches, timed, reps, card):
    """The per-layer sequence kernels against their plain versions at every
    T, batch and mode (float32, and bf16 product operands); times at
    ``timed``. The backward's inputs come from the forward kernel's run, so
    its gates and c are real LSTM states."""
    from s2vt_tpu_torch.ops import fused_rnn as fr
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(4321)
    errors, times = {}, {}
    for T in seq_lens:
        for B in batches:
            for name in ("float32", "bfloat16"):
                bf16 = name == "bfloat16"
                args = seq_inputs(torch, B, T, hid, device, gen)
                got = fr.lstm_seq_fwd(*args, bf16)
                sync()
                _check(torch, "lstm_seq_fwd", B, name, hid, T, got,
                       fr.lstm_seq_fwd_reference(*args, bf16), errors, SEQ_ATOL)
                outs, gates, cseq = got[:3]
                cprev = torch.cat([args[3][None], cseq[:-1]])
                bargs = (gates, cseq, cprev, args[1], *(torch.randn(
                    s, device=device, generator=gen) for s in ((T, B, hid), (B, hid), (B, hid))))
                dxp = fr.lstm_seq_bwd(*bargs, bf16)
                sync()
                _check(torch, "lstm_seq_bwd", B, name, hid, T, dxp,
                       fr.lstm_seq_bwd_reference(*bargs, bf16), errors, SEQ_ATOL)
                if B not in timed:
                    continue
                dtype = torch.bfloat16 if bf16 else torch.float32
                lib_fwd, lib_bwd = library_seq_ms(torch, B, T, hid, dtype, device, reps)
                hprev = torch.cat([args[2][None], outs[:-1]])

                def bwd_and_dw():
                    d = fr.lstm_seq_bwd(*bargs, bf16)[0]
                    hprev.reshape(-1, hid).T @ d.reshape(-1, 4 * hid)

                for kernel, fn, ref, fargs, bound_fn, lib in (
                        ("lstm_seq_fwd", fr.lstm_seq_fwd, fr.lstm_seq_fwd_reference, args,
                         seq_fwd_bound_ms, lib_fwd),
                        ("lstm_seq_bwd", fr.lstm_seq_bwd, fr.lstm_seq_bwd_reference, bargs,
                         seq_bwd_bound_ms, lib_bwd)):
                    k_ms = cuda_ms(torch, lambda: fn(*fargs, bf16), reps)
                    p_ms = cuda_ms(torch, lambda: ref(*fargs, bf16), max(1, reps // 5), warmup=1)
                    bound, bound_by, nbytes, flops = bound_fn(B, T, hid, name)
                    extra = {}
                    if kernel == "lstm_seq_bwd":
                        extra["with_dw_ms"] = cuda_ms(torch, bwd_and_dw, reps)
                    times[(kernel, B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib,
                                                       bound_ms=bound, bound_by=bound_by, **extra)
                    print(f"time {kernel} B={B} T={T} {name}: kernel_ms={k_ms:.4f} "
                          + "".join(f"kernel_plus_dW_ms={v:.4f} " for v in extra.values())
                          + f"plain_ms={p_ms:.4f} library_ms={lib:.4f} "
                          f"({'cuDNN fwd+bwd less fwd' if extra else 'cuDNN fwd'}) "
                          f"bound_ms={bound:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
                          f"{flops / 1e9:.2f} GFLOP) bound_share={bound / k_ms:.4f} [{card}]",
                          flush=True)
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
    own = {k: sum(e.self_device_time_total for e in kernels if SYMBOLS[k] in e.key) / 1e3
           for k in KERNELS}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower() or "xmma" in e.key) / 1e3
    print(f"profile {label}: wall_ms={wall_ms:.3f} (profiled {prof_ms:.3f}) "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.4f} "
          + " ".join(f"{k}_ms={v:.3f} ({v / max(busy_ms, 1e-9):.4f} of busy)"
                     for k, v in own.items() if v > 0)
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


def serving_checkpoint(torch, root, seed, hid, feat, length, n_videos) -> str:
    """A corpus of ``n_videos`` clips and a checkpoint of random weights, both
    made from ``seed``, for the serving phases; returns the checkpoint path."""
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    meta = make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=200,
                                 feat_len=length, feat_dim=feat, seed=seed)
    opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
              train_length=length, dim_hidden=hid, dim_embed=hid, feat_dim=feat,
              use_pallas=True, seed=seed)
    return make_checkpoint(torch, root, seed, opt, meta["vocab_size"])


def median_s(fn, reps, sync) -> float:
    """Median host seconds of ``reps`` calls of ``fn``, each synchronised."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return sorted(secs)[len(secs) // 2]


def phase_slice(torch, device, ckpt, seed, hid, feat, length, vocab, batches, reps, card):
    """The main path through greedy_eval, then S2VT.greedy kernel vs plain.
    Returns the kernel's launches in the main-path run."""
    from s2vt_tpu_torch.evaluation.decode import greedy_eval
    from s2vt_tpu_torch.models import S2VT

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"   # None: the entry points' default
    reset_launches()
    t0 = time.perf_counter()
    preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()["fused_s2vt_fwd"]
    with plain_kernels():
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
            with plain_kernels():
                plain = model.greedy(feats)
            sync()
            if tokens.shape != (B, length - 1) or not ((tokens >= 0) & (tokens < vocab)).all():
                raise SystemExit(f"greedy tokens malformed: {tuple(tokens.shape)}")
            rows = (tokens == plain).all(dim=1).float().mean().item()
            med = median_s(lambda: model.greedy(feats), reps, sync)
            with plain_kernels():
                plain_s = median_s(lambda: model.greedy(feats), 1, sync)
            print(f"slice S2VT.greedy V={vocab} B={B} {name}: rows equal to the plain route "
                  f"{rows:.4f}, {B / med:.1f} clips/s ({med * 1e3:.3f} ms per request, median "
                  f"of {reps}; plain route {B / plain_s:.1f} clips/s) [{card}]", flush=True)
            if name == "float32" and rows < ROW_MATCH_MIN_F32:
                raise SystemExit(f"float32 greedy rows equal to the plain route: {rows:.4f}")
            if device.type == "cuda" and B == MAIN_BATCH:
                profile_call(torch, lambda: model.greedy(feats), med * 1e3,
                             f"S2VT.greedy B={B} {name}", card)
    return launches


def phase_beam(torch, device, ckpt, seed, hid, feat, length, vocab, batches, reps, card):
    """The beam slice's main path: beam_eval over the serving checkpoint's
    test split, launch counts read around it, sentences against the plain
    route; then S2VT.beam kernel vs plain and its request times. Returns the
    sequence forward kernel's launches in the main-path run."""
    from s2vt_tpu_torch.evaluation.decode import beam_eval
    from s2vt_tpu_torch.models import S2VT

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"   # None: the entry points' default
    kw = dict(batch_size=MAIN_BATCH, beam_width=BEAM_WIDTH, max_beam_depth=BEAM_DEPTH,
              device=dev_arg)
    reset_launches()
    t0 = time.perf_counter()
    preds = beam_eval(ckpt, **kw)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    with plain_kernels():
        plain_preds = beam_eval(ckpt, **kw)
    n_batches = -(-len(preds) // MAIN_BATCH)
    same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
    print(f"beam beam_eval: {len(preds)} clips in {n_batches} requests of B={MAIN_BATCH}, "
          f"W={BEAM_WIDTH} D={BEAM_DEPTH}, {wall:.3f} s wall, launches={launches}, sentences "
          f"equal to the plain route: {same:.4f}, e.g. {next(iter(preds.items()), None)} "
          f"[{card}]", flush=True)
    if launches["lstm_seq_fwd"] != 2 * n_batches:
        raise SystemExit(f"the beam path launched lstm_seq_fwd {launches['lstm_seq_fwd']} times "
                         f"for {n_batches} requests (2 per request: vid_rnn, word_rnn)")
    if not preds or not all(isinstance(s, str) and s for s in preds.values()):
        raise SystemExit(f"beam_eval returned no or empty captions: {preds}")
    if same < ROW_MATCH_MIN_F32:
        raise SystemExit(f"beam_eval sentences differ from the plain route: {same:.4f}")

    gen = torch.Generator().manual_seed(seed + 3)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        model = S2VT(vocab, feat, length, hid, hid, use_pallas=True, compute_dtype=(
            None if dtype == torch.float32 else dtype), sos_ix=3, eos_ix=4)
        model.reset_parameters(gen)
        model = model.to(device).eval()
        for B in batches:
            feats = torch.randn(B, length, feat, generator=gen).to(device)
            res = model.beam(feats, BEAM_WIDTH, BEAM_DEPTH)
            with plain_kernels():
                plain = model.beam(feats, BEAM_WIDTH, BEAM_DEPTH)
            sync()
            if (tuple(res.tokens.shape) != (B, BEAM_WIDTH, BEAM_DEPTH + 1)
                    or not torch.isfinite(res.scores).all()
                    or not ((res.tokens >= 0) & (res.tokens < vocab)).all()):
                raise SystemExit(f"beam result malformed: {tuple(res.tokens.shape)}")
            rows = (res.tokens[:, 0] == plain.tokens[:, 0]).all(dim=1).float().mean().item()
            med = median_s(lambda: model.beam(feats, BEAM_WIDTH, BEAM_DEPTH), reps, sync)
            with plain_kernels():
                plain_s = median_s(lambda: model.beam(feats, BEAM_WIDTH, BEAM_DEPTH), 1, sync)
            print(f"beam S2VT.beam V={vocab} B={B} W={BEAM_WIDTH} D={BEAM_DEPTH} {name}: best "
                  f"beams equal to the plain route {rows:.4f}, {B / med:.1f} clips/s "
                  f"({med * 1e3:.3f} ms per request, median of {reps}; plain route "
                  f"{B / plain_s:.1f} clips/s) [{card}]", flush=True)
            if name == "float32" and rows < ROW_MATCH_MIN_F32:
                raise SystemExit(f"float32 best beams equal to the plain route: {rows:.4f}")
            if device.type == "cuda" and B == MAIN_BATCH:
                profile_call(torch, lambda: model.beam(feats, BEAM_WIDTH, BEAM_DEPTH), med * 1e3,
                             f"S2VT.beam B={B} {name}", card)
    return launches["lstm_seq_fwd"]


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
                card, num_layers=1, dtypes=("float32", "bfloat16")):
    """The main path: s2vt_tpu_torch.cli.train's main -> Trainer.fit, with the
    launch counts read around it; its final checkpoint through greedy_eval;
    the kernel route's loss and gradients against the plain route's; then
    train-step times. One layer runs the fused kernels, once per step each
    way; more layers run the per-layer sequence kernels, once per layer of
    each RNN each way. Returns the launches of the main-path run."""
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
            "--num_layers", str(num_layers),
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
              f"L={length} layers={num_layers} B={MAIN_BATCH} f32, {epochs} epochs of "
              f"{n_train} clips ({train_steps} train steps, {valid_steps} valid steps) in "
              f"{wall:.3f} s; "
              f"train_loss={hist['train_loss']} valid_loss={hist['valid_loss']} "
              f"launches={launches} bank={trainer.use_feature_bank} [{card}]", flush=True)
        fwd, bwd, per_step = (("fused_s2vt_fwd", "fused_s2vt_bwd", 1) if num_layers == 1 else
                              ("lstm_seq_fwd", "lstm_seq_bwd", 2 * num_layers))
        if launches[bwd] != per_step * train_steps:
            raise SystemExit(f"the training path launched {bwd} {launches[bwd]} times for "
                             f"{train_steps} train steps ({per_step} per step)")
        if launches[fwd] < per_step * (train_steps + valid_steps):
            raise SystemExit(f"the training path launched {fwd} {launches[fwd]} times for "
                             f"{train_steps + valid_steps} steps ({per_step} per step)")
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
        with plain_kernels():
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
        for dtype in dtypes:
            tr = Trainer(trainer.opt.replace(compute_dtype=dtype, resume_path=""),
                         device=trainer.device)
            for B in batches:
                args = _random_batch(torch, B, length, feat, trainer.train_ds.vocab_size,
                                     device, gen)
                for _ in range(2):
                    tr.train_step(*args)
                med = median_s(lambda: tr.train_step(*args).item(), reps, sync)
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
    from s2vt_tpu_torch.ops import _build, fused_rnn, fused_s2vt
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    print(f"built {', '.join(_build.library_path(k).name for k in KERNELS)} from "
          f"s2vt_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s, in parallel "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    for name in KERNELS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "stack" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
    if not fused_s2vt.fused_shapes_ok(H, 1, "lstm", device):
        raise SystemExit("fused_shapes_ok refuses the MSVD width on this card")
    if not fused_rnn.lstm_seq_shapes_ok(H, device):
        raise SystemExit("lstm_seq_shapes_ok refuses the MSVD width on this card")

    # 2. kernels against their plain versions
    errors, times = phase_kernels(torch, device, H, LENGTH, KERNEL_BATCHES, TIMED_BATCHES,
                                  reps=20, card=card)
    seq_errors, seq_times = phase_seq_kernels(torch, device, H, (LENGTH, 2 * LENGTH - 1),
                                              KERNEL_BATCHES, TIMED_BATCHES, reps=20, card=card)
    errors.update(seq_errors)
    times.update(seq_times)

    with tempfile.TemporaryDirectory() as root:
        ckpt = serving_checkpoint(torch, root, args.seed, H, FEAT, LENGTH, SERVE_CLIPS)
        # 3. the serving slice
        phase_slice(torch, device, ckpt, args.seed, H, FEAT, LENGTH, VOCAB,
                    batches=TIMED_BATCHES, reps=5, card=card)
        # 5. the beam slice: its main path
        beam_launches = phase_beam(torch, device, ckpt, args.seed, H, FEAT, LENGTH, VOCAB,
                                   batches=TIMED_BATCHES, reps=5, card=card)

    # 4. the training slice: the main path
    launches = phase_train(torch, device, args.seed, H, FEAT, LENGTH, VOCAB, TRAIN_CLIPS,
                           TRAIN_EPOCHS, batches=TIMED_BATCHES, reps=5, card=card)
    # 6. two-layer training: the backward sequence kernel's main path
    launches2 = phase_train(torch, device, args.seed, H, FEAT, LENGTH, VOCAB, TRAIN_CLIPS,
                            TRAIN_EPOCHS, batches=(MAIN_BATCH,), reps=5, card=card,
                            num_layers=2, dtypes=("float32",))

    # Each kernel's launches on its slice's main path; times at B = 16, f32,
    # at the T of that path.
    main_path = {"fused_s2vt_fwd": (launches, 2 * LENGTH - 1),
                 "fused_s2vt_bwd": (launches, 2 * LENGTH - 1),
                 "lstm_seq_fwd": ({"lstm_seq_fwd": beam_launches}, LENGTH),
                 "lstm_seq_bwd": (launches2, 2 * LENGTH - 1)}
    rows = []
    for name in KERNELS:
        counts, T = main_path[name]
        t = times[(name, MAIN_BATCH, "float32", T)]
        if counts[name] <= 0:
            raise SystemExit(f"{name} was not launched on its main path")
        rows.append({"name": name, "route": "cuda", "source": f"s2vt_tpu_torch/csrc/{name}.cu",
                     "replaces": REPLACES[name], "launches": counts[name],
                     "max_abs_err": errors[(name, MAIN_BATCH, "float32", T)], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"], "ok": True})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
