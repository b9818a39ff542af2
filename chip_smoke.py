#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2vt_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases; a failure in any of them exits non-zero before the result line:
  1. device   the card's name and power limit; build every CUDA kernel of the
              port from s2vt_tpu_torch/csrc with nvcc (sm_90a).
  2. kernels  each kernel against its plain PyTorch version at the MSVD width
              (H = 512, T = 2L - 1 = 159) for B in {1, 16, 96, 200} in float32
              and bf16; kernel, plain and library times beside the bound.
  3. slice    greedy_eval -> model_from_checkpoint on a corpus and a
              checkpoint made from --seed at H = E = 512, F = 4096, L = 80
              (the main path; the kernel launch counts are read around it),
              then S2VT.greedy at V = 10240, B in {16, 96}, float32 and bf16,
              against the same model with the plain fused forward.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

H = E = 512            # MSVD width (bench.py:56)
FEAT = 4096
LENGTH = 80            # T = 2L - 1 = 159
VOCAB = 10240
KERNEL_BATCHES = (1, 16, 96, 200)
TIMED_BATCHES = (16, 96)
MAIN_BATCH = 16        # greedy_eval batch of the main-path run
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
ROW_MATCH_MIN_F32 = 0.99

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


def library_lstm_ms(torch, B, T, hid, emb, dtype, device, reps) -> float:
    """Two cuDNN nn.LSTM calls, vid then word on [x2 part | out1], at the
    fused forward's shapes. A yardstick only: the port never calls it."""
    lstm1 = torch.nn.LSTM(hid, hid, batch_first=True).to(device, dtype)
    lstm2 = torch.nn.LSTM(emb + hid, hid, batch_first=True).to(device, dtype)
    for lstm in (lstm1, lstm2):
        lstm.flatten_parameters()   # one contiguous weight buffer, as cuDNN wants
    x = torch.randn(B, T, hid, device=device, dtype=dtype)
    x2 = torch.zeros(B, T, emb, device=device, dtype=dtype)

    def run():
        out1, _ = lstm1(x)
        lstm2(torch.cat([x2, out1], dim=-1))

    with torch.no_grad():
        return cuda_ms(torch, run, reps)


@contextlib.contextmanager
def plain_fused_forward():
    """Route the fused forward to its plain PyTorch version, on any device."""
    from s2vt_tpu_torch.ops import fused_s2vt
    kernel = fused_s2vt.fused_s2vt_fwd
    fused_s2vt.fused_s2vt_fwd = fused_s2vt.fused_s2vt_fwd_reference
    try:
        yield
    finally:
        fused_s2vt.fused_s2vt_fwd = kernel


def phase_kernels(torch, device, hid, length, batches, timed, reps, card):
    """Kernel against plain at every batch and dtype; times at ``timed``."""
    from s2vt_tpu_torch.ops import fused_s2vt
    T = 2 * length - 1
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(1234)
    errors, times = {}, {}
    for B in batches:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            args = fused_inputs(torch, B, T, hid, dtype, device, gen)
            snap = length - 1
            got = fused_s2vt.fused_s2vt_fwd(*args, snap)
            sync()
            want = fused_s2vt.fused_s2vt_fwd_reference(*args, snap)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            finite = all(torch.isfinite(g.float()).all().item() for g in got)
            ok = finite and err <= ATOL[name]
            errors[(B, name)] = err
            print(f"kernel fused_s2vt_fwd B={B} {name} H={hid} T={T}: max_abs_err={err:.3e} "
                  f"(bound {ATOL[name]:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"fused_s2vt_fwd disagrees with its plain version at "
                                 f"B={B} {name}: max_abs_err={err}")
            if B in timed:
                k_ms = cuda_ms(torch, lambda: fused_s2vt.fused_s2vt_fwd(*args, snap), reps)
                p_ms = cuda_ms(torch, lambda: fused_s2vt.fused_s2vt_fwd_reference(*args, snap),
                               max(1, reps // 5), warmup=1)
                lib_ms = library_lstm_ms(torch, B, T, hid, hid, dtype, device, reps)
                bound, bound_by, nbytes, flops = fused_bound_ms(B, T, hid, name)
                times[(B, name)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                        bound_ms=bound, bound_by=bound_by)
                print(f"time fused_s2vt_fwd B={B} {name}: kernel_ms={k_ms:.4f} "
                      f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                      f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                      f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)
    return errors, times


def profile_request(torch, model, feats, request_ms, label, card):
    """One greedy request under torch.profiler: device busy time (sum of the
    kernels' own device time) and the fused kernel's part. The idle share is
    taken against ``request_ms``, the unprofiled request time, since the
    profiler slows the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.greedy(feats)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    fused_ms = sum(e.self_device_time_total for e in kernels
                   if "s2vt_fused_fwd_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    print(f"profile {label}: request_ms={request_ms:.3f} (profiled {wall_ms:.3f}) "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / request_ms:.4f} "
          f"fused_s2vt_fwd_ms={fused_ms:.3f} "
          f"launches={sum(e.count for e in kernels)} top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top) + f" [{card}]", flush=True)


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
    from s2vt_tpu_torch.ops import fused_s2vt

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"   # None: the entry points' default
    with tempfile.TemporaryDirectory() as root:
        meta = make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=200,
                                     feat_len=length, feat_dim=feat, seed=seed)
        opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
                  train_length=length, dim_hidden=hid, dim_embed=hid, feat_dim=feat,
                  use_pallas=True, seed=seed)
        ckpt = make_checkpoint(torch, root, seed, opt, meta["vocab_size"])

        fused_s2vt.fused_s2vt_fwd.launches = 0
        t0 = time.perf_counter()
        preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
        sync()
        wall = time.perf_counter() - t0
        launches = fused_s2vt.fused_s2vt_fwd.launches
        with plain_fused_forward():
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
            with plain_fused_forward():
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
            with plain_fused_forward():
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
                profile_request(torch, model, feats, med * 1e3, f"S2VT.greedy B={B} {name}",
                                card)
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
    fused_s2vt._kernel_lib()
    print(f"built {_build.library_path('fused_s2vt_fwd').name} from "
          f"s2vt_tpu_torch/csrc/fused_s2vt_fwd.cu in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    for line in _build.build_logs.get("fused_s2vt_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    if not fused_s2vt.fused_shapes_ok(H, 1, "lstm", device):
        raise SystemExit("fused_shapes_ok refuses the MSVD width on this card")

    # 2. kernels against their plain versions
    errors, times = phase_kernels(torch, device, H, LENGTH, KERNEL_BATCHES, TIMED_BATCHES,
                                  reps=20, card=card)

    # 3. the slice
    launches = phase_slice(torch, device, args.seed, H, FEAT, LENGTH, VOCAB, n_videos=96,
                              batches=TIMED_BATCHES, reps=5, card=card)

    main_t = times[(MAIN_BATCH, "float32")]
    print(json.dumps({"kernels": [{
        "name": "fused_s2vt_fwd", "route": "cuda",
        "source": "s2vt_tpu_torch/csrc/fused_s2vt_fwd.cu",
        "replaces": "s2vt_tpu/ops/pallas_s2vt.py:118",
        "launches": launches, "max_abs_err": errors[(MAIN_BATCH, "float32")],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"], "ok": True}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
