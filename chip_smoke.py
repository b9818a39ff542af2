#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2vt_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases; a failure in any of them exits non-zero before the result line:
  1. device   the card's name and power limit; build every CUDA kernel of the
              port from s2vt_tpu_torch/csrc with nvcc (sm_90a), one nvcc per
              source, all started together; each kernel's ptxas registers
              and spills.
  2. kernels  each kernel against its plain PyTorch version at the MSVD width
              (H = 512) for B in {1, 16, 96, 200} in float32 and bf16: the
              fused kernels at T = 2L - 1 = 159, the per-layer LSTM and GRU
              sequence kernels at T = L = 80 (beam encode) and T = 159
              (training); kernel, plain and library (cuDNN nn.LSTM / nn.GRU)
              times beside the bound. The fused forward and backward, the
              LSTM forward and backward and the GRU forward and backward
              have two routes each (fused_s2vt_fwd_route,
              fused_s2vt_bwd_route, lstm_seq_fwd_route, gru_seq_fwd_route
              and gru_seq_bwd_route: "mma" or "direct"; lstm_seq_bwd_route:
              "cluster" in bf16, "direct"): each check call's route is
              printed and its launch held to it, the other route is checked
              on the same inputs (its launch held to it too) and timed beside
              the routed kernel, in turns (the fused backward's mma route
              takes bf16 alone, so its float32 shapes have one route). The
              attention-decoder loop (#7) likewise (att_decode_fwd_route:
              "mma", the context product folded into one tensor-core
              product ahead of the loop, or "direct"), at T = L - 1 = 79.
  3. slice    greedy_eval -> model_from_checkpoint on a corpus and a
              checkpoint made from --seed at H = E = 512, F = 4096, L = 80
              (the serving path; the kernel launch counts are read around it),
              then S2VT.greedy at V = 10240, B in {16, 96}, float32 and bf16,
              against the same model with the plain kernels.
  4. train    s2vt_tpu_torch.cli.train -> Trainer.fit on a corpus made from
              --seed at H = E = 512, F = 4096, L = 80, V = 10240, B = 16 (the
              main path; launch counts read around it), greedy_eval and
              beam_eval of its final checkpoint against the plain route, the
              kernel route's gradients against the plain route's, train-step
              times at B in {16, 96}, float32 and bf16 (every fused forward
              and backward launch of the timed steps held to its route), and
              greedy and beam times.
  5. beam     beam_eval -> model_from_checkpoint on the corpus and checkpoint
              of phase 3 at B = 16, width 3, depth 30 (the beam slice's main
              path; launch counts read around it, each LSTM forward launch
              held to the route its wrapper takes) against the plain route,
              then S2VT.beam at V = 10240, B in {16, 96}, float32 and bf16.
  6. train2   phase 4 with --num_layers 2: each layer of both RNNs runs the
              per-layer sequence kernels, every launch of them on the route
              its wrapper takes (float32 at B = 16); train-step times at
              B = 16 only, with each kernel's device time in the step.
  7. att      the attention baseline: cli.train --model att_baseline on the
              corpus of phase 4 (launch counts read around it: the
              attention-decoder kernel runs the no-gradient validation pass,
              the sequence kernels the bi-LSTM encoder, every launch of them
              on the route its wrapper takes; the timed no-gradient passes'
              #7 launches too, exact counts), greedy_eval and
              beam_eval of its final checkpoint against the plain route, the
              kernel routes against the plain routes on one batch, and
              teacher-forced, train-step, greedy and beam times.
  8. gru      GRU S2VT: cli.train --rnn_type gru on the corpus of phase 4
              (launch counts read around it: both RNNs run the GRU sequence
              kernels, forward in every train and validation step, backward
              in every train step; every forward and backward launch, here
              and in greedy_eval and beam_eval, on the route its wrapper
              takes),
              greedy_eval and beam_eval of its final
              checkpoint against the plain route, the kernel route's
              gradients against the plain route's, and train-step, greedy and
              beam times.

  9. serving  cli.export_serving of phase 3's checkpoint on the card: greedy
              artifacts with float32, bf16 and int8 features and a beam
              artifact at B = 16; ServingCaptioner.caption (launch counts read
              around each request: greedy runs the fused forward once and the
              out-projection-and-argmax kernel once per decode step, beam the
              sequence kernel twice, on its route) against S2VT.greedy /
              S2VT.beam on the
              kernel route; request times and decode_tokens_timed phases.
 10. extract  FeatureExtractor("vgg16_bn") and ("vgg16") over seeded uint8
              clips of 80 frames of 300 x 400 (one fused conv kernel launch per
              conv block, 13 per forward: 12 on its tensor-core "mma" route,
              the first layer on its "direct" route) against the plain route
              (F.conv2d, TF32 off), clips/s; then cli.caption's ClipCaptioner
              with the greedy artifact over the clips written as frame
              directories.
 11. score    the scoring slice: a learnable corpus (data/learnable.py) at
              MSVD feature shape, [80, 4096] float32, cut to 256/64/32 clips
              and 32/16/16 atoms; cli.train --metric_eval_freq 1 at H = E =
              512, B = 16, 3 epochs (launch counts read around it: the
              metric eval greedy-decodes the valid split from the feature
              bank, #1 once per request and #8 once per decode step);
              history["metrics"] (seven finite scores per epoch), the last
              eval's sentences and scores against the plain route;
              python -m s2vt_tpu_torch.cli.eval greedy and --beam on the
              final checkpoint in a process of its own, then cli.eval.main
              in this one with its launch counts held (#1 and #8 per greedy
              request, #3 twice per beam request), each against the plain
              route; score_predictions at MSVD's counts (450 clips, ~41
              references each) on the host, in all and stage by stage; the
              learning gate (tools/learning_gate.py) in float32 and bf16
              with use_pallas, and its shuffled-feature control; decode and
              scoring ms of each metric eval, the phase's seconds.

Phase 2 also checks the out-projection-and-argmax kernel at B in {1, 16, 96,
200} and two vocab sizes (in bf16 with a float32 W, direct route, and with a
bf16 W as greedy_pick hands it, mma route; each call's route printed and its
launch held to it), and the fused conv kernel at VGG16's 13 layer shapes
(N = 2; each layer's route likewise), and times them (B = 16 and 96 in both
modes, #8's direct route beside its mma route; N = 80) beside cuBLAS +
argmax and cuDNN. Phase 9 holds each greedy request's #8 launches to the
mma route.

Every launch count read is held exactly to what the path should launch
(s2vt_launches): each kernel where its slice says, and no other kernel; and
every launch of a routed recurrent kernel (the fused forward in phases 3, 4,
9, 10 and 11, the LSTM sequence kernels in phases 4-9, the GRU forward and
backward in phase 8, the attention-decoder loop in phase 7) to the route its
wrapper takes for that batch and mode.

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
KERNELS = ("fused_s2vt_fwd", "fused_s2vt_bwd", "lstm_seq_fwd", "lstm_seq_bwd",
           "att_decode_fwd", "gru_seq_fwd", "gru_seq_bwd", "argmax_linear", "conv3x3_bn_relu")
MODULES = {"fused_s2vt_fwd": "fused_s2vt", "fused_s2vt_bwd": "fused_s2vt",
           "lstm_seq_fwd": "fused_rnn", "lstm_seq_bwd": "fused_rnn",
           "att_decode_fwd": "fused_att_decode", "gru_seq_fwd": "fused_gru",
           "gru_seq_bwd": "fused_gru", "argmax_linear": "fused_decode",
           "conv3x3_bn_relu": "fused_conv"}
# The device symbol of each kernel, as torch.profiler names it.
SYMBOLS = {"fused_s2vt_fwd": "s2vt_fused_fwd_kernel", "fused_s2vt_bwd": "s2vt_fused_bwd_kernel",
           "lstm_seq_fwd": "lstm_seq_fwd_kernel", "lstm_seq_bwd": "lstm_seq_bwd_kernel",
           "att_decode_fwd": "att_decode_fwd_kernel", "gru_seq_fwd": "gru_seq_fwd_kernel",
           "gru_seq_bwd": "gru_seq_bwd_kernel", "argmax_linear": "argmax_linear_kernel",
           "conv3x3_bn_relu": "conv3x3_bn_relu_kernel"}
REPLACES = {"fused_s2vt_fwd": "s2vt_tpu/ops/pallas_s2vt.py:118",
            "fused_s2vt_bwd": "s2vt_tpu/ops/pallas_s2vt.py:238",
            "lstm_seq_fwd": "s2vt_tpu/ops/pallas_rnn.py:80",
            "lstm_seq_bwd": "s2vt_tpu/ops/pallas_rnn.py:175",
            "att_decode_fwd": "s2vt_tpu/ops/pallas_att_decode.py:114",
            "gru_seq_fwd": "s2vt_tpu/ops/pallas_gru.py:43",
            "gru_seq_bwd": "s2vt_tpu/ops/pallas_gru.py:124",
            "argmax_linear": "s2vt_tpu/ops/pallas_decode.py:69",
            "conv3x3_bn_relu": "s2vt_tpu/ops/pallas_conv.py:82"}
# Kernel #8 checks: batches and vocab sizes (one not a multiple of the
# 64-column tile); tokens must equal the plain version's on every row whose
# top two logits (float64) differ by more than ARGMAX_TIE_RTOL relative.
ARGMAX_VOCABS = (VOCAB, 10001)
ARGMAX_TIE_RTOL = 1e-5
# Kernel #9: VGG16's 13 conv layers at 224 x 224, (H = W, C, K); checked at
# CONV_CHECK_N frames, timed at N = LENGTH (one clip of 80 frames). Bounds
# as allclose's: |got - want| <= tol + tol * |want| (tests/test_pallas_conv.py).
VGG_LAYERS = ((224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256),
              (56, 256, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512), (28, 512, 512),
              (14, 512, 512), (14, 512, 512), (14, 512, 512))
CONV_CHECK_N = 2
EXTRACT_CLIPS = 4      # phase 10: seeded clips of [80, 300, 400, 3] uint8 frames
CLIP_SHAPE = (300, 400)
FEAT_RTOL = 1e-3       # extracted features, kernel vs plain route, relative to max |feature|
# The per-layer sequence ops: forward and backward kernel, gate blocks, cuDNN
# yardstick.
SEQ_CELLS = {"lstm": ("lstm_seq_fwd", "lstm_seq_bwd", 4, "LSTM"),
             "gru": ("gru_seq_fwd", "gru_seq_bwd", 3, "GRU")}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# Kernel #9's launches per VGG16 forward on each of its routes.
VGG_ROUTES = {"mma": 12, "direct": 1}
# The kernels with two routes, each counting its launches per route.
ROUTED = ("argmax_linear", "conv3x3_bn_relu", "lstm_seq_fwd", "lstm_seq_bwd", "fused_s2vt_fwd",
          "fused_s2vt_bwd", "gru_seq_fwd", "gru_seq_bwd", "att_decode_fwd")


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


def device_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: the card's own time in the kernels
    (and copies) it runs, summed by torch.profiler over ``reps`` calls. For
    calls shorter than their host-side launch cost, where CUDA events around
    back-to-back calls would time the host instead."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps


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
    """Least time for the per-layer forward on either route: x_proj [T, B, 4H],
    W_hh and h0, c0 read once; the h, gate and c sequences and hT, cT
    written once, all float32; against the 2*T*B*4H*H operations of the
    recurrent product at the peak rate of its operand type (bf16 operands
    in bf16 mode, on the tensor cores on the "mma" route). Float32 runs on
    the CUDA cores on both routes (the "mma" route forms its sums in the
    direct route's order), so both have the float32 peak's bound; a float32
    mma route as three TF32 passes (the variant tool's ``tf32x3``) would
    have 3 x the operations at the TF32 peak. Returns (ms, by, bytes, the
    2*T*B*4H*H operations)."""
    G = 4 * hid
    nbytes = 4 * (T * B * G + G * hid + 2 * B * hid            # x_proj, W_hh, h0, c0
                  + T * B * G + 2 * T * B * hid + 2 * B * hid)  # gates; h, c seqs; hT, cT
    return _bound(nbytes, 2 * T * B * G * hid, dtype_name)


def seq_bwd_bound_ms(B: int, T: int, hid: int, dtype_name: str, route: str = "direct"):
    """Least time for the per-layer backward: gates [T, B, 4H], c, c_prev and
    dout [T, B, H], W_hh, dhT and dcT read once; dxp [T, B, 4H], dh0 and dc0
    written once, all float32; against the 2*T*B*4H*H operations of
    dgates @ W_hh at the peak rate of its operand type, float32 on the
    "cluster" route (tensor cores) as three TF32 passes at the TF32 peak (as
    argmax_bound_ms). Returns (ms, by, bytes, the 2*T*B*4H*H operations)."""
    G = 4 * hid
    nbytes = 4 * (T * B * G + 3 * T * B * hid + G * hid + 2 * B * hid   # inputs
                  + T * B * G + 2 * B * hid)                          # dxp, dh0, dc0
    flops = 2 * T * B * G * hid
    if dtype_name == "float32" and route == "cluster":
        bound, by, _, _ = _bound(nbytes, 3 * flops, "tf32")
        return bound, by, nbytes, flops
    return _bound(nbytes, flops, dtype_name)


def gru_seq_fwd_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the GRU forward on either route: x_proj [T, B, 3H], W_hh,
    b_hh and h0 read once; the h, gate and gh_n sequences and hT written
    once, all float32; against the 2*T*B*3H*H operations of the recurrent
    product at the peak rate of its operand type (bf16 operands in bf16
    mode, on the tensor cores on the "mma" route). Float32 runs on the CUDA
    cores on both routes (the "mma" route forms its sums in the direct
    route's order), so both have the float32 peak's bound."""
    G = 3 * hid
    nbytes = 4 * (T * B * G + G * hid + G + B * hid             # x_proj, W_hh, b_hh, h0
                  + T * B * G + 2 * T * B * hid + B * hid)      # gates; h, gh_n seqs; hT
    return _bound(nbytes, 2 * T * B * G * hid, dtype_name)


def gru_seq_bwd_bound_ms(B: int, T: int, hid: int, dtype_name: str):
    """Least time for the GRU backward on either route: gates [T, B, 3H], gh_n,
    h_prev and dout [T, B, H], W_hh and dhT read once; dxp [T, B, 3H], dghn
    [T, B, H] and dh0 written once, all float32; against the 2*T*B*3H*H
    operations of the recurrent product at the peak rate of its operand type
    (bf16 operands in bf16 mode, on the tensor cores on the "mma" route).
    Float32 runs on the CUDA cores on both routes (the "mma" route forms its
    sums in the direct route's order), so both have the float32 peak's
    bound."""
    G = 3 * hid
    nbytes = 4 * (T * B * G + 3 * T * B * hid + G * hid + B * hid    # inputs
                  + T * B * G + T * B * hid + B * hid)               # dxp, dghn, dh0
    return _bound(nbytes, 2 * T * B * G * hid, dtype_name)


def att_decode_bound_ms(B: int, T: int, hid: int, L: int, dtype_name: str,
                        route: str = "direct"):
    """Least time for the attention-decoder loop: the weights (W_ctx, W_hh,
    W_att, b_att, w_apply), enc_wh, enc_out, xp and ctx0 read once and the h
    sequence written once, all float32; against, per step, the
    2*B*(2H*4H + H*4H + H*H) operations of the gate and dw products at the
    peak rate of their operand type, float32 on the "mma" route (tensor
    cores: P and the h products) as three TF32 passes at the TF32 peak (as
    seq_bwd_bound_ms's cluster route), plus the 8*B*L*H of the scores and
    the context at the float32 peak. Returns (ms, by, bytes, the function's
    operations)."""
    G = 4 * hid
    nbytes = 4 * (G * 3 * hid + hid * hid + 2 * hid            # weights
                  + B * L * 3 * hid + T * B * G + B * 2 * hid  # enc_wh, enc_out, xp, ctx0
                  + T * B * hid)                               # out
    products = 2 * T * B * (G * 3 * hid + hid * hid)
    attention = 8 * T * B * L * hid
    if dtype_name == "float32" and route == "mma":
        t_products = 3 * products / PEAK_FLOPS["tf32"]
    else:
        t_products = products / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (t_products + attention / PEAK_FLOPS["float32"]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes,
            products + attention)


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


def cudnn_rnn(torch, in_size, hid, dtype, device, cell="LSTM"):
    """One nn.LSTM (or nn.GRU) layer made on the card in its dtype, with its
    weights in one buffer as cuDNN wants. flatten_parameters() leaves bf16
    weights apart (bf16 is not in torch.backends.cudnn.CUDNN_TENSOR_DTYPES)
    although cuDNN runs bf16 RNNs and then warns that the weights are not
    contiguous; bf16 is admitted for the call. A yardstick only: the port
    never calls it."""
    rnn = getattr(torch.nn, cell)(in_size, hid, batch_first=True, device=device, dtype=dtype)
    accepted = torch.backends.cudnn.CUDNN_TENSOR_DTYPES
    added = dtype not in accepted
    accepted.add(dtype)
    try:
        rnn.flatten_parameters()
    finally:
        if added:
            accepted.discard(dtype)
    if len({w.untyped_storage().data_ptr() for w in rnn._flat_weights}) != 1:
        raise SystemExit(f"cuDNN yardstick: {dtype} {cell} weights are not one buffer")
    return rnn


def cudnn_lstms(torch, hid, emb, dtype, device):
    """The vid and word nn.LSTM at the fused kernels' shapes."""
    return (cudnn_rnn(torch, hid, hid, dtype, device),
            cudnn_rnn(torch, emb + hid, hid, dtype, device))


def cuda_ms_quiet(torch, fn, reps: int, label: str, warmup: int = 2) -> float:
    """``cuda_ms``, failing if the call raises any warning (a cuDNN RNN whose
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


def library_seq_ms(torch, B, T, hid, dtype, device, reps, cell="LSTM"):
    """One cuDNN nn.LSTM (or nn.GRU) layer at the sequence kernels' shapes
    (input width H): (forward ms with autograd off, forward + backward less
    forward ms). cuDNN's forward also forms the input projection, and its
    backward the weight and input gradients."""
    rnn = cudnn_rnn(torch, hid, hid, dtype, device, cell)
    x = torch.randn(B, T, hid, device=device, dtype=dtype, requires_grad=True)
    dout = torch.randn(B, T, hid, device=device, dtype=dtype)
    label = f"cuDNN {cell} layer B={B} T={T} {dtype}"
    with torch.no_grad():
        fwd = cuda_ms_quiet(torch, lambda: rnn(x), reps, label)
    both = cuda_ms_quiet(torch, lambda: rnn(x)[0].backward(dout), reps, label)
    return fwd, both - cuda_ms_quiet(torch, lambda: rnn(x), reps, label)


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
    for name in ROUTED:
        fn = getattr(_module(name), name)
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def read_launches() -> dict:
    return {name: getattr(_module(name), name).launches for name in KERNELS}


def read_routes(name: str) -> dict:
    """Kernel ``name``'s launches on each of its routes since
    ``reset_launches``."""
    return dict(getattr(_module(name), name).route_launches)


def held_to_route(name: str, before: dict, route: str, label: str) -> None:
    """Raise unless kernel ``name`` launched once since ``before`` (its
    route counts then), on ``route``."""
    got = {k: v - before[k] for k, v in read_routes(name).items()}
    if got != {**dict.fromkeys(got, 0), route: 1}:
        raise SystemExit(f"{name} {label} launched {got}, not once on its route {route!r}")


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
            bf16 = dtype == torch.bfloat16
            before = read_routes("fused_s2vt_fwd") if device.type == "cuda" else None
            got = fs.fused_s2vt_fwd(*args, snap)
            sync()
            want = fs.fused_s2vt_fwd_reference(*args, snap)
            _check(torch, "fused_s2vt_fwd", B, name, hid, T, got, want, errors)
            route = other = None
            if device.type == "cuda":
                # The wrapper's route held, then the other route on the same
                # inputs.
                route = fs.fused_s2vt_fwd_route(hid, B, bf16, device)
                other = "direct" if route == "mma" else "mma"
                print(f"kernel fused_s2vt_fwd B={B} {name} T={T}: route {route}", flush=True)
                held_to_route("fused_s2vt_fwd", before, route, f"B={B} {name} T={T}")
                before = read_routes("fused_s2vt_fwd")
                g1o, c1o, g2o, c2o, fino = fs.launch_fwd(*args, snap, other)
                sync()
                held_to_route("fused_s2vt_fwd", before, other, f"B={B} {name} T={T} ({other})")
                _check(torch, f"fused_s2vt_fwd[{other}]", B, name, hid, T,
                       (g1o, c1o, g2o, c2o, *fino.unbind(0)), want, errors)
            g1, c1, g2, c2 = got[:4]
            dout2 = torch.randn(T, B, hid, device=device, generator=gen)
            bargs = (g1, c1, g2, c2, dout2, *args[2:])
            before = read_routes("fused_s2vt_bwd") if device.type == "cuda" else None
            dxp = fs.fused_s2vt_bwd(*bargs)
            sync()
            bwant = fs.fused_s2vt_bwd_reference(*bargs)
            _check(torch, "fused_s2vt_bwd", B, name, hid, T, dxp, bwant, errors)
            broute = bother = None
            if device.type == "cuda":
                # The backward's route held, then its other route on the same
                # inputs where there is one (the mma route takes bf16 alone).
                broute = fs.fused_s2vt_bwd_route(hid, B, bf16, device)
                bother = "direct" if broute == "mma" else None
                print(f"kernel fused_s2vt_bwd B={B} {name} T={T}: route {broute}", flush=True)
                held_to_route("fused_s2vt_bwd", before, broute, f"B={B} {name} T={T}")
                if bother is not None:
                    before = read_routes("fused_s2vt_bwd")
                    dxpo = fs.launch_bwd(*bargs, bother)
                    sync()
                    held_to_route("fused_s2vt_bwd", before, bother,
                                  f"B={B} {name} T={T} ({bother})")
                    _check(torch, f"fused_s2vt_bwd[{bother}]", B, name, hid, T, dxpo, bwant,
                           errors)
            if B not in timed:
                continue
            route_note = ""
            if route is None:
                k_ms = cuda_ms(torch, lambda: fs.fused_s2vt_fwd(*args, snap), reps)
            else:
                # The routed kernel and its other route in turns: routed,
                # other, other, routed.
                def other_fn():
                    fs.launch_fwd(*args, snap, other)
                turns = [cuda_ms(torch, f, reps) for f in
                         (lambda: fs.fused_s2vt_fwd(*args, snap), other_fn, other_fn,
                          lambda: fs.fused_s2vt_fwd(*args, snap))]
                k_ms, o_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                route_note = (f"route={route} {other}_route_ms={o_ms:.4f} "
                              f"({o_ms / (T + 1) * 1e3:.2f} us per iteration) ")
            p_ms = cuda_ms(torch, lambda: fs.fused_s2vt_fwd_reference(*args, snap),
                           max(1, reps // 5), warmup=1)
            lib_ms = library_lstm_ms(torch, B, T, hid, hid, dtype, device, reps)
            bound, bound_by, nbytes, flops = fused_bound_ms(B, T, hid, name)
            times[("fused_s2vt_fwd", B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                      bound_ms=bound, bound_by=bound_by)
            if route is not None:
                times[("fused_s2vt_fwd", B, name, T)].update(route=route, other_route=other,
                                                          other_ms=o_ms)
            print(f"time fused_s2vt_fwd B={B} {name}: kernel_ms={k_ms:.4f} "
                  f"({k_ms / (T + 1) * 1e3:.2f} us per iteration) " + route_note
                  + f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} (2x cuDNN nn.LSTM fwd) "
                  f"bound_ms={bound:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                  f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)

            # The backward; cuDNN's backward also forms dW, so the kernel is
            # timed again with the three dW products of the autograd Function.
            h1 = fs._h_from(g1, c1)
            h1p, h2p = fs._shift_in_zero(h1), fs._shift_in_zero(fs._h_from(g2, c2))

            def bwd_and_dw():
                d1, d2 = (d.float() for d in fs.fused_s2vt_bwd(*bargs))
                fs._outer_sum(d1, h1p), fs._outer_sum(d2, h1), fs._outer_sum(d2, h2p)

            broute_note = ""
            if bother is None:
                k_ms = cuda_ms(torch, lambda: fs.fused_s2vt_bwd(*bargs), reps)
                if broute is not None:
                    broute_note = f"({k_ms / (T + 1) * 1e3:.2f} us per iteration) route={broute} "
            else:
                # The routed backward and its other route in turns: routed,
                # other, other, routed.
                def bother_fn():
                    fs.launch_bwd(*bargs, bother)
                turns = [cuda_ms(torch, f, reps) for f in
                         (lambda: fs.fused_s2vt_bwd(*bargs), bother_fn, bother_fn,
                          lambda: fs.fused_s2vt_bwd(*bargs))]
                k_ms, bo_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                broute_note = (f"({k_ms / (T + 1) * 1e3:.2f} us per iteration) route={broute} "
                               f"{bother}_route_ms={bo_ms:.4f} "
                               f"({bo_ms / (T + 1) * 1e3:.2f} us per iteration) ")
            kdw_ms = cuda_ms(torch, bwd_and_dw, reps)
            p_ms = cuda_ms(torch, lambda: fs.fused_s2vt_bwd_reference(*bargs),
                           max(1, reps // 5), warmup=1)
            lib_ms = library_lstm_bwd_ms(torch, B, T, hid, hid, dtype, device, reps)
            bound, bound_by, nbytes, flops = fused_bwd_bound_ms(B, T, hid, name)
            times[("fused_s2vt_bwd", B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                      bound_ms=bound, bound_by=bound_by,
                                                      with_dw_ms=kdw_ms)
            if broute is not None:
                times[("fused_s2vt_bwd", B, name, T)]["route"] = broute
            if bother is not None:
                times[("fused_s2vt_bwd", B, name, T)].update(other_route=bother, other_ms=bo_ms)
            print(f"time fused_s2vt_bwd B={B} {name}: kernel_ms={k_ms:.4f} " + broute_note
                  + f"kernel_plus_3dW_ms={kdw_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_bwd_ms={lib_ms:.4f} (cuDNN fwd+bwd less fwd) bound_ms={bound:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                  f"bound_share={bound / k_ms:.4f} [{card}]", flush=True)
    return errors, times


def seq_inputs(torch, cell, B, T, hid, device, gen):
    """The forward's inputs, float32: LSTM (x_proj_t [T, B, 4H], w_hh
    [4H, H], h0, c0 [B, H]); GRU (x_proj_t [T, B, 3H], w_hh [3H, H], b_hh
    [3H], h0 [B, H])."""
    k = 1.0 / math.sqrt(hid)
    G = SEQ_CELLS[cell][2] * hid
    x = torch.randn(T, B, G, device=device, generator=gen)
    w_hh = (torch.rand(G, hid, device=device, generator=gen) * 2 - 1) * k
    if cell == "gru":
        b_hh = (torch.rand(G, device=device, generator=gen) * 2 - 1) * k
        return [x, w_hh, b_hh, 0.5 * torch.randn(B, hid, device=device, generator=gen)]
    h0, c0 = (0.5 * torch.randn(B, hid, device=device, generator=gen) for _ in range(2))
    return [x, w_hh, h0, c0]


def seq_bwd_inputs(torch, cell, args, got, device, gen):
    """(the backward's inputs, h_prev [T, B, H]) from the forward kernel's
    inputs ``args`` and outputs ``got``, so that its gates (and c or gh_n)
    are real states; the output cotangents are random."""
    T, B, hid = got[0].shape
    h0 = args[3] if cell == "gru" else args[2]
    hprev = torch.cat([h0[None], got[0][:-1]])
    grads = [torch.randn(s, device=device, generator=gen)
             for s in ((T, B, hid), (B, hid), (B, hid))[:2 if cell == "gru" else 3]]
    if cell == "gru":
        return (got[1], got[2], hprev, args[1], *grads), hprev
    cprev = torch.cat([args[3][None], got[2][:-1]])
    return (got[1], got[2], cprev, args[1], *grads), hprev


# The two routes of each routed sequence kernel: (its route function, the
# launcher of one route by name, the routes).
SEQ_ROUTES = {"lstm_seq_fwd": ("lstm_seq_fwd_route", "launch_fwd", ("mma", "direct")),
              "lstm_seq_bwd": ("lstm_seq_bwd_route", "launch_bwd", ("cluster", "direct")),
              "gru_seq_fwd": ("gru_seq_fwd_route", "launch_fwd", ("mma", "direct")),
              "gru_seq_bwd": ("gru_seq_bwd_route", "launch_bwd", ("mma", "direct"))}


# Every routed recurrent kernel whose main-path launches a phase holds to
# its route: (its route function, its routes).
ROUTE_RULES = {**{k: (v[0], v[2]) for k, v in SEQ_ROUTES.items()},
               "fused_s2vt_fwd": ("fused_s2vt_fwd_route", ("mma", "direct")),
               "fused_s2vt_bwd": ("fused_s2vt_bwd_route", ("mma", "direct")),
               "att_decode_fwd": ("att_decode_fwd_route", ("mma", "direct"))}


def seq_route(name: str, hid: int, B: int, bf16: bool, device) -> str:
    """The route ``name``'s wrapper takes for (H, B, mode) on ``device``
    (the attention-decoder loop's also for the L = LENGTH encoder
    positions its main path runs)."""
    fn = getattr(_module(name), ROUTE_RULES[name][0])
    if name == "att_decode_fwd":
        return fn(hid, LENGTH, B, bf16, device)
    return fn(hid, B, bf16, device)


def launch_route(name: str, args, bf16: bool, route: str):
    """One launch of ``route`` of the routed sequence kernel ``name``, its
    outputs in the wrapper's form."""
    got = getattr(_module(name), SEQ_ROUTES[name][1])(*args, bf16, route)
    if name == "lstm_seq_fwd":
        outs, gates, cseq, fin = got
        return outs, gates, cseq, fin[0], fin[1]
    return got


def phase_seq_kernels(torch, device, hid, seq_lens, batches, timed, reps, card, cell="lstm"):
    """The per-layer LSTM (or GRU) sequence kernels against their plain
    versions at every T, batch and mode (float32, and bf16 product operands);
    times at ``timed``. The backward's inputs come from the forward kernel's
    run, so its gates are real states. The kernels of SEQ_ROUTES (both LSTM
    and both GRU kernels) have two routes each: every check call's
    route is printed and its launch held to it, the other route is checked
    on the same inputs, and both are timed in turns (routed, other, other,
    routed)."""
    fwd_name, bwd_name, _, cudnn_cell = SEQ_CELLS[cell]
    mod = _module(fwd_name)
    fwd, bwd = getattr(mod, fwd_name), getattr(mod, bwd_name)
    fwd_ref, bwd_ref = getattr(mod, fwd_name + "_reference"), getattr(mod, bwd_name + "_reference")
    bounds = {fwd_name: gru_seq_fwd_bound_ms if cell == "gru" else seq_fwd_bound_ms,
              bwd_name: gru_seq_bwd_bound_ms if cell == "gru" else seq_bwd_bound_ms}

    def bound_of(kernel, B, T, name, route):
        """The kernel's bound at this shape; of these only the LSTM
        backward's depends on the route (float32 as 3xTF32 on "cluster")."""
        if cell == "lstm" and kernel == bwd_name:
            return seq_bwd_bound_ms(B, T, hid, name, route)
        return bounds[kernel](B, T, hid, name)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(4321 if cell == "lstm" else 8642)
    errors, times = {}, {}

    def checked(kernel, fn, ref, fargs, B, name, T):
        """The wrapper's call against the plain version; on a routed kernel
        its route held, then the other route on the same inputs. Returns
        (outputs, route)."""
        bf16 = name == "bfloat16"
        routed = kernel in SEQ_ROUTES and device.type == "cuda"
        before = read_routes(kernel) if routed else None
        got = fn(*fargs, bf16)
        sync()
        want = ref(*fargs, bf16)
        _check(torch, kernel, B, name, hid, T, got, want, errors, SEQ_ATOL)
        if not routed:
            return got, None
        route = seq_route(kernel, hid, B, bf16, device)
        print(f"kernel {kernel} B={B} {name} T={T}: route {route}", flush=True)
        held_to_route(kernel, before, route, f"B={B} {name} T={T}")
        for other in SEQ_ROUTES[kernel][2]:
            if other == route:
                continue
            before = read_routes(kernel)
            got_other = launch_route(kernel, fargs, bf16, other)
            sync()
            held_to_route(kernel, before, other, f"B={B} {name} T={T} ({other})")
            _check(torch, f"{kernel}[{other}]", B, name, hid, T, got_other, want, errors,
                   SEQ_ATOL)
        return got, route

    for T in seq_lens:
        for B in batches:
            for name in ("float32", "bfloat16"):
                bf16 = name == "bfloat16"
                args = seq_inputs(torch, cell, B, T, hid, device, gen)
                got, fwd_route = checked(fwd_name, fwd, fwd_ref, args, B, name, T)
                bargs, hprev = seq_bwd_inputs(torch, cell, args, got, device, gen)
                _, bwd_route = checked(bwd_name, bwd, bwd_ref, bargs, B, name, T)
                if B not in timed:
                    continue
                dtype = torch.bfloat16 if bf16 else torch.float32
                lib_fwd, lib_bwd = library_seq_ms(torch, B, T, hid, dtype, device, reps,
                                                  cudnn_cell)

                def bwd_and_dw():
                    """The backward kernel with the weight gradients the
                    autograd Function forms from it (dW_hh; GRU also db_hh)."""
                    d = bwd(*bargs, bf16)
                    if cell == "gru":
                        dgh = torch.cat([d[0][..., :2 * hid], d[1]], dim=-1).reshape(-1, 3 * hid)
                        dgh.T @ hprev.reshape(-1, hid), dgh.sum(dim=0)
                    else:
                        hprev.reshape(-1, hid).T @ d[0].reshape(-1, 4 * hid)

                for kernel, fn, ref, fargs, lib, route in (
                        (fwd_name, fwd, fwd_ref, args, lib_fwd, fwd_route),
                        (bwd_name, bwd, bwd_ref, bargs, lib_bwd, bwd_route)):
                    route_note = ""
                    if route is not None:
                        # The routed kernel and its other route in turns:
                        # routed, other, other, routed.
                        other = next(r for r in SEQ_ROUTES[kernel][2] if r != route)

                        def other_fn(kernel=kernel, fargs=fargs, other=other):
                            launch_route(kernel, fargs, bf16, other)
                        turns = [cuda_ms(torch, f, reps) for f in
                                 (lambda: fn(*fargs, bf16), other_fn, other_fn,
                                  lambda: fn(*fargs, bf16))]
                        k_ms, o_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                    else:
                        k_ms = cuda_ms(torch, lambda: fn(*fargs, bf16), reps)
                    bound, bound_by, nbytes, flops = bound_of(kernel, B, T, name, route)
                    p_ms = cuda_ms(torch, lambda: ref(*fargs, bf16), max(1, reps // 5), warmup=1)
                    extra, steps = {}, T
                    if kernel == bwd_name:
                        extra["with_dw_ms"] = cuda_ms(torch, bwd_and_dw, reps)
                        steps = T + 1                      # iterations of the reverse sweep
                    unit = "iteration" if kernel == bwd_name else "step"
                    times[(kernel, B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib,
                                                       bound_ms=bound, bound_by=bound_by, **extra)
                    if route is not None:
                        o_bound = bound_of(kernel, B, T, name, other)[0]
                        times[(kernel, B, name, T)].update(route=route, other_route=other,
                                                           other_ms=o_ms, other_bound_ms=o_bound)
                        route_note = (f"route={route} {other}_route_ms={o_ms:.4f} "
                                      f"({o_ms / steps * 1e3:.2f} us per {unit}; bound "
                                      f"{o_bound:.4f}, share {o_bound / o_ms:.4f}) ")
                    print(f"time {kernel} B={B} T={T} {name}: kernel_ms={k_ms:.4f} "
                          f"({k_ms / steps * 1e3:.2f} us per {unit}) " + route_note
                          + "".join(f"kernel_plus_dW_ms={v:.4f} " for v in extra.values())
                          + f"plain_ms={p_ms:.4f} library_ms={lib:.4f} "
                          f"({'cuDNN fwd+bwd less fwd' if extra else 'cuDNN fwd'}) "
                          f"bound_ms={bound:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
                          f"{flops / 1e9:.2f} GFLOP) bound_share={bound / k_ms:.4f} [{card}]",
                          flush=True)
    return errors, times


def att_inputs(torch, B, T, hid, L, device, gen):
    """The attention-decoder kernel's nine inputs, float32, with the weights
    at torch's init scale and the encoder tensors as an encoder makes them."""
    k = 1.0 / math.sqrt(hid)

    def u(*shape):
        return (torch.rand(*shape, device=device, generator=gen) * 2 - 1) * k

    def n(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    return [n(T, B, 4 * hid), u(4 * hid, 2 * hid), u(4 * hid, hid), u(hid, hid), u(hid),
            u(hid), torch.tanh(n(B, L, hid)), torch.tanh(n(B, L, 2 * hid)),
            n(B, 2 * hid, scale=0.1)]


def phase_att_kernel(torch, device, hid, length, batches, timed, reps, card):
    """The attention-decoder kernel against its plain version at the teacher-
    forced decode length T = L - 1, every batch, float32 and bf16: each check
    call's route (att_decode_fwd_route) printed and its launch held to it,
    the other route checked on the same inputs (its launch held too); at
    ``timed`` both routes timed in turns (routed, other, other, routed)
    beside the bound and the plain time. No single PyTorch call computes this
    loop, so it has no library time."""
    from s2vt_tpu_torch.ops import fused_att_decode as fa
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(2468)
    T = length - 1
    errors, times = {}, {}
    on_card = device.type == "cuda"
    for B in batches:
        for name in ("float32", "bfloat16"):
            bf16 = name == "bfloat16"
            args = att_inputs(torch, B, T, hid, length, device, gen)
            before = read_routes("att_decode_fwd")
            got = fa.att_decode_fwd(*args, bf16)
            sync()
            want = fa.att_decode_fwd_reference(*args, bf16)
            _check(torch, "att_decode_fwd", B, name, hid, T, (got,), (want,), errors)
            route = other = None
            if on_card:
                route = seq_route("att_decode_fwd", hid, B, bf16, device)
                other = next(r for r in ROUTE_RULES["att_decode_fwd"][1] if r != route)
                print(f"kernel att_decode_fwd B={B} {name} T={T}: route {route}", flush=True)
                held_to_route("att_decode_fwd", before, route, f"B={B} {name} T={T}")
                before = read_routes("att_decode_fwd")
                got_other = fa.launch(*args, bf16, other)
                sync()
                held_to_route("att_decode_fwd", before, other, f"B={B} {name} T={T} ({other})")
                _check(torch, f"att_decode_fwd[{other}]", B, name, hid, T, (got_other,),
                       (want,), errors)
            if B not in timed:
                continue
            if on_card:
                turns = [cuda_ms(torch, f, reps) for f in
                         (lambda: fa.att_decode_fwd(*args, bf16),
                          lambda: fa.launch(*args, bf16, other),
                          lambda: fa.launch(*args, bf16, other),
                          lambda: fa.att_decode_fwd(*args, bf16))]
                k_ms, o_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            else:
                k_ms = cuda_ms(torch, lambda: fa.att_decode_fwd(*args, bf16), reps)
            p_ms = cuda_ms(torch, lambda: fa.att_decode_fwd_reference(*args, bf16),
                           max(1, reps // 5), warmup=1)
            bound, bound_by, nbytes, flops = att_decode_bound_ms(B, T, hid, length, name,
                                                                 route or "direct")
            times[("att_decode_fwd", B, name, T)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                                      bound_ms=bound, bound_by=bound_by)
            route_note = ""
            if on_card:
                o_bound = att_decode_bound_ms(B, T, hid, length, name, other)[0]
                times[("att_decode_fwd", B, name, T)].update(route=route, other_route=other,
                                                          other_ms=o_ms, other_bound_ms=o_bound)
                route_note = (f"route={route} {other}_route_ms={o_ms:.4f} "
                              f"({o_ms / T * 1e3:.2f} us per step; bound {o_bound:.4f}, "
                              f"share {o_bound / o_ms:.4f}) ")
            print(f"time att_decode_fwd B={B} T={T} L={length} {name}: kernel_ms={k_ms:.4f} "
                  f"({k_ms / T * 1e3:.2f} us per step) " + route_note + f"plain_ms={p_ms:.4f} "
                  f"library_ms=none (no single PyTorch call computes the loop) "
                  f"bound_ms={bound:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) bound_share={bound / k_ms:.4f} [{card}]", flush=True)
    worst = {name: max(e for (_, _, n, _), e in errors.items() if n == name)
             for name in ("float32", "bfloat16")}
    print(f"kernel att_decode_fwd largest error over B={list(batches)}, both routes: "
          + ", ".join(f"{n} {e:.3e} (bound {ATOL[n]:.0e})" for n, e in worst.items()), flush=True)
    return errors, times


def argmax_bound_ms(B: int, hid: int, vocab: int, dtype_name: str, route: str):
    """Least time for one greedy step's out-projection and argmax: h and the
    bias (float32) and W in the type the route's kernel reads (bf16 on the
    "mma" route in bf16 mode; float32 otherwise, the "direct" kernel rounding
    a float32 W in registers) read once, the ids written once; against the
    2*B*H*V operations of the product at the peak rate of the operand type,
    float32 on the mma route as three TF32 passes at the TF32 peak (as
    conv_bound_ms). Returns (ms, by, bytes, the 2*B*H*V operations)."""
    w_bytes = 2 if dtype_name == "bfloat16" and route == "mma" else 4
    nbytes = 4 * (B * hid + vocab) + w_bytes * vocab * hid + 8 * B
    flops = 2 * B * hid * vocab
    if dtype_name == "float32" and route == "mma":
        bound, by, _, _ = _bound(nbytes, 3 * flops, "tf32")
        return bound, by, nbytes, flops
    return _bound(nbytes, flops, dtype_name)


def conv_bound_ms(N: int, hw: int, C: int, K: int, dtype_name: str, route: str):
    """Least time for one fused 3x3 conv block: x, the weights, scale and
    shift read once and the output written once, in the operand type; against
    the 2*N*H*W*9*C*K operations at the peak rate of that type. Float32 on
    the tensor cores ("mma" route) takes three TF32 passes for float32
    accuracy, so its operations are 3x those at the TF32 peak; the "direct"
    route's are at the float32 peak. Returns (ms, by, bytes, the 2*N*H*W*9*C*K
    operations of the function)."""
    es = 2 if dtype_name == "bfloat16" else 4
    nbytes = es * (N * hw * hw * C + 9 * C * K + N * hw * hw * K) + 8 * K
    flops = 2 * N * hw * hw * 9 * C * K
    if dtype_name == "float32" and route == "mma":
        bound, by, _, _ = _bound(nbytes, 3 * flops, "tf32")
        return bound, by, nbytes, flops
    return _bound(nbytes, flops, dtype_name)


def argmax_rows_ok(torch, got, want, args, valid, bf16, integer):
    """(rows that differ, rows that differ outside a near-tie): a row may
    differ only where its top two logits, in float64 from the same rounded
    operands, are within ARGMAX_TIE_RTOL relative; with integer inputs
    (exact ties) no row may differ."""
    diff = got != want
    if integer:
        return int(diff.sum()), int(diff.sum())
    h, w, b = (a.double() for a in args)
    if bf16:
        h, w = h.to(torch.bfloat16).double(), w.to(torch.bfloat16).double()
    logits = h @ w.T + b
    if valid is not None:
        logits[:, valid:] = -1e30
    top2 = logits.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= ARGMAX_TIE_RTOL * top2[:, 0].abs()
    return int(diff.sum()), int((diff & ~near).sum())


def phase_argmax_kernel(torch, device, hid, batches, timed, reps, card, vocabs=ARGMAX_VOCABS):
    """The out-projection-and-argmax kernel against its plain version at
    every batch, vocab size (a padded vocab among them) and mode, and on
    integer inputs full of exact ties; in bf16 with a float32 W (the
    "direct" route) and with a bf16 W (the "mma" route: what greedy_pick
    hands it), each call's launch held to ``argmax_linear_route``. Times at
    ``timed`` (V = vocabs[0], no pad) of the route the decode path takes,
    beside the direct route (the CUDA-core kernel, W float32), cuBLAS addmm
    + mask + torch.argmax and the bound."""
    from s2vt_tpu_torch.ops import fused_decode as fd
    from s2vt_tpu_torch.ops.layers import mask_invalid_vocab
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(1357)
    errors, times = {}, {}
    for V in vocabs:
        for B in batches:
            routes = {}
            for name in ("float32", "bfloat16"):
                bf16 = name == "bfloat16"
                for integer in (False, True):
                    if integer:
                        args = [torch.randint(-3, 4, (B, hid), device=device, generator=gen),
                                torch.randint(-2, 3, (V, hid), device=device, generator=gen),
                                torch.randint(-2, 3, (V,), device=device, generator=gen)]
                        args = [a.float() for a in args]
                    else:
                        args = [torch.randn(B, hid, device=device, generator=gen),
                                0.05 * torch.randn(V, hid, device=device, generator=gen),
                                torch.randn(V, device=device, generator=gen)]
                    h, w, b = args
                    for wk in ([w, w.to(torch.bfloat16)] if bf16 else [w]):
                        route = fd.argmax_linear_route(hid, wk.dtype, bf16,
                                                       (h.data_ptr(), wk.data_ptr()))
                        routes[f"{name} W {str(wk.dtype)[6:]}"] = route
                        for valid in (None, V - 240):
                            reset_launches()
                            got = fd.argmax_linear(h, wk, b, valid, bf16)
                            sync()
                            if read_routes("argmax_linear") != {"mma": 0, "direct": 0, route: 1}:
                                raise SystemExit(f"argmax_linear B={B} V={V} {name} W "
                                                 f"{wk.dtype} launched "
                                                 f"{read_routes('argmax_linear')}, not once on "
                                                 f"its route {route!r}")
                            want = fd.argmax_linear_reference(h, wk, b, valid, bf16)
                            n_diff, n_bad = argmax_rows_ok(torch, got, want, [h, wk, b], valid,
                                                           bf16, integer)
                            errors[("argmax_linear", B, name, V)] = max(
                                errors.get(("argmax_linear", B, name, V), 0.0), float(n_bad))
                            if n_bad:
                                raise SystemExit(f"argmax_linear disagrees with its plain version "
                                                 f"at B={B} V={V} valid={valid} {name} W "
                                                 f"{wk.dtype} route={route} integer={integer}: "
                                                 f"{n_bad} rows outside a near-tie")
                            if n_diff:
                                print(f"kernel argmax_linear B={B} V={V} valid={valid} {name} "
                                      f"route={route}: {n_diff} near-tie rows differ (allowed)",
                                      flush=True)
            print(f"kernel argmax_linear B={B} V={V} H={hid}: tokens equal to the plain "
                  f"version (random and exact-tie inputs; valid_vocab None and V-240) ok; "
                  f"routes " + ", ".join(f"{k}: {r}" for k, r in routes.items()), flush=True)
    V = vocabs[0]
    for B in timed:
        for name in ("float32", "bfloat16"):
            bf16 = name == "bfloat16"
            h = torch.randn(B, hid, device=device, generator=gen)
            w = 0.05 * torch.randn(V, hid, device=device, generator=gen)
            b = torch.randn(V, device=device, generator=gen)
            dt = torch.bfloat16 if bf16 else torch.float32
            hl, wl, bl = h.to(dt), w.to(dt), b.to(dt)
            wk = w.to(dt)                       # the weight greedy_pick hands the kernel
            route = fd.argmax_linear_route(hid, wk.dtype, bf16, (h.data_ptr(), wk.data_ptr()))
            calls = {"kernel": lambda: fd.argmax_linear(h, wk, b, None, bf16),
                     "direct": lambda: fd._launch(h, w, b, None, bf16, "direct"),
                     "plain": lambda: fd.argmax_linear_reference(h, wk, b, None, bf16),
                     "library": lambda: torch.argmax(mask_invalid_vocab(
                         torch.addmm(bl, hl, wl.t()), None), dim=-1)}
            dev = {k: device_ms(torch, fn, reps * 5) for k, fn in calls.items()}
            call = {k: cuda_ms(torch, fn, reps * 5) for k, fn in calls.items()}
            bound, bound_by, nbytes, flops = argmax_bound_ms(B, hid, V, name, route)
            d_bound = argmax_bound_ms(B, hid, V, name, "direct")[0]
            times[("argmax_linear", B, name, V)] = dict(
                ms=dev["kernel"], plain_ms=dev["plain"], library_ms=dev["library"],
                bound_ms=bound, bound_by=bound_by, direct_ms=dev["direct"], route=route)
            print(f"time argmax_linear B={B} V={V} H={hid} {name} route={route}: kernel_ms="
                  f"{dev['kernel']:.4f} direct_ms={dev['direct']:.4f} (the CUDA-core route, W "
                  f"float32; bound {d_bound:.4f}) plain_ms={dev['plain']:.4f} library_ms="
                  f"{dev['library']:.4f} (cuBLAS addmm + argmax in {name}; device time by "
                  f"torch.profiler) bound_ms={bound:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP) bound_share={bound / dev['kernel']:.4f} "
                  f"kernel/library={dev['kernel'] / dev['library']:.4f} "
                  f"kernel/direct={dev['kernel'] / dev['direct']:.4f}; per call with the "
                  f"host's launch cost (CUDA events): kernel {call['kernel']:.4f} direct "
                  f"{call['direct']:.4f} plain {call['plain']:.4f} library {call['library']:.4f} "
                  f"[{card}]", flush=True)
    return errors, times


def conv_inputs(torch, N, hw, C, K, device, gen):
    x = torch.randn(N, hw, hw, C, device=device, generator=gen)
    w = torch.randn(3, 3, C, K, device=device, generator=gen) * math.sqrt(2.0 / (9 * C))
    scale = 1.0 + 0.3 * torch.randn(K, device=device, generator=gen)
    shift = 0.1 * torch.randn(K, device=device, generator=gen)
    return [x, w, scale, shift]


def phase_conv_kernel(torch, device, layers, check_n, time_n, reps, card):
    """The fused conv kernel against its plain version at each VGG16 layer
    shape (``check_n`` images), float32 within 1e-4 and bf16 within 3e-2
    (allclose's atol = rtol), each call's launch held to the layer's route
    (``conv3x3_route``: 12 "mma" and 1 "direct" over VGG16's layers); then
    every layer timed at ``time_n`` images beside cuDNN (F.conv2d on
    channels_last + affine + ReLU, TF32 off in float32) and the bound of its
    route. Returns the errors and, per mode, the sums over the layers (one
    VGG16 forward of ``time_n`` frames)."""
    from s2vt_tpu_torch.ops import fused_conv as fc
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(97531)
    errors, totals = {}, {}
    routes = {"mma": 0, "direct": 0}
    for i, (hw, C, K) in enumerate(layers):
        args = conv_inputs(torch, check_n, hw, C, K, device, gen)
        route = fc.conv3x3_route(C, K)
        routes[route] += 1
        for name in ("float32", "bfloat16"):
            bf16 = name == "bfloat16"
            tol = ATOL[name]
            reset_launches()
            got = fc.conv3x3_bn_relu(*args, bf16)
            sync()
            if read_routes("conv3x3_bn_relu") != {"mma": 0, "direct": 0, route: 1}:
                raise SystemExit(f"conv3x3_bn_relu layer {i + 1} launched "
                                 f"{read_routes('conv3x3_bn_relu')}, not once on its route "
                                 f"{route!r}")
            want = fc.conv3x3_bn_relu_reference(*args, bf16)
            excess = ((got.float() - want.float()).abs()
                      - tol * (1 + want.float().abs())).max().item()
            err = (got.float() - want.float()).abs().max().item()
            errors[("conv3x3_bn_relu", i, name)] = err
            ok = excess <= 0 and bool(torch.isfinite(got.float()).all())
            print(f"kernel conv3x3_bn_relu layer {i + 1} N={check_n} H=W={hw} C={C} K={K} {name} "
                  f"route={route}: max_abs_err={err:.3e} (bound {tol:g} + {tol:g}*|want|) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"conv3x3_bn_relu disagrees with its plain version at layer "
                                 f"{i + 1} {name}: max_abs_err={err}")
    if routes != VGG_ROUTES:
        raise SystemExit(f"VGG16's layers take the routes {routes}, not {VGG_ROUTES}")
    for name in ("float32", "bfloat16") if time_n else ():
        bf16 = name == "bfloat16"
        dt = torch.bfloat16 if bf16 else torch.float32
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={})
        for i, (hw, C, K) in enumerate(layers):
            route = fc.conv3x3_route(C, K)
            x, w, scale, shift = conv_inputs(torch, time_n, hw, C, K, device, gen)
            xk, wk = x.to(dt), w.to(dt)
            xl = xk.permute(0, 3, 1, 2)                        # NCHW view, channels_last
            wl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            sc, sh = scale.to(dt)[None, :, None, None], shift.to(dt)[None, :, None, None]
            k_ms = cuda_ms(torch, lambda: fc.conv3x3_bn_relu(xk, wk, scale, shift, bf16), reps)
            p_ms = cuda_ms(torch, lambda: fc.conv3x3_bn_relu_reference(x, w, scale, shift, bf16),
                           1, warmup=1)
            lib_ms = cuda_ms(torch, lambda: torch.relu(F.conv2d(xl, wl, None, 1, 1) * sc + sh),
                             reps)
            bound, bound_by, nbytes, flops = conv_bound_ms(time_n, hw, C, K, name, route)
            for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", lib_ms),
                             ("bound_ms", bound)):
                tot[key] += val
            tot["by"][bound_by] = tot["by"].get(bound_by, 0.0) + bound
            print(f"time conv3x3_bn_relu layer {i + 1} N={time_n} H=W={hw} C={C} K={K} {name} "
                  f"route={route}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_ms={lib_ms:.4f} (cuDNN "
                  f"conv2d channels_last + affine + ReLU) bound_ms={bound:.4f} ({bound_by}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) bound_share="
                  f"{bound / k_ms:.4f} achieved_TFLOPs={flops / k_ms / 1e9:.2f} [{card}]",
                  flush=True)
            del x, w, xk, wk, xl, wl
        tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
        totals[name] = tot
        print(f"time conv3x3_bn_relu VGG16's 13 layers N={time_n} {name}: kernel_ms="
              f"{tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} ({tot['bound_by']}) bound_share="
              f"{tot['bound_ms'] / tot['ms']:.4f} "
              f"kernel/library={tot['ms'] / tot['library_ms']:.4f} "
              f"[{card}]", flush=True)
    return errors, totals


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
    from s2vt_tpu_torch.data.corpus import load_captions, special_token_indices
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    meta = make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=200,
                                 feat_len=length, feat_dim=feat, seed=seed)
    sp = special_token_indices(load_captions(meta["captions_file"])["word2ix"])
    opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
              train_length=length, dim_hidden=hid, dim_embed=hid, feat_dim=feat,
              use_pallas=True, seed=seed, sos_ix=sp["sos_ix"], eos_ix=sp["eos_ix"])
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
    """The main path through greedy_eval, launch counts read around it and
    held to ``s2vt_launches`` exactly, then S2VT.greedy kernel vs plain.
    Returns the launches of the main-path run."""
    from s2vt_tpu_torch.evaluation.decode import greedy_eval
    from s2vt_tpu_torch.models import S2VT

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"   # None: the entry points' default
    reset_launches()
    t0 = time.perf_counter()
    preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    fused_routes = read_routes("fused_s2vt_fwd")
    with plain_kernels():
        plain_preds = greedy_eval(ckpt, batch_size=MAIN_BATCH, device=dev_arg)
    n_batches = -(-len(preds) // MAIN_BATCH)
    same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
    print(f"slice greedy_eval: {len(preds)} clips in {n_batches} requests of B={MAIN_BATCH}, "
          f"{wall:.3f} s wall, launches={launches}, "
          f"sentences equal to the plain route: {same:.4f} [{card}]", flush=True)
    want = expect(requests=(s2vt_launches("lstm", 1, length)[2], n_batches))
    if launches != want:
        raise SystemExit(f"greedy_eval launched {launches} for {n_batches} requests, not {want}")
    # Every request is a fixed-shape batch of MAIN_BATCH rows, float32.
    hold_seq_routes({"fused_s2vt_fwd": fused_routes},
                    {"fused_s2vt_fwd": {MAIN_BATCH: launches["fused_s2vt_fwd"]}}, device,
                    "slice greedy_eval", card, hid)
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
    test split, launch counts read around it and every sequence-kernel
    launch held to its route, sentences against the plain route; then
    S2VT.beam kernel vs plain and its request times. Returns the sequence
    forward kernel's launches in the main-path run and its route counts."""
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
    routes = {k: read_routes(k) for k in SEQ_ROUTES}
    with plain_kernels():
        plain_preds = beam_eval(ckpt, **kw)
    n_batches = -(-len(preds) // MAIN_BATCH)
    same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
    print(f"beam beam_eval: {len(preds)} clips in {n_batches} requests of B={MAIN_BATCH}, "
          f"W={BEAM_WIDTH} D={BEAM_DEPTH}, {wall:.3f} s wall, launches={launches}, sentences "
          f"equal to the plain route: {same:.4f}, e.g. {next(iter(preds.items()), None)} "
          f"[{card}]", flush=True)
    want = expect(requests=(s2vt_launches("lstm", 1, length)[3], n_batches))
    if launches != want:
        raise SystemExit(f"beam_eval launched {launches} for {n_batches} requests, not {want} "
                         "(vid_rnn and word_rnn, one sequence kernel each)")
    per_request = s2vt_launches("lstm", 1, length)[3]["lstm_seq_fwd"]
    per_batch = {}
    for b0 in range(0, len(preds), MAIN_BATCH):
        b = min(MAIN_BATCH, len(preds) - b0)
        per_batch[b] = per_batch.get(b, 0) + per_request
    hold_seq_routes(routes, {"lstm_seq_fwd": per_batch, "lstm_seq_bwd": {}}, device,
                    "beam beam_eval", card, hid)
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
    return launches["lstm_seq_fwd"], routes["lstm_seq_fwd"]


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


def compare_grads(model, dev_batch, label, card) -> None:
    """The loss and every gradient of one batch on the kernel route against
    the plain route (every kernel wrapper on its plain version), f32: loss
    within LOSS_TOL, each gradient within GRAD_TOL + GRAD_TOL*|g|."""
    k_loss, k_grads = _grads(model, dev_batch)
    with plain_kernels():
        p_loss, p_grads = _grads(model, dev_batch)
    worst, worst_key = 0.0, None
    for key, pg in p_grads.items():
        excess = ((k_grads[key] - pg).abs() - GRAD_TOL * (1 + pg.abs())).max().item()
        if worst_key is None or excess > worst:
            worst, worst_key = excess, key
    max_err = max((k_grads[k] - p_grads[k]).abs().max().item() for k in p_grads)
    print(f"{label} kernel route vs plain route (B={MAIN_BATCH} f32): loss {k_loss:.6f} vs "
          f"{p_loss:.6f}; max |dgrad| {max_err:.3e} over {len(p_grads)} parameters "
          f"(bound {GRAD_TOL:g} + {GRAD_TOL:g}*|g|; closest to it: {worst_key}) [{card}]",
          flush=True)
    if abs(k_loss - p_loss) > LOSS_TOL or worst > 0:
        raise SystemExit(f"kernel route disagrees with the plain route: loss {k_loss} vs "
                         f"{p_loss}, gradient {worst_key} over its bound by {worst}")


def train_corpus(root, seed, feat, length, n_videos):
    """Few distinct words with long captions, so that after a few steps the
    most likely token is a word, not <eos>, and captions are not empty."""
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    return make_synthetic_corpus(root, n_videos=n_videos, vocab_extra=8, max_caption_words=24,
                                 feat_len=length, feat_dim=feat, seed=seed)


def train_argv(dev_flag, meta, root, seed, hid, feat, length, vocab, epochs, extra):
    """cli.train's flags for a float32 run at B = MAIN_BATCH with use_pallas."""
    return dev_flag + [
        "--caption_file", meta["captions_file"], "--feats_path", meta["feat_path"],
        "--gts_file", meta["gts_file"], "--train_length", str(length),
        "--dim_hidden", str(hid), "--dim_embed", str(hid), "--feat_dim", str(feat),
        "--vocab_pad_multiple", str(vocab), "--batch_size", str(MAIN_BATCH),
        "--use_pallas", "true", "--compute_dtype", "float32", "--EPOCHS", str(epochs),
        "--lr", "1e-3", "--seed", str(seed), "--save_path", f"{root}/ckpt",
        "--log_dir", f"{root}/runs", *extra]


def s2vt_launches(rnn_type, num_layers, length=LENGTH):
    """The kernel launches of one S2VT configuration: (per train step, per
    validation step, per greedy_eval request, per beam_eval request). One
    LSTM layer runs the fused kernels once per step each way, and greedy's
    encode on the fused forward; otherwise every layer of both RNNs runs its
    cell's sequence kernels, once each way. Each of greedy's L - 1 decode
    steps runs the out-projection-and-argmax kernel once. Beam encodes per
    layer, whatever the depth. Kernels not named launch 0 times."""
    seq_fwd, seq_bwd = SEQ_CELLS[rnn_type][:2]
    per_layer = 2 * num_layers                      # vid_rnn and word_rnn
    beam = {seq_fwd: per_layer}
    steps = {"argmax_linear": length - 1}
    if rnn_type == "lstm" and num_layers == 1:
        return ({"fused_s2vt_fwd": 1, "fused_s2vt_bwd": 1}, {"fused_s2vt_fwd": 1},
                {"fused_s2vt_fwd": 1, **steps}, beam)
    return ({seq_fwd: per_layer, seq_bwd: per_layer}, {seq_fwd: per_layer},
            {seq_fwd: per_layer, **steps}, beam)


def hold_seq_routes(routes: dict, per_batch: dict, device, label: str, card: str,
                    hid: int = H, bf16: bool = False) -> None:
    """Phases 3-10: each launch of the routed recurrent kernels (the LSTM
    and GRU sequence kernels, the fused forward and backward) on the route its
    wrapper takes for that batch and mode. ``routes`` holds each kernel's
    route counts of the run, ``per_batch`` {kernel: {B: launches at that
    B}}."""
    if device.type != "cuda":
        return
    print(f"{label}: routed kernel launches {routes} [{card}]", flush=True)
    for name, counts in per_batch.items():
        want = dict.fromkeys(ROUTE_RULES[name][1], 0)
        for B, n in counts.items():
            want[seq_route(name, hid, B, bf16, device)] += n
        if routes[name] != want:
            raise SystemExit(f"{label}: {name} launched {routes[name]}, not {want} (the routes "
                             f"{ROUTE_RULES[name][0]} names)")


def expect(**per_unit) -> dict:
    """Every kernel's expected launches: for each keyword's (counts per
    unit, units), counts times units, summed; 0 for a kernel none names."""
    want = {k: 0 for k in KERNELS}
    for counts, units in per_unit.values():
        for k, n in counts.items():
            want[k] += n * units
    return want


def phase_train(torch, device, seed, hid, feat, length, vocab, n_videos, epochs, batches, reps,
                card, num_layers=1, dtypes=("float32", "bfloat16"), rnn_type="lstm"):
    """The main path: s2vt_tpu_torch.cli.train's main -> Trainer.fit, with the
    launch counts read around it and held to ``s2vt_launches`` exactly; its
    final checkpoint through greedy_eval and beam_eval against the plain
    route; the kernel route's loss and gradients against the plain route's;
    then train-step and request times. Returns the launches of the main-path
    run and of the beam_eval run."""
    from s2vt_tpu_torch.cli import train as train_cli
    from s2vt_tpu_torch.training import Trainer

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_flag = [] if device.type == "cuda" else ["--device", "cpu"]   # default: the card
    per_train, per_valid, per_greedy, per_beam = s2vt_launches(rnn_type, num_layers, length)
    with tempfile.TemporaryDirectory() as root:
        meta = train_corpus(root, seed, feat, length, n_videos)
        argv = train_argv(dev_flag, meta, root, seed, hid, feat, length, vocab, epochs,
                          ["--num_layers", str(num_layers), "--rnn_type", rnn_type])
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()
        routes = {k: read_routes(k) for k in ROUTE_RULES}
        hist = trainer.history
        n_train, n_valid = len(trainer.train_ds), len(trainer.valid_ds)
        train_steps = epochs * -(-n_train // MAIN_BATCH)
        valid_steps = epochs * -(-n_valid // MAIN_BATCH)
        print(f"{rnn_type} cli.train -> Trainer.fit: V={trainer.vocab_size} H={hid} F={feat} "
              f"L={length} rnn={rnn_type} layers={num_layers} B={MAIN_BATCH} f32, {epochs} "
              f"epochs of {n_train} clips ({train_steps} train steps, {valid_steps} valid steps) "
              f"in {wall:.3f} s; "
              f"train_loss={hist['train_loss']} valid_loss={hist['valid_loss']} "
              f"launches={launches} bank={trainer.use_feature_bank} [{card}]", flush=True)
        want = expect(train=(per_train, train_steps), valid=(per_valid, valid_steps))
        if launches != want:
            raise SystemExit(f"the {rnn_type} training path ({num_layers} layers) launched "
                             f"{launches}, not {want}")
        if n_train % MAIN_BATCH or n_valid % MAIN_BATCH:
            raise SystemExit(f"the corpus splits ({n_train}, {n_valid}) are not whole batches")
        hold_seq_routes(routes, {k: {MAIN_BATCH: launches[k]} for k in ROUTE_RULES}, device,
                        f"{rnn_type} {num_layers}-layer training", card, hid)
        losses = hist["train_loss"] + hist["valid_loss"]
        if len(hist["train_loss"]) != epochs or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"training losses missing or not finite: {hist}")
        if not hist["train_loss"][-1] < hist["train_loss"][0]:
            raise SystemExit(f"the train loss did not fall: {hist['train_loss']}")

        final = os.path.join(trainer.opt.save_path, trainer.opt.start_time + "final")
        decode_launches = decode_final(
            torch, final, None if dev_flag == [] else "cpu",
            len(trainer.train_ds.splits["test"]), sync, f"{rnn_type} {num_layers}-layer",
            {"greedy_eval": per_greedy, "beam_eval": per_beam}, card, allow_empty=())

        # Kernel route against plain route, full width, one batch, f32.
        batch = next(trainer.train_ds.batches(MAIN_BATCH, epoch=0))
        dev_batch = trainer._put(batch, "train")
        compare_grads(trainer.model, dev_batch, f"{rnn_type} train", card)

        # Train-step times: forward, loss, backward, AdamW.
        gen = torch.Generator().manual_seed(seed + 2)
        for dtype in dtypes:
            tr = Trainer(trainer.opt.replace(compute_dtype=dtype, resume_path=""),
                         device=trainer.device)
            for B in batches:
                args = _random_batch(torch, B, length, feat, trainer.train_ds.vocab_size,
                                     device, gen)
                reset_launches()
                for _ in range(2):
                    tr.train_step(*args)
                med = median_s(lambda: tr.train_step(*args).item(), reps, sync)
                print(f"{rnn_type} train step V={tr.vocab_size} layers={num_layers} B={B} "
                      f"{dtype}: {med * 1e3:.3f} ms (median of {reps}), {B / med:.1f} clips/s "
                      f"[{card}]", flush=True)
                if device.type == "cuda":
                    profile_call(torch, lambda: tr.train_step(*args), med * 1e3,
                                 f"{rnn_type} train step B={B} {dtype}", card)
                # Every routed launch of the timed steps on its route, with
                # exact counts.
                timed = read_launches()
                if device.type == "cuda" and any(timed[k] <= 0 for k in per_train):
                    raise SystemExit(f"the timed {rnn_type} train steps at B={B} {dtype} "
                                     f"launched {timed}")
                hold_seq_routes({k: read_routes(k) for k in ROUTE_RULES},
                                {k: {B: timed[k]} for k in ROUTE_RULES}, device,
                                f"{rnn_type} {num_layers}-layer timed train steps B={B} {dtype}",
                                card, hid, dtype == "bfloat16")
        feats = _random_batch(torch, MAIN_BATCH, length, feat, trainer.train_ds.vocab_size,
                              device, gen)[0]
        time_requests(torch, device, trainer.model, feats, reps, sync,
                      f"{rnn_type} {num_layers}-layer S2VT", card)
    return launches, decode_launches, routes


def decode_final(torch, final, dev_arg, n_test, sync, label, per_request, card, allow_empty):
    """A trained final checkpoint through greedy_eval and beam_eval (B =
    MAIN_BATCH, W = BEAM_WIDTH, D = BEAM_DEPTH), with the launch counts read
    around each: ``per_request[entry]`` kernel launches per request and no
    other kernel; sentences equal to the plain route on ROW_MATCH_MIN_F32 of
    the clips, none empty, or not all for the entry points in
    ``allow_empty`` (a young model's best beam may end at once). Returns the
    beam_eval run's launches."""
    from s2vt_tpu_torch.evaluation.decode import beam_eval, greedy_eval
    for name, entry, kw in (("greedy_eval", greedy_eval, {}),
                            ("beam_eval", beam_eval, dict(beam_width=BEAM_WIDTH,
                                                          max_beam_depth=BEAM_DEPTH))):
        reset_launches()
        t0 = time.perf_counter()
        preds = entry(final, batch_size=MAIN_BATCH, device=dev_arg, **kw)
        sync()
        wall = time.perf_counter() - t0
        counts = read_launches()
        routes = {k: read_routes(k) for k in ROUTE_RULES}
        with plain_kernels():
            plain_preds = entry(final, batch_size=MAIN_BATCH, device=dev_arg, **kw)
        n_req = -(-len(preds) // MAIN_BATCH)
        same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
        empty = sum(not c for c in preds.values())
        print(f"{label} final checkpoint -> {name}: {len(preds)} of {n_test} test clips in "
              f"{n_req} requests of B={MAIN_BATCH}, {wall:.3f} s wall, launches={counts}, "
              f"sentences equal to the plain route: {same:.4f}, empty: {empty}, e.g. "
              f"{next(iter(preds.items()), None)} [{card}]", flush=True)
        want = expect(requests=(per_request[name], n_req))
        if counts != want:
            raise SystemExit(f"{label} {name} launched {counts} for {n_req} requests, not {want}")
        hold_seq_routes(routes, {k: {MAIN_BATCH: counts[k]} for k in ROUTE_RULES},
                        torch.device("cpu" if dev_arg == "cpu" else "cuda"),
                        f"{label} {name}", card)
        if (len(preds) != n_test or not all(isinstance(c, str) for c in preds.values())
                or empty == len(preds) or (empty and name not in allow_empty)):
            raise SystemExit(f"{label} {name} decoded to missing or empty captions: {preds}")
        if same < ROW_MATCH_MIN_F32:
            raise SystemExit(f"{label} {name} sentences differ from the plain route: {same:.4f}")
    return counts


def time_requests(torch, device, model, feats, reps, sync, label, card):
    """One greedy and one beam request (W = BEAM_WIDTH, D = BEAM_DEPTH) of
    ``model`` on ``feats``: host time (median of ``reps``) and, on the card,
    a profile."""
    B = feats.shape[0]
    for name, fn in (("greedy", lambda: model.greedy(feats)),
                     ("beam", lambda: model.beam(feats, BEAM_WIDTH, BEAM_DEPTH))):
        fn()
        med = median_s(fn, reps, sync)
        print(f"{label}.{name} V={model.vocab_size} B={B} float32: {med * 1e3:.3f} ms per "
              f"request (median of {reps}), {B / med:.1f} clips/s [{card}]", flush=True)
        if device.type == "cuda":
            profile_call(torch, fn, med * 1e3, f"{label}.{name} B={B}", card)


def _no_grad_call(torch, fn):
    def run():
        with torch.no_grad():
            return fn()
    return run


def phase_att(torch, device, seed, hid, feat, length, vocab, n_videos, epochs, timed, reps,
              card):
    """The attention baseline's main path: cli.train --model att_baseline ->
    Trainer.fit with the launch counts read around it (the attention-decoder
    kernel once per validation step; the sequence kernels twice per train and
    validation step forward, twice per train step backward: the two encoder
    directions); greedy_eval and beam_eval of its final checkpoint against
    the plain route; the no-gradient teacher-forced logits on the kernel
    route against the per-step route, and a train step's loss and gradients
    against the plain route, on one batch; then times. Returns the launches
    of the training run."""
    from s2vt_tpu_torch.cli import train as train_cli

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_flag = [] if device.type == "cuda" else ["--device", "cpu"]   # default: the card
    dev_arg = None if device.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as root:
        meta = train_corpus(root, seed, feat, length, n_videos)
        argv = train_argv(dev_flag, meta, root, seed, hid, feat, length, vocab, epochs,
                          ["--model", "att_baseline"])
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()
        routes = {k: read_routes(k) for k in ROUTE_RULES}
        hist = trainer.history
        n_train, n_valid = len(trainer.train_ds), len(trainer.valid_ds)
        train_steps = epochs * -(-n_train // MAIN_BATCH)
        valid_steps = epochs * -(-n_valid // MAIN_BATCH)
        print(f"att cli.train --model att_baseline -> Trainer.fit: V={trainer.vocab_size} "
              f"H={hid} F={feat} L={length} B={MAIN_BATCH} f32, {epochs} epochs of {n_train} "
              f"clips ({train_steps} train steps, {valid_steps} valid steps) in {wall:.3f} s; "
              f"train_loss={hist['train_loss']} valid_loss={hist['valid_loss']} "
              f"launches={launches} [{card}]", flush=True)
        want = expect(train=({"lstm_seq_fwd": 2, "lstm_seq_bwd": 2}, train_steps),
                      valid=({"lstm_seq_fwd": 2, "att_decode_fwd": 1}, valid_steps))
        if launches != want:
            raise SystemExit(f"the attention training path launched {launches}, not {want}")
        if n_train % MAIN_BATCH or n_valid % MAIN_BATCH:
            raise SystemExit(f"the corpus splits ({n_train}, {n_valid}) are not whole batches")
        hold_seq_routes(routes, {k: {MAIN_BATCH: launches[k]}
                                 for k in (*SEQ_ROUTES, "att_decode_fwd")}, device,
                        "att training", card, hid)
        losses = hist["train_loss"] + hist["valid_loss"]
        if len(hist["train_loss"]) != epochs or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"training losses missing or not finite: {hist}")
        if not hist["train_loss"][-1] < hist["train_loss"][0]:
            raise SystemExit(f"the train loss did not fall: {hist['train_loss']}")

        # Its final checkpoint through both decode entry points.
        final = os.path.join(trainer.opt.save_path, trainer.opt.start_time + "final")
        encoder = {"lstm_seq_fwd": 2}                # the encoder's two directions
        decode_final(torch, final, dev_arg, len(trainer.train_ds.splits["test"]), sync, "att",
                     {"greedy_eval": {**encoder, "argmax_linear": length}, "beam_eval": encoder},
                     card, allow_empty=("greedy_eval", "beam_eval"))

        # Route against route on one batch, full width, f32.
        model = trainer.model
        dev_batch = trainer._put(next(trainer.train_ds.batches(MAIN_BATCH, epoch=0)), "train")
        feats, labels = dev_batch[0], dev_batch[1]
        tf = _no_grad_call(torch, lambda: model(feats, labels[:, :-1], deterministic=True))
        before = read_launches()["att_decode_fwd"]
        k_logits = tf()
        sync()
        launched = read_launches()["att_decode_fwd"] - before
        model.use_pallas = False            # the decoder's per-step route; encoder unchanged
        p_logits = tf()
        model.use_pallas = True
        err = (k_logits - p_logits).abs().max().item()
        print(f"att no-grad teacher_forced, kernel route vs per-step route (B={MAIN_BATCH} f32): "
              f"max |dlogit| {err:.3e} (bound {ATOL['float32']:.0e}), kernel launches {launched} "
              f"[{card}]", flush=True)
        if launched != 1 or not err <= ATOL["float32"]:
            raise SystemExit(f"no-grad teacher_forced: {launched} launches, logits off by {err}")
        compare_grads(model, dev_batch, "att train step", card)

        # Times: no-grad teacher-forced on both routes, a train step, greedy, beam.
        gen = torch.Generator().manual_seed(seed + 4)
        real_vocab = trainer.train_ds.vocab_size
        for B in timed:
            feats_b, labels_b = _random_batch(torch, B, length, feat, real_vocab, device, gen)[:2]
            for route in ("kernel", "per_step"):
                model.use_pallas = route == "kernel"
                fn = _no_grad_call(torch, lambda: model(feats_b, labels_b[:, :-1],
                                                        deterministic=True))
                before = read_routes("att_decode_fwd")
                fn()
                med = median_s(fn, reps, sync)
                print(f"att teacher_forced no-grad B={B} {route} route: {med * 1e3:.3f} ms "
                      f"(median of {reps}), {B / med:.1f} clips/s [{card}]", flush=True)
                calls = reps + 1
                if device.type == "cuda":
                    profile_call(torch, fn, med * 1e3, f"att teacher_forced B={B} {route}", card)
                    calls += 1
                    got = {k: v - before[k] for k, v in read_routes("att_decode_fwd").items()}
                    want = dict.fromkeys(got, 0)
                    if route == "kernel":
                        want[seq_route("att_decode_fwd", hid, B, False, device)] = calls
                    print(f"att teacher_forced no-grad B={B} {route} route: att_decode_fwd "
                          f"launched {got} in {calls} passes [{card}]", flush=True)
                    if got != want:
                        raise SystemExit(f"att teacher_forced B={B} {route}: att_decode_fwd "
                                         f"launched {got}, not {want}")
            model.use_pallas = True
        args = _random_batch(torch, MAIN_BATCH, length, feat, real_vocab, device, gen)
        for _ in range(2):
            trainer.train_step(*args)
        med = median_s(lambda: trainer.train_step(*args).item(), reps, sync)
        print(f"att train step V={trainer.vocab_size} B={MAIN_BATCH} float32: {med * 1e3:.3f} ms "
              f"(median of {reps}), {MAIN_BATCH / med:.1f} clips/s [{card}]", flush=True)
        if device.type == "cuda":
            profile_call(torch, lambda: trainer.train_step(*args), med * 1e3,
                         f"att train step B={MAIN_BATCH} float32", card)
        time_requests(torch, device, model, args[0], reps, sync, "att AttBaseline", card)
    return launches, routes


def phase_serving(torch, device, ckpt, root, length, batch, reps, card, depth=BEAM_DEPTH):
    """The serving slice's main path: cli.export_serving of the checkpoint
    (greedy with float32, bf16 and int8 features, and beam, at B = batch),
    then ServingCaptioner.caption on ``batch`` test clips with the launch
    counts read around each request, against S2VT.greedy / S2VT.beam on the
    kernel route (the same features, cast or quantized as the artifact's
    payload), each request's #8 launches all on its "mma" route; request
    times and decode_tokens_timed phases. Returns the launches of the float32
    greedy request, its #8 launches per route, and the path of its
    artifact."""
    import numpy as np

    from s2vt_tpu_torch.cli import export_serving
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.corpus import ids_to_sentence, load_captions, special_token_indices
    from s2vt_tpu_torch.evaluation.decode import model_from_checkpoint
    from s2vt_tpu_torch.serving import ServingCaptioner, quantize_feats
    from s2vt_tpu_torch.training.checkpoint import load_config

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_flag = [] if device.type == "cuda" else ["--device", "cpu"]   # default: the card
    opt = Opt(**load_config(ckpt))
    data = load_captions(opt.caption_file)
    sp = special_token_indices(data["word2ix"])
    ix2word = {int(k): v for k, v in data["ix2word"].items()}
    _, model = model_from_checkpoint(ckpt, len(data["word2ix"]), device)
    test_ids = data["splits"]["test"][:batch]
    feats = np.stack([np.load(f"{opt.feats_path}/{vid}.npy") for vid in test_ids])

    def sentences(rows):
        return [ids_to_sentence(r, ix2word, sp["eos_ix"], sos_ix=sp["sos_ix"], pad_ix=sp["pad_ix"])
                for r in rows.cpu().numpy()]

    q, scale = quantize_feats(feats)
    payloads = {"float32": torch.from_numpy(feats),
                "bfloat16": torch.from_numpy(feats).to(torch.bfloat16).float(),
                "int8": torch.from_numpy(q).float() * torch.from_numpy(scale)[:, None, None]}
    greedy = dict(s2vt_launches("lstm", 1, length)[2])
    cells = [("greedy", dtype, greedy) for dtype in ("float32", "bfloat16", "int8")]
    cells.append(("beam", "float32", s2vt_launches("lstm", 1, length)[3]))
    main_launches, main_routes, greedy_dir = None, None, None
    for mode, dtype, per_request in cells:
        out = f"{root}/artifact_{mode}_{dtype}"
        t0 = time.perf_counter()
        export_serving.main(["--model_path", ckpt, "--out", out, "--batch", str(batch),
                             "--feats_dtype", dtype, "--beam_width", str(BEAM_WIDTH),
                             "--max_beam_depth", str(depth), *dev_flag]
                            + (["--beam"] if mode == "beam" else []))
        export_s = time.perf_counter() - t0
        srv = ServingCaptioner(out)
        reset_launches()
        t0 = time.perf_counter()
        got = srv.caption(feats)
        sync()
        wall = time.perf_counter() - t0
        launches, routes = read_launches(), read_routes("argmax_linear")
        seq_routes = {k: read_routes(k) for k in ROUTE_RULES}
        x = payloads[dtype].to(device)
        want = sentences(model.greedy(x) if mode == "greedy"
                         else model.beam(x, BEAM_WIDTH, depth).tokens[:, 0])
        same = sum(a == b for a, b in zip(got, want)) / len(want)
        med = median_s(lambda: srv.caption(feats), reps, sync)
        _, phases = srv.decode_tokens_timed(feats)
        print(f"serving {mode} artifact feats={dtype} B={batch} (export {export_s:.1f} s): "
              f"launches={launches}, #8 routes={routes}, sentences equal to the model's "
              f"kernel route {same:.4f}, "
              f"e.g. {got[0]!r}; {med * 1e3:.3f} ms per request (median of {reps}), "
              f"{batch / med:.1f} clips/s; decode_tokens_timed "
              + " ".join(f"{k}={v:.3f}" for k, v in phases.items()) + f" [{card}]", flush=True)
        want_launches = expect(request=(per_request, 1))
        if launches != want_launches:
            raise SystemExit(f"the {mode} {dtype} artifact launched {launches} for one request, "
                             f"not {want_launches}")
        if routes != {"mma": launches["argmax_linear"], "direct": 0}:
            raise SystemExit(f"the {mode} {dtype} artifact's #8 launches took the routes "
                             f"{routes}, not all the mma route")
        hold_seq_routes(seq_routes, {k: {batch: launches[k]} for k in ROUTE_RULES}, device,
                        f"serving {mode} artifact feats={dtype}", card, opt.dim_hidden)
        if same < 1.0 or len(got) != batch:
            raise SystemExit(f"the {mode} {dtype} artifact's sentences differ from the model's: "
                             f"{got} vs {want}")
        if device.type == "cuda" and dtype == "float32":
            profile_call(torch, lambda: srv.caption(feats), med * 1e3,
                         f"serving {mode} request B={batch}", card)
        if (mode, dtype) == ("greedy", "float32"):
            main_launches, main_routes, greedy_dir = launches, routes, out
    return main_launches, main_routes, greedy_dir


def write_frame_dir(path, frames):
    """Frames [T, H, W, 3] uint8 as the %06d.jpg files read_frame_dir reads."""
    from PIL import Image
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(path, f"{i:06d}.jpg"), quality=95)


def phase_extract(torch, device, seed, artifact, root, n_clips, frames, shape, reps, card):
    """Extraction's main path: FeatureExtractor("vgg16_bn") and ("vgg16")
    over seeded uint8 clips (launch counts read around one forward: the fused
    conv kernel once per conv block) against the plain route, clips/s; then
    cli.caption's ClipCaptioner with the greedy artifact over the clips as
    frame directories (launch counts read around the request). Returns the
    launches of the captioning request."""
    import numpy as np

    from s2vt_tpu_torch.cli.caption import ClipCaptioner
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    from s2vt_tpu_torch.extract.video import load_clip

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"      # None: the entry points' default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    clips = [rng.integers(0, 256, (frames, *shape, 3), dtype=np.uint8) for _ in range(n_clips)]
    n_conv = sum(1 for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
                             512, 512, 512, "M") if v != "M")
    for name in ("vgg16_bn", "vgg16"):
        ex = FeatureExtractor(name, device=dev_arg)
        plain = FeatureExtractor(name, use_pallas=False, device=dev_arg)
        reset_launches()
        feats = ex(clips[0])
        sync()
        launches, routes = read_launches(), read_routes("conv3x3_bn_relu")
        want = plain(clips[0])
        rel = float(np.abs(feats - want).max() / max(np.abs(want).max(), 1e-30))
        k_s = median_s(lambda: ex(clips[0]), reps, sync)
        p_s = median_s(lambda: plain(clips[0]), reps, sync)
        batched = np.concatenate(clips)
        kb_s = median_s(lambda: ex(batched), max(1, reps // 2), sync)
        print(f"extract {name} [{frames}, {shape[0]}, {shape[1]}, 3] uint8 clip: launches="
              f"{launches} (#9 routes {routes}), features {feats.shape} vs the plain route "
              f"(F.conv2d, TF32 off): max "
              f"rel err {rel:.3e} (bound {FEAT_RTOL:g}); kernel route {1 / k_s:.2f} clips/s "
              f"({k_s * 1e3:.1f} ms), {n_clips} clips per forward {n_clips / kb_s:.2f} clips/s; "
              f"plain route {1 / p_s:.2f} clips/s [{card}]", flush=True)
        if launches != expect(forward=({"conv3x3_bn_relu": n_conv}, 1)) or routes != VGG_ROUTES:
            raise SystemExit(f"FeatureExtractor({name!r}) launched {launches}, #9 routes "
                             f"{routes}, in one forward")
        if feats.shape != (frames, 4096) or not np.isfinite(feats).all() or rel > FEAT_RTOL:
            raise SystemExit(f"{name} features malformed or off the plain route by {rel}")
        if device.type == "cuda" and name == "vgg16":
            profile_call(torch, lambda: ex(clips[0]), k_s * 1e3, f"extract {name} one clip",
                         card)
        del ex, plain

    dirs = [os.path.join(root, f"clip{i:02d}") for i in range(n_clips)]
    for d, c in zip(dirs, clips):
        write_frame_dir(d, c)
    cap = ClipCaptioner(backbone="vgg16", artifact=artifact, device=dev_arg)
    reset_launches()
    t0 = time.perf_counter()
    out = cap.caption(dirs)
    sync()
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes("conv3x3_bn_relu")
    fused_routes = read_routes("fused_s2vt_fwd")
    direct = cap.artifact.caption(np.stack([cap.extractor(load_clip(d)) for d in dirs]))
    empty = sum(not c for c in out.values())
    print(f"caption ClipCaptioner(vgg16, greedy artifact) over {n_clips} frame directories: "
          f"{wall:.3f} s ({n_clips / wall:.2f} clips/s end to end), launches={launches} "
          f"(#9 routes {routes}), "
          f"empty: {empty}, e.g. {next(iter(out.items()))} [{card}]", flush=True)
    per_clip = {"conv3x3_bn_relu": n_conv}
    request = dict(s2vt_launches("lstm", 1, cap.frames_num)[2])
    if (launches != expect(clips=(per_clip, n_clips), request=(request, 1))
            or routes != {k: n * n_clips for k, n in VGG_ROUTES.items()}):
        raise SystemExit(f"ClipCaptioner launched {launches}, #9 routes {routes}, for "
                         f"{n_clips} clips")
    # The artifact's fixed batch: the clips zero-padded to its rows.
    hold_seq_routes({"fused_s2vt_fwd": fused_routes},
                    {"fused_s2vt_fwd": {cap.artifact.batch_size: launches["fused_s2vt_fwd"]}},
                    device, "ClipCaptioner request", card)
    if len(out) != n_clips or empty or list(out.values()) != direct:
        raise SystemExit(f"ClipCaptioner captions missing, empty or off the artifact's: {out} "
                         f"vs {direct}")
    return launches, routes


# Phase 11: the learnable corpus at MSVD feature shape, cut to SCORE_CLIPS
# (train, valid, test) and SCORE_CATALOGS (subjects, verbs, objects) atoms.
SCORE_CLIPS = (256, 64, 32)
SCORE_CATALOGS = (32, 16, 16)
SCORE_EPOCHS = 3
METRIC_NAMES = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")
UNIT_METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L")   # in [0, 1]
# Host scoring at MSVD's counts: its 450 valid clips, and 30-52 references
# a clip (mean ~41: about 80k English descriptions of 1,970 clips, Chen and
# Dolan 2011), 3-9 words each.
SCORE_COST_CLIPS = 450
SCORE_COST_REFS = (30, 53)


def check_scores(scores: dict, label: str) -> None:
    """The seven scores, all finite; BLEU, METEOR and ROUGE-L in [0, 1]."""
    if sorted(scores) != sorted(METRIC_NAMES) or not all(
            math.isfinite(v) for v in scores.values()) or not all(
            0.0 <= scores[k] <= 1.0 for k in UNIT_METRICS) or scores["CIDEr"] < 0:
        raise SystemExit(f"{label}: scores missing, not finite or out of range: {scores}")


def eval_cli_argv(dev_arg, final, meta, split, beam, out) -> list:
    """cli.eval's flags: ``final`` decoded on the card unless ``dev_arg``,
    at B = MAIN_BATCH, greedy or beam, its predictions dumped to ``out``."""
    argv = ["--model_path", final, "--caption_file", meta["captions_file"],
            "--feats_path", meta["feat_path"], "--gts_file", meta["gts_file"],
            "--split", split, "--batch_size", str(MAIN_BATCH), "--dump_predictions", out]
    if beam:
        argv += ["--beam", "--beam_width", str(BEAM_WIDTH), "--max_beam_depth", str(BEAM_DEPTH)]
    return argv + (["--device", dev_arg] if dev_arg else [])


def eval_cli_run(dev_arg, final, meta, split, beam, root, label, card) -> tuple:
    """``python -m s2vt_tpu_torch.cli.eval`` on ``final`` in a process of its
    own (on the card unless ``dev_arg``): (its predictions, its printed
    scores, wall seconds)."""
    out = os.path.join(root, f"eval_{label}.json")
    cmd = [sys.executable, "-m", "s2vt_tpu_torch.cli.eval",
           *eval_cli_argv(dev_arg, final, meta, split, beam, out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"cli.eval {label} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    scores = {}
    for line in proc.stdout.splitlines():
        name, _, value = line.partition(": ")
        scores[name] = float(value)
    check_scores(scores, f"cli.eval {label}")
    with open(out, encoding="utf-8") as f:
        return json.load(f), scores, wall


def msvd_scoring_load(seed: int, n_clips: int = SCORE_COST_CLIPS,
                      refs: tuple = SCORE_COST_REFS) -> tuple:
    """(gts, predictions) at MSVD's valid-split counts: each clip a (subject,
    verb, object) triple from the full-size learnable catalogs (440/280/280
    atoms), its references drawn from ten templates, some with an
    adjective, adverb or place; its prediction the first template's
    sentence, with the object wrong for about 3 clips in 10, as a trained
    greedy decode reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    templates = ("a {s} is {v} a {o}", "the {s} is {v} the {o}", "{s} {v} {o}",
                 "a {s} {v} the {o}", "a {a} {s} is {v} a {o}", "a {s} is {v} a {o} {d}",
                 "a {s} is {v} a {o} in the {p}", "the {a} {s} {v} a {a} {o} on the {p}",
                 "someone is {v} a {o}", "a {s} is {v}")
    gts, preds = {}, {}
    for c in range(n_clips):
        vid = f"clip{c:05d}"
        s, v, o = (int(rng.integers(n)) for n in (440, 280, 280))
        caps = [templates[int(rng.integers(len(templates)))].format(
            s=f"subj{s}", v=f"verb{v}", o=f"obj{o}", a=f"adj{int(rng.integers(60))}",
            d=f"adv{int(rng.integers(30))}", p=f"place{int(rng.integers(60))}")
            for _ in range(int(rng.integers(*refs)))]
        gts[vid] = [{"image_id": vid, "cap_id": j, "caption": x, "tokenized": x}
                    for j, x in enumerate(caps)]
        wrong = rng.random() >= 0.7
        preds[vid] = f"a subj{s} is verb{v} a obj{int(rng.integers(280)) if wrong else o}"
    return gts, preds


def score_cost(seed: int, card: str) -> dict:
    """Host scoring at MSVD's counts (msvd_scoring_load): one
    score_predictions call, the call a metric eval makes, then its stages
    (the PTB tokenizer and each metric) timed one by one. Returns the ms."""
    from s2vt_tpu_torch.evaluation.scorer import score_predictions
    from s2vt_tpu_torch.metrics import Bleu, Cider, Meteor, PTBTokenizer, Rouge

    gts, preds = msvd_scoring_load(seed)
    n_refs = sum(len(g) for g in gts.values())
    words = sum(len(x["caption"].split()) for g in gts.values() for x in g) / n_refs
    t0 = time.perf_counter()
    scores = score_predictions(preds, gts, verbose=False)
    ms = {"score_predictions": (time.perf_counter() - t0) * 1e3}
    check_scores(scores, "MSVD-count scoring")
    tok = PTBTokenizer()
    t0 = time.perf_counter()
    g = tok.tokenize(gts)
    r = tok.tokenize({k: [{"image_id": k, "caption": v}] for k, v in preds.items()})
    ms["tokenize"] = (time.perf_counter() - t0) * 1e3
    for name, scorer in (("Bleu", Bleu(4)), ("METEOR", Meteor()), ("ROUGE_L", Rouge()),
                         ("CIDEr", Cider())):
        t0 = time.perf_counter()
        scorer.compute_score(g, r)
        ms[name] = (time.perf_counter() - t0) * 1e3
    print(f"host scoring at MSVD's counts: {len(gts)} clips, {n_refs} references "
          f"({n_refs / len(gts):.2f} a clip, {words:.2f} words each): score_predictions "
          f"{ms['score_predictions']:.3f} ms; stages one by one (ms) "
          f"{ {k: round(v, 3) for k, v in ms.items() if k != 'score_predictions'} }; "
          f"scores {scores} [{card}]", flush=True)
    return ms


def phase_score(torch, device, seed, hid, feat, length, card, clips=SCORE_CLIPS,
                catalogs=SCORE_CATALOGS, epochs=SCORE_EPOCHS, gate=True):
    """The scoring slice: a learnable corpus at the given clip and catalog
    counts, cli.train with --metric_eval_freq 1 (launch counts read around
    it and held to s2vt_launches: the metric eval adds #1 once per valid
    request and #8 once per decode step), history["metrics"] checked, the
    last eval's sentences against the plain route, cli.eval greedy and beam
    on the final checkpoint in a process of their own and in this one
    (launch counts read around it and held to s2vt_launches) against the
    plain route, host scoring at MSVD's counts (score_cost), and the
    learning gate (tools/learning_gate.py) in float32 and bf16 with its
    shuffled-feature control. Returns the main-path launches."""
    from s2vt_tpu_torch.cli import eval as eval_cli
    from s2vt_tpu_torch.cli import train as train_cli
    from s2vt_tpu_torch.data.learnable import make_learnable_corpus
    from s2vt_tpu_torch.evaluation.decode import beam_eval, greedy_eval
    from s2vt_tpu_torch.evaluation.scorer import score_predictions
    from s2vt_tpu_torch.tools import learning_gate

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dev_arg = None if device.type == "cuda" else "cpu"
    n_train, n_valid, n_test = clips
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        meta = make_learnable_corpus(os.path.join(root, "corpus"), n_train=n_train,
                                     n_valid=n_valid, n_test=n_test, n_subjects=catalogs[0],
                                     n_verbs=catalogs[1], n_objects=catalogs[2],
                                     feat_len=length, feat_dim=feat, seed=seed)
        print(f"learnable corpus: {n_train}/{n_valid}/{n_test} clips of [{length}, {feat}] "
              f"float32, catalogs {catalogs}, V={meta['vocab_size']}, made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        argv = ([] if dev_arg is None else ["--device", dev_arg]) + [
            "--caption_file", meta["captions_file"], "--feats_path", meta["feat_path"],
            "--gts_file", meta["gts_file"], "--train_length", str(length),
            "--dim_hidden", str(hid), "--dim_embed", str(hid), "--feat_dim", str(feat),
            "--batch_size", str(MAIN_BATCH), "--eval_batch_size", str(MAIN_BATCH),
            "--use_pallas", "true", "--compute_dtype", "float32", "--EPOCHS", str(epochs),
            "--metric_eval_freq", "1", "--lr", "1e-3", "--seed", str(seed),
            "--save_path", f"{root}/ckpt", "--log_dir", f"{root}/runs"]
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()
        routes = {k: read_routes(k) for k in ROUTE_RULES}
        hist = trainer.history
        if (len(trainer.train_ds), len(trainer.valid_ds)) != (n_train, n_valid) or (
                n_train % MAIN_BATCH or n_valid % MAIN_BATCH or n_test % MAIN_BATCH):
            raise SystemExit(f"the corpus splits ({len(trainer.train_ds)}, "
                             f"{len(trainer.valid_ds)}) are not whole batches")
        per_train, per_valid, per_greedy, per_beam = s2vt_launches("lstm", 1, length)
        train_steps = epochs * n_train // MAIN_BATCH
        valid_steps = epochs * n_valid // MAIN_BATCH
        evals = len(hist.get("metrics", []))
        requests = evals * n_valid // MAIN_BATCH
        print(f"score cli.train --metric_eval_freq 1 -> Trainer.fit: V={trainer.vocab_size} "
              f"H={hid} F={feat} L={length} B={MAIN_BATCH} f32, {epochs} epochs "
              f"({train_steps} train steps, {valid_steps} valid steps, {evals} metric evals "
              f"of {requests // max(1, evals)} greedy requests) in {wall:.3f} s; "
              f"train_loss={hist['train_loss']} launches={launches} "
              f"bank={trainer.use_feature_bank} [{card}]", flush=True)
        want = expect(train=(per_train, train_steps), valid=(per_valid, valid_steps),
                      requests=(per_greedy, requests))
        if evals != epochs or launches != want:
            raise SystemExit(f"the scoring path ran {evals} metric evals and launched "
                             f"{launches}, not {epochs} and {want}")
        hold_seq_routes(routes, {k: {MAIN_BATCH: launches[k]} for k in ROUTE_RULES}, device,
                        "score training", card, hid)
        if [m["epoch"] for m in hist["metrics"]] != list(range(epochs)):
            raise SystemExit(f"history['metrics'] epochs: {hist['metrics']}")
        for m in hist["metrics"]:
            check_scores({k: v for k, v in m.items() if k != "epoch"}, f"epoch {m['epoch']}")
        last = {k: v for k, v in hist["metrics"][-1].items() if k != "epoch"}
        for i, t in enumerate(trainer.metric_eval_ms):
            print(f"metric eval {i}: decode {t['decode']:.3f} ms (greedy, {n_valid} valid "
                  f"clips in {n_valid // MAIN_BATCH} requests of B={MAIN_BATCH}, synchronised "
                  f"by the host copy of the tokens), scoring {t['score']:.3f} ms (host) "
                  f"[{card}]", flush=True)
        ms = trainer.metric_eval_ms
        print(f"metric eval mean of {len(ms)}: decode "
              f"{sum(t['decode'] for t in ms) / len(ms):.3f} ms, scoring "
              f"{sum(t['score'] for t in ms) / len(ms):.3f} ms per call; last scores {last} "
              f"[{card}]", flush=True)

        # The last eval's valid sentences against the plain route.
        dec = trainer._metric_decoder
        with open(meta["gts_file"], encoding="utf-8") as f:
            gts = json.load(f)["gts"]
        preds = dec.greedy(MAIN_BATCH)
        if score_predictions(preds, gts, verbose=False) != last:
            raise SystemExit("the valid split decoded again scores otherwise than the last "
                             "metric eval")
        with plain_kernels():
            plain_preds = dec.greedy(MAIN_BATCH)
        same = sum(preds[k] == plain_preds.get(k) for k in preds) / max(1, len(preds))
        plain_scores = score_predictions(plain_preds, gts, verbose=False)
        print(f"score: last eval's {len(preds)} valid sentences equal to the plain route: "
              f"{same:.4f}; plain route scores {plain_scores}; e.g. "
              f"{next(iter(preds.items()), None)} [{card}]", flush=True)
        if len(preds) != n_valid or same < ROW_MATCH_MIN_F32:
            raise SystemExit(f"the metric eval's sentences differ from the plain route: {same}")
        if same == 1.0 and plain_scores != last:
            raise SystemExit(f"equal sentences, unequal scores: {plain_scores} != {last}")

        # cli.eval on the final checkpoint: in a process of its own, then in
        # this one with its launch counts read around it.
        final = os.path.join(trainer.opt.save_path, trainer.opt.start_time + "final")
        n_requests = n_test // MAIN_BATCH
        for name, beam, entry, kw, per_request in (
                ("greedy", False, greedy_eval, {}, per_greedy),
                ("beam", True, beam_eval, dict(beam_width=BEAM_WIDTH,
                                               max_beam_depth=BEAM_DEPTH), per_beam)):
            got, scores, cli_wall = eval_cli_run(dev_arg, final, meta, "test", beam, root,
                                                 name, card)
            in_out = os.path.join(root, f"eval_{name}_in_process.json")
            reset_launches()
            in_scores = eval_cli.main(eval_cli_argv(dev_arg, final, meta, "test", beam, in_out))
            sync()
            in_launches = read_launches()
            in_routes = {k: read_routes(k) for k in ROUTE_RULES}
            with open(in_out, encoding="utf-8") as f:
                in_got = json.load(f)
            with plain_kernels():
                plain = entry(final, meta["captions_file"], meta["feat_path"],
                              batch_size=MAIN_BATCH, mode="test", device=dev_arg, **kw)
            same = sum(got[k] == plain.get(k) for k in got) / max(1, len(got))
            in_same = sum(in_got[k] == plain.get(k) for k in in_got) / max(1, len(in_got))
            plain_scores = score_predictions(plain, gts, verbose=False)
            print(f"score: python -m s2vt_tpu_torch.cli.eval {name} on the final checkpoint: "
                  f"{len(got)} test clips in {cli_wall:.3f} s wall (a process of its own), "
                  f"scores {scores}; predictions equal to the plain route's {entry.__name__}: "
                  f"{same:.4f}; in this process: launches={in_launches}, predictions equal "
                  f"to the plain route's {in_same:.4f} [{card}]", flush=True)
            want = expect(requests=(per_request, n_requests))
            if in_launches != want:
                raise SystemExit(f"cli.eval {name} launched {in_launches} for {n_requests} "
                                 f"requests, not {want}")
            hold_seq_routes(in_routes, {k: {MAIN_BATCH: in_launches[k]} for k in ROUTE_RULES},
                            device, f"score cli.eval {name}", card, hid)
            check_scores(in_scores, f"cli.eval {name} in this process")
            for label, preds_, agree in (("its own process", got, same),
                                         ("this process", in_got, in_same)):
                if len(preds_) != n_test or agree < ROW_MATCH_MIN_F32:
                    raise SystemExit(f"cli.eval {name} predictions in {label} differ from the "
                                     f"plain route: {agree}")
            if same == 1.0 and scores != {k: float(f"{v:.4f}") for k, v in plain_scores.items()}:
                raise SystemExit(f"cli.eval {name}: equal predictions, unequal scores: "
                                 f"{scores} against {plain_scores}")
            if in_same == 1.0 and in_scores != plain_scores:
                raise SystemExit(f"cli.eval {name} in this process: equal predictions, unequal "
                                 f"scores: {in_scores} against {plain_scores}")

    score_cost(seed, card)
    if gate:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            out = learning_gate.run(root, dev_arg, ("float32", "bfloat16"),
                                    log=lambda s: print(f"{s} [{card}]", flush=True))
        failed = {k: r["failures"] for k, r in out.items() if r["failures"]}
        print(f"learning gate at {learning_gate.SHAPE} with use_pallas: "
              f"{'passed' if not failed else failed} in {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
        if failed:
            raise SystemExit(f"the learning gate failed: {failed}")
    print(f"phase 11 (score): {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
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
    from s2vt_tpu_torch.ops import (_build, fused_att_decode, fused_conv, fused_decode, fused_gru,
                                    fused_rnn, fused_s2vt)
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    print(f"built {', '.join(_build.library_path(k).name for k in KERNELS)} from "
          f"s2vt_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s, in parallel "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    for name in KERNELS:
        for kernel, regs, stores, loads in _build.ptxas_entries(_build.build_logs.get(name, "")):
            print(f"  ptxas {name}: {kernel}: {regs} registers, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads", flush=True)
    if not fused_s2vt.fused_shapes_ok(H, 1, "lstm", device):
        raise SystemExit("fused_shapes_ok refuses the MSVD width on this card")
    if not fused_rnn.lstm_seq_shapes_ok(H, device):
        raise SystemExit("lstm_seq_shapes_ok refuses the MSVD width on this card")
    if not all(fused_att_decode.att_decode_shapes_ok(b, H, LENGTH, device)
               for b in KERNEL_BATCHES):
        raise SystemExit("att_decode_shapes_ok refuses the MSVD width on this card")
    if not fused_gru.gru_seq_shapes_ok(H, device):
        raise SystemExit("gru_seq_shapes_ok refuses the MSVD width on this card")
    if not all(fused_decode.argmax_linear_ok(b, H, v, device) for b in KERNEL_BATCHES
               for v in ARGMAX_VOCABS):
        raise SystemExit("argmax_linear_ok refuses the MSVD width on this card")
    if not all(fused_conv.conv3x3_ok((LENGTH * EXTRACT_CLIPS, hw, hw, c), k, device)
               for hw, c, k in VGG_LAYERS):
        raise SystemExit("conv3x3_ok refuses a VGG16 layer on this card")

    def stamp(label):
        print(f"elapsed after {label}: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. kernels against their plain versions
    errors, times = phase_kernels(torch, device, H, LENGTH, KERNEL_BATCHES, TIMED_BATCHES,
                                  reps=20, card=card)
    seq_errors, seq_times = phase_seq_kernels(torch, device, H, (LENGTH, 2 * LENGTH - 1),
                                              KERNEL_BATCHES, TIMED_BATCHES, reps=20, card=card)
    errors.update(seq_errors)
    times.update(seq_times)
    att_errors, att_times = phase_att_kernel(torch, device, H, LENGTH, KERNEL_BATCHES,
                                             TIMED_BATCHES, reps=20, card=card)
    errors.update(att_errors)
    times.update(att_times)
    gru_errors, gru_times = phase_seq_kernels(torch, device, H, (LENGTH, 2 * LENGTH - 1),
                                              KERNEL_BATCHES, TIMED_BATCHES, reps=20, card=card,
                                              cell="gru")
    errors.update(gru_errors)
    times.update(gru_times)
    am_errors, am_times = phase_argmax_kernel(torch, device, H, KERNEL_BATCHES, TIMED_BATCHES,
                                              reps=20, card=card)
    errors.update(am_errors)
    times.update(am_times)
    conv_errors, conv_totals = phase_conv_kernel(torch, device, VGG_LAYERS, CONV_CHECK_N, LENGTH,
                                                 reps=3, card=card)
    errors[("conv3x3_bn_relu", MAIN_BATCH, "float32", 0)] = max(
        e for (_, _, n), e in conv_errors.items() if n == "float32")
    times[("conv3x3_bn_relu", MAIN_BATCH, "float32", 0)] = conv_totals["float32"]
    stamp("phase 2")

    with tempfile.TemporaryDirectory() as root:
        ckpt = serving_checkpoint(torch, root, args.seed, H, FEAT, LENGTH, SERVE_CLIPS)
        # 3. the serving slice
        phase_slice(torch, device, ckpt, args.seed, H, FEAT, LENGTH, VOCAB,
                    batches=TIMED_BATCHES, reps=5, card=card)
        # 5. the beam slice: its main path
        beam_launches, beam_routes = phase_beam(torch, device, ckpt, args.seed, H, FEAT, LENGTH,
                                                VOCAB, batches=TIMED_BATCHES, reps=5, card=card)
        stamp("phases 3 and 5")
        # 9. serving artifacts of the same checkpoint: kernel #8's main path
        serve_launches, serve_routes, greedy_artifact = phase_serving(
            torch, device, ckpt, root, LENGTH, MAIN_BATCH, reps=5, card=card)
        stamp("phase 9")
        # 10. extraction and clip captioning: kernel #9's main path
        caption_launches, caption_routes = phase_extract(
            torch, device, args.seed, greedy_artifact, root, EXTRACT_CLIPS, LENGTH, CLIP_SHAPE,
            reps=3, card=card)
        stamp("phase 10")

    # 4. the training slice: the main path
    launches, _, routes1 = phase_train(torch, device, args.seed, H, FEAT, LENGTH, VOCAB,
                                       TRAIN_CLIPS, TRAIN_EPOCHS, batches=TIMED_BATCHES, reps=5,
                                       card=card)
    stamp("phase 4")
    # 6. two-layer training: the backward sequence kernel's main path
    launches2, _, routes2 = phase_train(torch, device, args.seed, H, FEAT, LENGTH, VOCAB,
                                        TRAIN_CLIPS, TRAIN_EPOCHS, batches=(MAIN_BATCH,), reps=5,
                                        card=card, num_layers=2, dtypes=("float32",))
    stamp("phase 6")
    # 7. the attention baseline: kernel #7's main path (its validation pass)
    att_launches, att_routes = phase_att(torch, device, args.seed, H, FEAT, LENGTH, VOCAB,
                                         TRAIN_CLIPS, TRAIN_EPOCHS, timed=TIMED_BATCHES, reps=5,
                                         card=card)
    stamp("phase 7")
    # 8. GRU S2VT: kernels #5 and #6 on their main paths (training; decode)
    gru_launches, _, gru_routes = phase_train(
        torch, device, args.seed, H, FEAT, LENGTH, VOCAB, TRAIN_CLIPS, TRAIN_EPOCHS,
        batches=(MAIN_BATCH,), reps=5, card=card, dtypes=("float32",), rnn_type="gru")
    stamp("phase 8")
    # 11. the scoring slice: the metric eval in training, cli.eval, the gate
    phase_score(torch, device, args.seed, H, FEAT, LENGTH, card)
    stamp("phase 11")

    # Each kernel's launches on its slice's main path; times at B = 16, f32,
    # at the T of that path (#5: GRU training, where 24 of its 32 phase-8
    # launches are; #8: at V = 10240; #9: VGG16's 13 layers at N = 80,
    # summed). The attention-decoder kernel has no library time.
    main_path = {"fused_s2vt_fwd": (launches, 2 * LENGTH - 1),
                 "fused_s2vt_bwd": (launches, 2 * LENGTH - 1),
                 "lstm_seq_fwd": ({"lstm_seq_fwd": beam_launches}, LENGTH),
                 "lstm_seq_bwd": (launches2, 2 * LENGTH - 1),
                 "att_decode_fwd": (att_launches, LENGTH - 1),
                 "gru_seq_fwd": (gru_launches, 2 * LENGTH - 1),
                 "gru_seq_bwd": (gru_launches, 2 * LENGTH - 1),
                 "argmax_linear": (serve_launches, VOCAB),
                 "conv3x3_bn_relu": (caption_launches, 0)}
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
        if name == "conv3x3_bn_relu":
            rows[-1]["route_launches"] = caption_routes
        if name == "argmax_linear":
            rows[-1]["route_launches"] = serve_routes
        if name == "lstm_seq_fwd":
            rows[-1]["route_launches"] = beam_routes
        if name == "lstm_seq_bwd":
            rows[-1]["route_launches"] = routes2["lstm_seq_bwd"]
        if name in ("fused_s2vt_fwd", "fused_s2vt_bwd"):
            rows[-1]["route_launches"] = routes1[name]
        if name in ("gru_seq_fwd", "gru_seq_bwd"):
            rows[-1]["route_launches"] = gru_routes[name]
        if name == "att_decode_fwd":
            rows[-1]["route_launches"] = att_routes[name]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
