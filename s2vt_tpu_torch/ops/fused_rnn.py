"""Per-layer LSTM sequence op: one LSTM layer over T steps in one CUDA launch
each way.

Counterpart of ``s2vt_tpu/ops/pallas_rnn.py``. ``lstm_sequence`` is the
drop-in for ``ops.rnn.rnn_sequence`` (LSTM, forward direction) that
``TorchRNN`` takes with ``use_pallas``: the beam encode, S2VT with
``num_layers > 1``, bidirectional encoders. The input projection (with both
biases) is one matrix product outside the kernels; the kernels run only the
recurrence:

    forward   gates_t = x_proj_t + h_{t-1} @ W_hh^T ;  c_t, h_t = cell(gates_t, c_{t-1})
    backward  dgates_t = cell_bwd(gates_t, c_t, c_{t-1}, dh_t + dout_t, dc carry)
              dh_{t-1} = dgates_t @ W_hh

With ``compute_bf16`` only the operands of the recurrent product (h and W_hh
forward, dgates and W_hh backward) are rounded to bf16; the sums, the cell
math and every stored value stay float32, as in the TPU kernels. dW_hh is one
float32 matrix product outside the kernel (``pallas_rnn.py:295-298``).

``lstm_seq_fwd`` and ``lstm_seq_bwd`` launch the hand-written kernels
(``csrc/lstm_seq_fwd.cu``, ``csrc/lstm_seq_bwd.cu``) for CUDA tensors and run
``lstm_seq_fwd_reference`` / ``lstm_seq_bwd_reference``, the same recurrences
in plain PyTorch, only for CPU tensors. A CUDA tensor reaches a kernel or an
exception.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_s2vt import _cell, _cell_bwd, units_per_block
from s2vt_tpu_torch.ops.layers import mm_operand
from s2vt_tpu_torch.ops.rnn import LSTMState, input_projection

_FWD_LIB_NAME = "lstm_seq_fwd"
_BWD_LIB_NAME = "lstm_seq_bwd"


def _check_shapes(name: str, tensors, shapes) -> None:
    for (tname, t), shape in zip(tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices: {sorted(map(str, devices))}")


def _check_fwd_args(x_proj_t, w_hh, h0, c0):
    if x_proj_t.dim() != 3 or x_proj_t.shape[-1] % 4 or min(x_proj_t.shape) < 1:
        raise ValueError(f"x_proj_t must be [T, B, 4H] with T, B >= 1, got "
                         f"{tuple(x_proj_t.shape)}")
    T, B, G = x_proj_t.shape
    H = G // 4
    _check_shapes("lstm_seq_fwd", (("x_proj_t", x_proj_t), ("w_hh", w_hh), ("h0", h0),
                                   ("c0", c0)), ((T, B, G), (G, H), (B, H), (B, H)))


@torch.no_grad()
def lstm_seq_fwd_reference(x_proj_t, w_hh, h0, c0, compute_bf16: bool):
    """Plain PyTorch version of the forward kernel (``_run_forward`` of the
    TPU kernel, which takes W_hh^T), step by step. x_proj_t [T, B, 4H] holds
    x @ W_ih^T + b_ih + b_hh; w_hh [4H, H]; h0, c0 [B, H]. All float32.

    Returns (h seq [T, B, H], post-activation gates [T, B, 4H], c seq
    [T, B, H], hT, cT [B, H]), all float32."""
    _check_fwd_args(x_proj_t, w_hh, h0, c0)
    T, B, G = x_proj_t.shape
    mmd = torch.bfloat16 if compute_bf16 else None
    w = mm_operand(w_hh, mmd).T
    h, c = h0, c0
    outs = torch.empty(T, B, G // 4, dtype=torch.float32, device=x_proj_t.device)
    cseq = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    for t in range(T):
        gates[t], c, h = _cell(x_proj_t[t] + mm_operand(h, mmd) @ w, c)
        outs[t], cseq[t] = h, c
    return outs, gates, cseq, h, c


def _check_bwd_args(gates, cseq, cprev, w_hh, dout, dhT, dcT):
    if gates.dim() != 3 or gates.shape[-1] % 4 or min(gates.shape) < 1:
        raise ValueError(f"gates must be [T, B, 4H] with T, B >= 1, got {tuple(gates.shape)}")
    T, B, G = gates.shape
    H = G // 4
    _check_shapes("lstm_seq_bwd", (("gates", gates), ("cseq", cseq), ("cprev", cprev),
                                   ("w_hh", w_hh), ("dout", dout), ("dhT", dhT), ("dcT", dcT)),
                  ((T, B, G), (T, B, H), (T, B, H), (G, H), (T, B, H), (B, H), (B, H)))


@torch.no_grad()
def lstm_seq_bwd_reference(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16: bool):
    """Plain PyTorch version of the backward kernel (``_run_backward`` of the
    TPU kernel): the reverse sweep. gates [T, B, 4H] are the stored
    post-activation gates, cseq and cprev [T, B, H] the c after and before
    each step, w_hh [4H, H], dout [T, B, H] the cotangent of the h sequence
    and dhT, dcT [B, H] those of the final state. All float32; the gate
    gradients are rounded to bf16 only as the operand of ``dgates @ W_hh``.

    Returns (dxp [T, B, 4H], dh0, dc0 [B, H]), all float32."""
    _check_bwd_args(gates, cseq, cprev, w_hh, dout, dhT, dcT)
    mmd = torch.bfloat16 if compute_bf16 else None
    w = mm_operand(w_hh, mmd)
    dh, dc = dhT, dcT
    dxp = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        dg, dc = _cell_bwd(gates[t], cseq[t], cprev[t], dh + dout[t], dc)
        dxp[t] = dg
        dh = mm_operand(dg, mmd) @ w
    return dxp, dh, dc


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    """The forward kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_FWD_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_seq_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.lstm_seq_fwd.restype = ci
    lib.lstm_seq_fwd_smem_bytes.argtypes = [ci, ci]
    lib.lstm_seq_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_BWD_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_seq_bwd.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.lstm_seq_bwd.restype = ci
    lib.lstm_seq_bwd_smem_bytes.argtypes = [ci, ci]
    lib.lstm_seq_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_seq_bwd_units_per_block.argtypes = [ci, ci]
    lib.lstm_seq_bwd_units_per_block.restype = ci
    return lib


def _lstm_seq_fwd_impl(x_proj_t, w_hh, h0, c0, compute_bf16):
    if x_proj_t.device.type == "cpu":
        outs, gates, cseq, hT, cT = lstm_seq_fwd_reference(x_proj_t, w_hh, h0, c0,
                                                           compute_bf16)
        return outs, gates, cseq, torch.stack([hT, cT])
    _check_fwd_args(x_proj_t, w_hh, h0, c0)
    _build.check_cuda("lstm_seq_fwd", (x_proj_t, w_hh, h0, c0))
    T, B, G = x_proj_t.shape
    H = G // 4
    dev = x_proj_t.device
    outs = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    cseq = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    fin = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.launch(_fwd_lib(), "lstm_seq_fwd", "lstm_seq_fwd",
                  (x_proj_t, w_hh, h0, c0, outs, gates, cseq, fin),
                  (T, B, H, units, int(compute_bf16)))
    lstm_seq_fwd.launches += 1
    return outs, gates, cseq, fin


def _lstm_seq_fwd_fake(x_proj_t, w_hh, h0, c0, compute_bf16):
    T, B, G = x_proj_t.shape
    outs = x_proj_t.new_empty(T, B, G // 4)
    return outs, torch.empty_like(x_proj_t), torch.empty_like(outs), outs.new_empty(2, B, G // 4)


_lstm_seq_fwd_op = _build.define_op(
    "lstm_seq_fwd", "(Tensor x_proj_t, Tensor w_hh, Tensor h0, Tensor c0, bool compute_bf16) "
    "-> (Tensor, Tensor, Tensor, Tensor)", _lstm_seq_fwd_impl, _lstm_seq_fwd_fake)


def lstm_seq_fwd(x_proj_t, w_hh, h0, c0, compute_bf16: bool):
    """The forward (``lstm_seq_fwd_reference``'s contract), a ``torch.library``
    operator so that an exported decode holds it.

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``lstm_seq_fwd.launches``; CPU tensors run the plain version."""
    _build.check_device("lstm_seq_fwd", x_proj_t)
    outs, gates, cseq, fin = _lstm_seq_fwd_op(x_proj_t, w_hh, h0, c0, compute_bf16)
    return outs, gates, cseq, fin[0], fin[1]


lstm_seq_fwd.launches = 0


def lstm_seq_bwd(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16: bool):
    """The backward (``lstm_seq_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``lstm_seq_bwd.launches``; CPU tensors run the plain version."""
    if gates.device.type == "cpu":
        return lstm_seq_bwd_reference(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16)
    _check_bwd_args(gates, cseq, cprev, w_hh, dout, dhT, dcT)
    _build.check_cuda("lstm_seq_bwd", (gates, cseq, cprev, w_hh, dout, dhT, dcT))
    T, B, G = gates.shape
    H = G // 4
    units = _bwd_units(H, gates.device)
    if not units:
        raise ValueError(f"lstm_seq_bwd: hidden size {H} needs more blocks than the card has SMs")
    dxp = torch.empty_like(gates)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=gates.device)
    dc0 = torch.empty_like(dh0)
    _build.launch(_bwd_lib(), "lstm_seq_bwd", "lstm_seq_bwd",
                  (gates, cseq, cprev, w_hh, dout, dhT, dcT, dxp, dh0, dc0),
                  (T, B, H, units, int(compute_bf16)))
    lstm_seq_bwd.launches += 1
    return dxp, dh0, dc0


lstm_seq_bwd.launches = 0


def _bwd_units(hidden: int, device: torch.device) -> int:
    """Hidden units per block of the backward kernel on ``device`` (0: none
    of its instantiations keeps one block per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _bwd_lib().lstm_seq_bwd_units_per_block(hidden, sms)


def lstm_seq_shapes_ok(hidden: int, device: Optional[torch.device] = None) -> bool:
    """Whether the sequence kernels serve hidden size ``hidden`` on
    ``device``: on a card, each kernel's blocks fit one per SM with their
    resident weights in opt-in shared memory (on an H100, H <= ~1050). On the
    CPU the plain versions serve any width. (The TPU gate
    ``pallas_shapes_ok`` -- B % 8, B <= 96, H % 128 -- is a fact of the TPU's
    VMEM and tiles.)"""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    props = torch.cuda.get_device_properties(device)
    sms, smem = props.multi_processor_count, props.shared_memory_per_block_optin
    units = _bwd_units(hidden, device)
    return (_fwd_lib().lstm_seq_fwd_smem_bytes(hidden, units_per_block(hidden, sms)) <= smem
            and units > 0 and _bwd_lib().lstm_seq_bwd_smem_bytes(hidden, units) <= smem)


class _LSTMSeq(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` ``_lstm_seq`` in ``pallas_rnn.py``
    (``_lstm_seq_fwd`` / ``_lstm_seq_bwd``): the forward kernel saves the h,
    gate and c sequences; the backward kernel gives dx_proj, dh0 and dc0, and
    dW_hh is one float32 matrix product of dx_proj with the previous-step h
    sequence."""

    @staticmethod
    def forward(ctx, x_proj_t, w_hh, h0, c0, compute_bf16: bool):
        args = [a.detach().float().contiguous() for a in (x_proj_t, w_hh, h0, c0)]
        outs, gates, cseq, hT, cT = lstm_seq_fwd(*args, compute_bf16)
        ctx.compute_bf16 = compute_bf16
        ctx.save_for_backward(outs, gates, cseq, *args[1:])
        return outs, hT, cT

    @staticmethod
    def backward(ctx, dout, dhT, dcT):
        outs, gates, cseq, w_hh, h0, c0 = ctx.saved_tensors
        hprev = torch.cat([h0[None], outs[:-1]], dim=0)       # state BEFORE step t
        cprev = torch.cat([c0[None], cseq[:-1]], dim=0)
        dxp, dh0, dc0 = lstm_seq_bwd(gates, cseq, cprev, w_hh,
                                     *(g.float().contiguous() for g in (dout, dhT, dcT)),
                                     ctx.compute_bf16)
        H = hprev.shape[-1]
        dw = dxp.reshape(-1, 4 * H).T @ hprev.reshape(-1, H)
        return dxp, dw, dh0, dc0, None


def lstm_sequence(xs: torch.Tensor, params, h0: Optional[LSTMState] = None,
                  compute_dtype=None) -> Tuple[torch.Tensor, LSTMState]:
    """Drop-in for ``ops.rnn.rnn_sequence`` (LSTM, forward direction),
    differentiable: xs [B, T, in] -> (outputs [B, T, H], final state)."""
    B = xs.shape[0]
    H = params["w_hh"].shape[1]
    if h0 is None:
        z = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
        h0 = LSTMState(z, z)
    x_proj = input_projection(xs, params, compute_dtype) + params["b_hh"].float()
    outs, hT, cT = _LSTMSeq.apply(x_proj.transpose(0, 1), params["w_hh"], h0.h, h0.c,
                                  compute_dtype == torch.bfloat16)
    return outs.transpose(0, 1), LSTMState(hT, cT)
