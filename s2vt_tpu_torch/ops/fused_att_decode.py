"""Attention-decoder sequence op: the teacher-forced decoder loop of the
attention baseline in one CUDA launch (forward only).

Counterpart of ``s2vt_tpu/ops/pallas_att_decode.py``. From h = c = 0 and
ctx = ctx0, for t = 0 .. T-1:

    gates = xp_t + ctx @ W_ctx^T + h @ W_hh^T    (xp_t: embedding half of W_ih, b_ih, b_hh)
    c, h  = LSTM cell (i, f, g, o)
    dw    = h @ W_att^T + b_att
    et    = sum_H tanh(enc_wh + dw[:, None]) * w_apply
    ctx   = sum_L softmax_L(et)[:, :, None] * enc_out
    out_t = h

Weights keep the torch layout ([out, in]): W_ctx [4H, 2H] is the context half
of the decoder's W_ih, W_hh [4H, H], W_att [H, H] is ``att_prev_hid.weight``.
It implements ``att_mode='softmax'`` only and has no backward, as the TPU
kernel. With ``compute_bf16`` it rounds what the TPU kernel rounds: the three
weights, enc_wh and enc_out, and the product operands ctx and h; the w_apply
reduction, the softmax and every state stay float32.

``att_decode_fwd`` launches the hand-written kernel (``csrc/att_decode_fwd.cu``)
for CUDA tensors and runs ``att_decode_fwd_reference``, the same loop in plain
PyTorch, only for CPU tensors. A CUDA tensor reaches the kernel or an
exception.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_s2vt import _cell, units_per_block
from s2vt_tpu_torch.ops.layers import mm_operand

_LIB_NAME = "att_decode_fwd"
_ARGS = ("xp_t", "w_ctx", "w_hh", "w_att", "b_att", "w_apply", "enc_wh", "enc_out", "ctx0")


def _check_args(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0):
    if xp_t.dim() != 3 or xp_t.shape[-1] % 4 or min(xp_t.shape) < 1:
        raise ValueError(f"xp_t must be [T, B, 4H] with T, B >= 1, got {tuple(xp_t.shape)}")
    if enc_out.dim() != 3 or enc_out.shape[1] < 1:
        raise ValueError(f"enc_out must be [B, L, 2H] with L >= 1, got {tuple(enc_out.shape)}")
    T, B, G = xp_t.shape
    H, L = G // 4, enc_out.shape[1]
    tensors = (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0)
    shapes = ((T, B, G), (G, 2 * H), (G, H), (H, H), (H,), (H,), (B, L, H), (B, L, 2 * H),
              (B, 2 * H))
    for name, t, shape in zip(_ARGS, tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"att_decode_fwd: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"att_decode_fwd: {name} must be float32, got {t.dtype}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"att_decode_fwd: inputs on several devices: "
                         f"{sorted(map(str, devices))}")


@torch.no_grad()
def att_decode_fwd_reference(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0,
                             compute_bf16: bool):
    """Plain PyTorch version of the kernel (``_kernel`` of the TPU kernel),
    step by step. Shapes as ``_check_args``; all float32.

    Returns the h sequence [T, B, H], float32."""
    _check_args(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0)
    T, B, G = xp_t.shape
    mmd = torch.bfloat16 if compute_bf16 else None
    wc, wh, wa = (mm_operand(w, mmd).T for w in (w_ctx, w_hh, w_att))
    ewh, eout = mm_operand(enc_wh, mmd), mm_operand(enc_out, mmd)   # stored values
    h = c = torch.zeros(B, G // 4, dtype=torch.float32, device=xp_t.device)
    ctx = ctx0
    out = torch.empty(T, B, G // 4, dtype=torch.float32, device=xp_t.device)
    for t in range(T):
        gates = xp_t[t] + mm_operand(ctx, mmd) @ wc + mm_operand(h, mmd) @ wh
        _, c, h = _cell(gates, c)
        out[t] = h
        dw = mm_operand(h, mmd) @ wa + b_att                             # [B, H]
        et = (torch.tanh(ewh + dw[:, None, :]) * w_apply).sum(dim=2)     # [B, L]
        at = torch.softmax(et, dim=1)
        ctx = (at[:, :, None] * eout).sum(dim=1)                         # [B, 2H]
    return out


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.att_decode_fwd.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    lib.att_decode_fwd.restype = ci
    lib.att_decode_fwd_smem_bytes.argtypes = [ci] * 4
    lib.att_decode_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.att_decode_fwd_tile_rows.argtypes = [ci, ci, ci, ctypes.c_size_t]
    lib.att_decode_fwd_tile_rows.restype = ci
    return lib


def _layout(hidden: int, enc_len: int, device: torch.device):
    """(units per block, rows per batch tile) of the kernel on ``device``;
    rows 0 where its block does not fit in opt-in shared memory."""
    props = torch.cuda.get_device_properties(device)
    units = units_per_block(hidden, props.multi_processor_count)
    rows = _kernel_lib().att_decode_fwd_tile_rows(hidden, enc_len, units,
                                                  props.shared_memory_per_block_optin)
    return units, rows


def att_decode_shapes_ok(batch: int, hidden: int, enc_len: int,
                         device: Optional[torch.device] = None) -> bool:
    """Whether the kernel serves these shapes on ``device``: on a card, one
    block per SM holds its units' gate rows of [W_ctx | W_hh] and W_att rows
    in opt-in shared memory (on an H100, H <= 660 at L = 80); the batch is
    taken in tiles of rows and the encoder tensors are read from device
    memory, so any batch is served. On the CPU the plain version serves any
    shapes. (The TPU gate -- B % 8, B <= 32, H % 128 -- is a fact of the
    TPU's VMEM and tiles.)"""
    if batch < 1 or hidden < 1 or enc_len < 1:
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    return _layout(hidden, enc_len, device)[1] > 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel loads float4s)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def att_decode_fwd(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0,
                   compute_bf16: bool):
    """The decode loop (``att_decode_fwd_reference``'s contract).

    CUDA tensors launch the kernel once and add one to
    ``att_decode_fwd.launches``; CPU tensors run the plain version."""
    args = (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0)
    if xp_t.device.type == "cpu":
        return att_decode_fwd_reference(*args, compute_bf16)
    _check_args(*args)
    _build.check_cuda("att_decode_fwd", tuple(t.contiguous() for t in args))
    T, B, G = xp_t.shape
    H, L = G // 4, enc_out.shape[1]
    dev = xp_t.device
    units, rows = _layout(H, L, dev)
    if not rows:
        raise ValueError(f"att_decode_fwd: hidden size {H} at L={L} does not fit one block "
                         "per SM (att_decode_shapes_ok)")
    args = tuple(_aligned(t) for t in args)
    out = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    scratch = torch.empty(B * (4 * H + L), dtype=torch.float32, device=dev)
    _build.launch(_kernel_lib(), "att_decode_fwd", "att_decode_fwd", (*args, out, scratch),
                  (T, B, H, L, units, rows, int(compute_bf16)))
    att_decode_fwd.launches += 1
    return out


att_decode_fwd.launches = 0


def att_decode_sequence(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0,
                        compute_dtype=None) -> torch.Tensor:
    """Drop-in for ``att_decode_sequence_pallas`` with torch-layout weights:
    the h sequence [T, B, H] (float32) of the teacher-forced decoder loop.
    No gradient flows through it (the TPU kernel has no backward)."""
    args = (a.detach().float() for a in
            (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0))
    return att_decode_fwd(*args, compute_dtype == torch.bfloat16)
