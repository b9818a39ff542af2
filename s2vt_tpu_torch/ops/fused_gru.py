"""Per-layer GRU sequence op: one GRU layer over T steps in one CUDA launch
each way.

Counterpart of ``s2vt_tpu/ops/pallas_gru.py``. ``gru_sequence`` is the
drop-in for ``ops.rnn.rnn_sequence`` (GRU, forward direction) that
``TorchRNN`` takes with ``use_pallas``: every GRU S2VT runs its two RNNs
through it (the fused dual kernel is LSTM-only). The input projection
x @ W_ih^T + b_ih is one matrix product outside the kernels; the kernels run
only the recurrence (torch gate order r, z, n):

    forward   gh_t = h_{t-1} @ W_hh^T + b_hh
              r = sigmoid(xp_r + gh_r) ;  z = sigmoid(xp_z + gh_z)
              n = tanh(xp_n + r * gh_n) ;  h_t = (1 - z) * n + z * h_{t-1}
    backward  [dr_pre, dz_pre, dn_pre], dghn = cell_bwd(r, z, n, gh_n, h_{t-1}, dh)
              dh_{t-1} = dh * z + [dr_pre | dz_pre | dghn] @ W_hh

The reset gate multiplies the hidden projection's n-column, so b_hh cannot be
folded into the input projection: the forward adds it per step and stores
gh_n, and the backward's recurrent operand takes dghn = dn_pre * r where dxp
takes dn_pre. With ``compute_bf16`` only the operands of the recurrent
product (h and W_hh forward, the recurrent gate gradients and W_hh backward)
are rounded to bf16; the sums, the gate math and every stored value stay
float32, as in the TPU kernels. dW_hh and db_hh are float32 reductions
outside the kernel (``pallas_gru.py:236-240``).

``gru_seq_fwd`` and ``gru_seq_bwd`` launch the hand-written kernels
(``csrc/gru_seq_fwd.cu``, ``csrc/gru_seq_bwd.cu``) for CUDA tensors and run
``gru_seq_fwd_reference`` / ``gru_seq_bwd_reference``, the same recurrences
in plain PyTorch, only for CPU tensors. A CUDA tensor reaches a kernel or an
exception.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_rnn import _check_shapes
from s2vt_tpu_torch.ops.fused_s2vt import units_per_block
from s2vt_tpu_torch.ops.layers import mm_operand
from s2vt_tpu_torch.ops.rnn import LSTMState, input_projection

_FWD_LIB_NAME = "gru_seq_fwd"
_BWD_LIB_NAME = "gru_seq_bwd"


def _check_fwd_args(x_proj_t, w_hh, b_hh, h0):
    if x_proj_t.dim() != 3 or x_proj_t.shape[-1] % 3 or min(x_proj_t.shape) < 1:
        raise ValueError(f"x_proj_t must be [T, B, 3H] with T, B >= 1, got "
                         f"{tuple(x_proj_t.shape)}")
    T, B, G = x_proj_t.shape
    H = G // 3
    _check_shapes("gru_seq_fwd", (("x_proj_t", x_proj_t), ("w_hh", w_hh), ("b_hh", b_hh),
                                  ("h0", h0)), ((T, B, G), (G, H), (G,), (B, H)))


@torch.no_grad()
def gru_seq_fwd_reference(x_proj_t, w_hh, b_hh, h0, compute_bf16: bool):
    """Plain PyTorch version of the forward kernel (``_run_forward`` of the
    TPU kernel, which takes W_hh^T), step by step. x_proj_t [T, B, 3H] holds
    x @ W_ih^T + b_ih only; w_hh [3H, H]; b_hh [3H], added after the hidden
    product as JAX adds it; h0 [B, H]. All float32.

    Returns (h seq [T, B, H], post-activation r, z, n [T, B, 3H], gh_n
    [T, B, H] (W_hn h + b_hn, before the reset gate), hT [B, H]), all
    float32."""
    _check_fwd_args(x_proj_t, w_hh, b_hh, h0)
    T, B, G = x_proj_t.shape
    H = G // 3
    mmd = torch.bfloat16 if compute_bf16 else None
    w = mm_operand(w_hh, mmd).T
    h = h0
    outs = torch.empty(T, B, H, dtype=torch.float32, device=x_proj_t.device)
    ghn = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    for t in range(T):
        gh = mm_operand(h, mmd) @ w + b_hh
        xp = x_proj_t[t]
        r = torch.sigmoid(xp[:, :H] + gh[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        gates[t] = torch.cat([r, z, n], dim=-1)
        ghn[t], outs[t] = gh[:, 2 * H:], h
    return outs, gates, ghn, h


def _check_bwd_args(gates, ghn, hprev, w_hh, dout, dhT):
    if gates.dim() != 3 or gates.shape[-1] % 3 or min(gates.shape) < 1:
        raise ValueError(f"gates must be [T, B, 3H] with T, B >= 1, got {tuple(gates.shape)}")
    T, B, G = gates.shape
    H = G // 3
    _check_shapes("gru_seq_bwd", (("gates", gates), ("ghn", ghn), ("hprev", hprev),
                                  ("w_hh", w_hh), ("dout", dout), ("dhT", dhT)),
                  ((T, B, G), (T, B, H), (T, B, H), (G, H), (T, B, H), (B, H)))


@torch.no_grad()
def gru_seq_bwd_reference(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16: bool):
    """Plain PyTorch version of the backward kernel (``_run_backward`` of the
    TPU kernel): the reverse sweep. gates [T, B, 3H] are the stored
    post-activation r, z, n, ghn [T, B, H] the stored gh_n, hprev [T, B, H]
    the h before each step, w_hh [3H, H], dout [T, B, H] the cotangent of the
    h sequence and dhT [B, H] that of the final h. All float32; only
    [dr_pre | dz_pre | dghn] and W_hh are rounded to bf16, as the operands of
    the recurrent product.

    Returns (dxp [T, B, 3H] = [dr_pre | dz_pre | dn_pre], dghn [T, B, H],
    dh0 [B, H]), all float32."""
    _check_bwd_args(gates, ghn, hprev, w_hh, dout, dhT)
    H = ghn.shape[-1]
    mmd = torch.bfloat16 if compute_bf16 else None
    w = mm_operand(w_hh, mmd)
    dh_s = dhT
    dxp = torch.empty_like(gates)
    dghn = torch.empty_like(ghn)
    for t in range(gates.shape[0] - 1, -1, -1):
        r, z, n = gates[t, :, :H], gates[t, :, H:2 * H], gates[t, :, 2 * H:]
        dh = dh_s + dout[t]
        dz = dh * (hprev[t] - n)
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dghn[t] = dn_pre * r
        dr_pre = dn_pre * ghn[t] * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dgh = torch.cat([dr_pre, dz_pre, dghn[t]], dim=-1)
        dh_s = dh * z + mm_operand(dgh, mmd) @ w
    return dxp, dghn, dh_s


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    """The forward kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_FWD_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gru_seq_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.gru_seq_fwd.restype = ci
    lib.gru_seq_fwd_smem_bytes.argtypes = [ci, ci]
    lib.gru_seq_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_BWD_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gru_seq_bwd.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.gru_seq_bwd.restype = ci
    lib.gru_seq_bwd_smem_bytes.argtypes = [ci, ci]
    lib.gru_seq_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.gru_seq_bwd_units_per_block.argtypes = [ci, ci]
    lib.gru_seq_bwd_units_per_block.restype = ci
    return lib


def _gru_seq_fwd_impl(x_proj_t, w_hh, b_hh, h0, compute_bf16):
    if x_proj_t.device.type == "cpu":
        return gru_seq_fwd_reference(x_proj_t, w_hh, b_hh, h0, compute_bf16)
    _check_fwd_args(x_proj_t, w_hh, b_hh, h0)
    _build.check_cuda("gru_seq_fwd", (x_proj_t, w_hh, b_hh, h0))
    T, B, G = x_proj_t.shape
    H = G // 3
    dev = x_proj_t.device
    outs = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    ghn = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    hT = torch.empty(B, H, dtype=torch.float32, device=dev)
    units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.launch(_fwd_lib(), "gru_seq_fwd", "gru_seq_fwd",
                  (x_proj_t, w_hh, b_hh, h0, outs, gates, ghn, hT),
                  (T, B, H, units, int(compute_bf16)))
    gru_seq_fwd.launches += 1
    return outs, gates, ghn, hT


def _gru_seq_fwd_fake(x_proj_t, w_hh, b_hh, h0, compute_bf16):
    T, B, G = x_proj_t.shape
    outs = x_proj_t.new_empty(T, B, G // 3)
    return outs, torch.empty_like(x_proj_t), torch.empty_like(outs), outs.new_empty(B, G // 3)


_gru_seq_fwd_op = _build.define_op(
    "gru_seq_fwd", "(Tensor x_proj_t, Tensor w_hh, Tensor b_hh, Tensor h0, bool compute_bf16) "
    "-> (Tensor, Tensor, Tensor, Tensor)", _gru_seq_fwd_impl, _gru_seq_fwd_fake)


def gru_seq_fwd(x_proj_t, w_hh, b_hh, h0, compute_bf16: bool):
    """The forward (``gru_seq_fwd_reference``'s contract), a ``torch.library``
    operator so that an exported decode holds it.

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``gru_seq_fwd.launches``; CPU tensors run the plain version."""
    _build.check_device("gru_seq_fwd", x_proj_t)
    return _gru_seq_fwd_op(x_proj_t, w_hh, b_hh, h0, compute_bf16)


gru_seq_fwd.launches = 0


def gru_seq_bwd(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16: bool):
    """The backward (``gru_seq_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``gru_seq_bwd.launches``; CPU tensors run the plain version."""
    if gates.device.type == "cpu":
        return gru_seq_bwd_reference(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16)
    _check_bwd_args(gates, ghn, hprev, w_hh, dout, dhT)
    _build.check_cuda("gru_seq_bwd", (gates, ghn, hprev, w_hh, dout, dhT))
    T, B, G = gates.shape
    H = G // 3
    units = _bwd_units(H, gates.device)
    if not units:
        raise ValueError(f"gru_seq_bwd: hidden size {H} needs more blocks than the card has SMs")
    dxp = torch.empty_like(gates)
    dghn = torch.empty_like(ghn)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=gates.device)
    _build.launch(_bwd_lib(), "gru_seq_bwd", "gru_seq_bwd",
                  (gates, ghn, hprev, w_hh, dout, dhT, dxp, dghn, dh0),
                  (T, B, H, units, int(compute_bf16)))
    gru_seq_bwd.launches += 1
    return dxp, dghn, dh0


gru_seq_bwd.launches = 0


def _bwd_units(hidden: int, device: torch.device) -> int:
    """Hidden units per block of the backward kernel on ``device`` (0: none
    of its instantiations keeps one block per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _bwd_lib().gru_seq_bwd_units_per_block(hidden, sms)


def gru_seq_shapes_ok(hidden: int, device: Optional[torch.device] = None) -> bool:
    """Whether the GRU sequence kernels serve hidden size ``hidden`` on
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
    return (_fwd_lib().gru_seq_fwd_smem_bytes(hidden, units_per_block(hidden, sms)) <= smem
            and units > 0 and _bwd_lib().gru_seq_bwd_smem_bytes(hidden, units) <= smem)


class _GRUSeq(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` ``_gru_seq`` in ``pallas_gru.py``
    (``_gru_seq_fwd`` / ``_gru_seq_bwd``): the forward kernel saves the h,
    gate and gh_n sequences; the backward kernel gives dx_proj, dghn and dh0,
    and dW_hh and db_hh are float32 reductions of the recurrent-side gate
    gradients [dr_pre | dz_pre | dghn] against the previous-step h sequence."""

    @staticmethod
    def forward(ctx, x_proj_t, w_hh, b_hh, h0, compute_bf16: bool):
        args = [a.detach().float().contiguous() for a in (x_proj_t, w_hh, b_hh, h0)]
        outs, gates, ghn, hT = gru_seq_fwd(*args, compute_bf16)
        ctx.compute_bf16 = compute_bf16
        ctx.save_for_backward(outs, gates, ghn, args[1], args[3])
        return outs, hT

    @staticmethod
    def backward(ctx, dout, dhT):
        outs, gates, ghn, w_hh, h0 = ctx.saved_tensors
        hprev = torch.cat([h0[None], outs[:-1]], dim=0)       # h BEFORE step t
        dxp, dghn, dh0 = gru_seq_bwd(gates, ghn, hprev, w_hh,
                                     *(g.float().contiguous() for g in (dout, dhT)),
                                     ctx.compute_bf16)
        H = hprev.shape[-1]
        dgh = torch.cat([dxp[..., :2 * H], dghn], dim=-1).reshape(-1, 3 * H)
        dw = dgh.T @ hprev.reshape(-1, H)
        return dxp, dw, dgh.sum(dim=0), dh0, None


def gru_sequence(xs: torch.Tensor, params, h0: Optional[LSTMState] = None,
                 compute_dtype=None) -> Tuple[torch.Tensor, LSTMState]:
    """Drop-in for ``ops.rnn.rnn_sequence`` (GRU, forward direction),
    differentiable: xs [B, T, in] -> (outputs [B, T, H], final state). The
    state's c is carried through untouched, as ``gru_step`` carries it."""
    B = xs.shape[0]
    H = params["w_hh"].shape[1]
    if h0 is None:
        z = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
        h0 = LSTMState(z, z)
    x_proj = input_projection(xs, params, compute_dtype)
    outs, hT = _GRUSeq.apply(x_proj.transpose(0, 1), params["w_hh"], params["b_hh"], h0.h,
                             compute_dtype == torch.bfloat16)
    return outs.transpose(0, 1), LSTMState(hT, h0.c)
