"""Fused dual-LSTM S2VT core: both LSTM chains in one CUDA launch each way.

Counterpart of ``s2vt_tpu/ops/pallas_s2vt.py``. The S2VT recurrence is two
stacked LSTMs where word_rnn's step-t input holds vid_rnn's step-t output.
Skewed by one step, both chains advance together:

    iteration t:  z = [h1_{t-1} | h2_{t-2}],  big = z @ W_all
      layer 1 (t < T):       gates1_t     = x1_t     + big[:, :4H]
      layer 2 (1 <= t <= T): gates2_{t-1} = x2_{t-1} + big[:, 4H:]

    W_all = [[W1hh^T, W2v^T ],   W2v = the word W_ih columns that read
             [0,      W2hh^T]]   vid_rnn's output

The backward is the same sweep in reverse: ``[dg1 | dg2] @ [W1hh; W2v]``
gives dh1 and ``dg2 @ W2hh`` gives dh2, one step apart.

``fused_s2vt_fwd`` and ``fused_s2vt_bwd`` launch the hand-written kernels
(``csrc/fused_s2vt_fwd.cu``, ``csrc/fused_s2vt_bwd.cu``) for CUDA tensors and
run ``fused_s2vt_fwd_reference`` / ``fused_s2vt_bwd_reference``, the same
recurrences in plain PyTorch, only for CPU tensors. A CUDA tensor reaches a
kernel or an exception. ``s2vt_fused_out2`` is differentiable through both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build

_LIB_NAME = "fused_s2vt_fwd"
_BWD_LIB_NAME = "fused_s2vt_bwd"
_MM_DTYPES = (torch.float32, torch.bfloat16)


def _cell(gates: torch.Tensor, c_prev: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return torch.cat([i, f, g, o], dim=-1), c, h


def _assemble_wall(w1hh: torch.Tensor, w2v: torch.Tensor, w2hh: torch.Tensor) -> torch.Tensor:
    """[2H, 8H]: z = [h1 | h2] -> [gates1 | gates2]."""
    G, H = w1hh.shape
    top = torch.cat([w1hh.T, w2v.T], dim=1)
    bot = torch.cat([torch.zeros(H, G, dtype=w1hh.dtype, device=w1hh.device), w2hh.T], dim=1)
    return torch.cat([top, bot], dim=0)


def _cell_bwd(post: torch.Tensor, c: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor,
              dc_carry: torch.Tensor):
    """LSTM cell backward: post-activation gates + dh/dc -> (dgates_pre,
    dc_prev_partial)."""
    i, f, g, o = post.chunk(4, dim=-1)
    tanh_c = torch.tanh(c)
    dc = dc_carry + dh * o * (1.0 - tanh_c * tanh_c)
    d_i = dc * g * i * (1.0 - i)
    d_f = dc * c_prev * f * (1.0 - f)
    d_g = dc * i * (1.0 - g * g)
    d_o = dh * tanh_c * o * (1.0 - o)
    return torch.cat([d_i, d_f, d_g, d_o], dim=-1), dc * f


def _assemble_wb(w1hh: torch.Tensor, w2v: torch.Tensor, w2hh: torch.Tensor):
    """Backward chain weights, zero-block-free: wb1 [8H, H] maps
    [dgates1 | dgates2] -> dh1 (= dg1 @ w1hh + dg2 @ w2v); wb2 [4H, H] maps
    dgates2 -> dh2 (= dg2 @ w2hh)."""
    return torch.cat([w1hh, w2v], dim=0), w2hh


def _h_from(post: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """h = o * tanh(c) from the stored post-activation gates."""
    H = post.shape[-1] // 4
    return post[..., 3 * H:].float() * torch.tanh(c)


def _check_args(x1, x2, w1hh, w2v, w2hh, snap_idx: int):
    if x1.dim() != 3 or x1.shape[-1] % 4 or x1.shape[0] < 1 or x1.shape[1] < 1:
        raise ValueError(f"x1 must be [T, B, 4H] with T, B >= 1, got {tuple(x1.shape)}")
    T, B, G = x1.shape
    H = G // 4
    if tuple(x2.shape) != (T, B, G):
        raise ValueError(f"x2 must be {(T, B, G)}, got {tuple(x2.shape)}")
    for name, w in (("w1hh", w1hh), ("w2v", w2v), ("w2hh", w2hh)):
        if tuple(w.shape) != (G, H):
            raise ValueError(f"{name} must be {(G, H)}, got {tuple(w.shape)}")
    tensors = (x1, x2, w1hh, w2v, w2hh)
    if x1.dtype not in _MM_DTYPES or any(t.dtype != x1.dtype for t in tensors):
        raise TypeError("x1, x2 and the weights must share one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in tensors]}")
    if any(t.device != x1.device for t in tensors):
        raise ValueError(f"inputs on several devices: {[t.device for t in tensors]}")
    if not 0 <= snap_idx < T:
        raise ValueError(f"snap_idx {snap_idx} outside [0, {T})")


@torch.no_grad()
def fused_s2vt_fwd_reference(x1, x2, w1hh, w2v, w2hh, snap_idx: int):
    """Plain PyTorch version of the kernel: the same skewed recurrence, one
    ``z @ W_all`` per iteration, the same casts. Inputs are in the matmul
    dtype (float32 or bf16); the state and cell math stay float32 and the
    gates are stored in the matmul dtype.

    Returns (g1, c1, g2, c2 [T, B, 4H or H] in time order, h1T, c1T, h2T,
    c2T, h2snap, c2snap [B, H])."""
    _check_args(x1, x2, w1hh, w2v, w2hh, snap_idx)
    mmd, dev = x1.dtype, x1.device
    T, B, G = x1.shape
    H = G // 4
    wall = _assemble_wall(w1hh, w2v, w2hh).float()
    h1 = c1 = h2 = c2 = torch.zeros(B, H, dtype=torch.float32, device=dev)
    g1s = torch.empty(T, B, G, dtype=mmd, device=dev)
    g2s = torch.empty(T, B, G, dtype=mmd, device=dev)
    c1s = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    c2s = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    h2snap = c2snap = None
    for t in range(T + 1):
        big = torch.cat([h1, h2], dim=-1).to(mmd).float() @ wall
        if t < T:
            post, c1, h1 = _cell(x1[t].float() + big[:, :G], c1)
            g1s[t], c1s[t] = post, c1
        if t >= 1:
            s = t - 1
            post, c2, h2 = _cell(x2[s].float() + big[:, G:], c2)
            g2s[s], c2s[s] = post, c2
            if s == snap_idx:
                h2snap, c2snap = h2, c2
    return g1s, c1s, g2s, c2s, h1, c1, h2, c2, h2snap, c2snap


def _check_bwd_args(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh):
    if g1.dim() != 3 or g1.shape[-1] % 4 or g1.shape[0] < 1 or g1.shape[1] < 1:
        raise ValueError(f"g1 must be [T, B, 4H] with T, B >= 1, got {tuple(g1.shape)}")
    T, B, G = g1.shape
    H = G // 4
    if tuple(g2.shape) != (T, B, G):
        raise ValueError(f"g2 must be {(T, B, G)}, got {tuple(g2.shape)}")
    for name, t in (("c1", c1), ("c2", c2), ("dout2", dout2)):
        if tuple(t.shape) != (T, B, H):
            raise ValueError(f"{name} must be {(T, B, H)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, w in (("w1hh", w1hh), ("w2v", w2v), ("w2hh", w2hh)):
        if tuple(w.shape) != (G, H):
            raise ValueError(f"{name} must be {(G, H)}, got {tuple(w.shape)}")
    mm = (g1, g2, w1hh, w2v, w2hh)
    if g1.dtype not in _MM_DTYPES or any(t.dtype != g1.dtype for t in mm):
        raise TypeError("the gates and the weights must share one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in mm]}")
    tensors = (g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    if any(t.device != g1.device for t in tensors):
        raise ValueError(f"inputs on several devices: {[t.device for t in tensors]}")


@torch.no_grad()
def fused_s2vt_bwd_reference(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh):
    """Plain PyTorch version of the backward kernel (``_run_bwd`` of the TPU
    kernel): the reverse sweep with the forward's one-step skew, the same
    casts. g1, g2 [T, B, 4H] are the stored post-activation gates and the
    weights [4H, H] are in the matmul dtype; c1, c2 and dout2 [T, B, H] are
    float32. The gate gradients are rounded to the matmul dtype before the
    products; sums, the cell math and the dc carries stay float32.

    Returns (dxp1, dxp2) [T, B, 4H] in time order, in the matmul dtype."""
    _check_bwd_args(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    mmd, dev = g1.dtype, g1.device
    T, B, G = g1.shape
    H = G // 4
    wb1, wb2 = (w.float() for w in _assemble_wb(w1hh, w2v, w2hh))
    zero = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dg1 = dg2 = torch.zeros(B, G, dtype=torch.float32, device=dev)
    dc1 = dc2 = zero
    dxp1 = torch.empty(T, B, G, dtype=mmd, device=dev)
    dxp2 = torch.empty(T, B, G, dtype=mmd, device=dev)
    for j in range(T + 1):
        dh1 = torch.cat([dg1, dg2], dim=-1).to(mmd).float() @ wb1
        dh2 = dg2.to(mmd).float() @ wb2
        if j <= T - 1:                    # layer 2 at t2 = T-1-j
            t2 = T - 1 - j
            c_prev = c2[t2 - 1] if t2 >= 1 else zero
            dg2, dc2 = _cell_bwd(g2[t2].float(), c2[t2], c_prev, dh2 + dout2[t2], dc2)
            dxp2[t2] = dg2
        if j >= 1:                        # layer 1 at t1 = T-j
            t1 = T - j
            c_prev = c1[t1 - 1] if t1 >= 1 else zero
            dg1, dc1 = _cell_bwd(g1[t1].float(), c1[t1], c_prev, dh1, dc1)
            dxp1[t1] = dg1
    return dxp1, dxp2


def units_per_block(dim_hid: int, sm_count: int) -> int:
    """Hidden units each block owns: the fewest that keep one block per SM."""
    return -(-dim_hid // sm_count)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.s2vt_fused_fwd.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.s2vt_fused_fwd.restype = ci
    lib.s2vt_fused_fwd_smem_bytes.argtypes = [ci, ci]
    lib.s2vt_fused_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _fused_s2vt_fwd_impl(x1, x2, w1hh, w2v, w2hh, snap_idx):
    if x1.device.type == "cpu":
        g1, c1, g2, c2, *fin = fused_s2vt_fwd_reference(x1, x2, w1hh, w2v, w2hh, snap_idx)
        return g1, c1, g2, c2, torch.stack(fin)
    _check_args(x1, x2, w1hh, w2v, w2hh, snap_idx)
    tensors = (x1, x2, w1hh, w2v, w2hh)
    _build.check_cuda("fused_s2vt_fwd", tensors)
    T, B, G = x1.shape
    H = G // 4
    if H % 2:
        raise ValueError(f"the kernel loads h as float4 and needs an even H, got {H}")
    dev, mmd = x1.device, x1.dtype
    lib = _kernel_lib()
    units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
    g1 = torch.empty(T, B, G, dtype=mmd, device=dev)
    g2 = torch.empty(T, B, G, dtype=mmd, device=dev)
    c1 = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    c2 = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    fin = torch.empty(6, B, H, dtype=torch.float32, device=dev)
    hbuf = torch.zeros(2, B, 2 * H, dtype=torch.float32, device=dev)
    _build.launch(lib, "s2vt_fused_fwd", "fused_s2vt_fwd", (*tensors, g1, c1, g2, c2, fin, hbuf),
                  (T, B, H, units, snap_idx, int(mmd == torch.bfloat16)))
    fused_s2vt_fwd.launches += 1
    return g1, c1, g2, c2, fin


def _fused_s2vt_fwd_fake(x1, x2, w1hh, w2v, w2hh, snap_idx):
    T, B, G = x1.shape
    g = x1.new_empty(T, B, G)
    c = x1.new_empty(T, B, G // 4, dtype=torch.float32)
    return g, c, torch.empty_like(g), torch.empty_like(c), c.new_empty(6, B, G // 4)


_fused_s2vt_fwd_op = _build.define_op(
    "fused_s2vt_fwd", "(Tensor x1, Tensor x2, Tensor w1hh, Tensor w2v, Tensor w2hh, "
    "int snap_idx) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _fused_s2vt_fwd_impl, _fused_s2vt_fwd_fake)


def fused_s2vt_fwd(x1, x2, w1hh, w2v, w2hh, snap_idx: int):
    """The fused forward (``fused_s2vt_fwd_reference``'s contract), a
    ``torch.library`` operator so that an exported decode holds it.

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``fused_s2vt_fwd.launches``; CPU tensors run the plain version."""
    _build.check_device("fused_s2vt_fwd", x1)
    g1, c1, g2, c2, fin = _fused_s2vt_fwd_op(x1, x2, w1hh, w2v, w2hh, snap_idx)
    return (g1, c1, g2, c2, *fin.unbind(0))


fused_s2vt_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_kernel_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_BWD_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.s2vt_fused_bwd.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.s2vt_fused_bwd.restype = ci
    lib.s2vt_fused_bwd_smem_bytes.argtypes = [ci]
    lib.s2vt_fused_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.s2vt_fused_bwd_units_per_block.argtypes = []
    lib.s2vt_fused_bwd_units_per_block.restype = ci
    return lib


def fused_s2vt_bwd(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh):
    """The fused backward (``fused_s2vt_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``fused_s2vt_bwd.launches``; CPU tensors run the plain version."""
    if g1.device.type == "cpu":
        return fused_s2vt_bwd_reference(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    _check_bwd_args(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    tensors = (g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    _build.check_cuda("fused_s2vt_bwd", tensors)
    T, B, G = g1.shape
    H = G // 4
    if H % 2:
        raise ValueError(f"the kernel reads gate rows in 16-byte chunks and needs an even H, "
                         f"got {H}")
    dev, mmd = g1.device, g1.dtype
    lib = _bwd_kernel_lib()
    dxp1 = torch.empty(T, B, G, dtype=mmd, device=dev)
    dxp2 = torch.empty(T, B, G, dtype=mmd, device=dev)
    dc = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
    _build.launch(lib, "s2vt_fused_bwd", "fused_s2vt_bwd", (*tensors, dxp1, dxp2, dc),
                  (T, B, H, int(mmd == torch.bfloat16)))
    fused_s2vt_bwd.launches += 1
    return dxp1, dxp2


fused_s2vt_bwd.launches = 0


def fused_shapes_ok(dim_hid: int, num_layers: int, rnn_type: str,
                    device: Optional[torch.device] = None) -> bool:
    """Whether the fused kernels serve this model on ``device``: one LSTM
    layer per chain and, on a card, H is even and each kernel's blocks fit
    one per SM with their resident weights in opt-in shared memory. On the
    CPU the plain versions serve any width."""
    if num_layers != 1 or rnn_type != "lstm":
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    if dim_hid % 2:
        return False
    props = torch.cuda.get_device_properties(device)
    sms, smem = props.multi_processor_count, props.shared_memory_per_block_optin
    units = units_per_block(dim_hid, sms)
    bwd = _bwd_kernel_lib()
    bwd_blocks = -(-dim_hid // bwd.s2vt_fused_bwd_units_per_block())
    return (_kernel_lib().s2vt_fused_fwd_smem_bytes(dim_hid, units) <= smem
            and bwd.s2vt_fused_bwd_smem_bytes(dim_hid) <= smem and bwd_blocks <= sms)


def s2vt_fused_infer(x1t, x2t, w1hh, w2v, w2hh, snap_idx: int,
                     compute_bf16: bool = True) -> Tuple:
    """Inference helper: returns (out1 [T,B,H], out2 [T,B,H], (h1T, c1T),
    (h2T, c2T), (h2_snap, c2_snap) at word step snap_idx).

    x1t [T, B, 4H]: vid inputs pre-projected (x @ W1ih^T + b1ih + b1hh).
    x2t [T, B, 4H]: word embedding part pre-projected (+ b2ih + b2hh); the
    vid-output part is added inside through w2v."""
    mmd = torch.bfloat16 if compute_bf16 else torch.float32
    g1, c1, g2, c2, h1T, c1T, h2T, c2T, h2s, c2s = fused_s2vt_fwd(
        *(a.to(mmd).contiguous() for a in (x1t, x2t, w1hh, w2v, w2hh)), snap_idx)
    return _h_from(g1, c1), _h_from(g2, c2), (h1T, c1T), (h2T, c2T), (h2s, c2s)


def _shift_in_zero(x: torch.Tensor) -> torch.Tensor:
    """[T, ...] -> [0; x[:-1]]: the previous step's value, zero at t = 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _outer_sum(dxp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """einsum('tbg,tbh->gh') as one float32 matrix product."""
    return dxp.reshape(-1, dxp.shape[-1]).T @ h.reshape(-1, h.shape[-1])


class _FusedOut2(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` of ``s2vt_fused_out2`` in
    ``pallas_s2vt.py``: the fused forward saves the gates and c of both
    layers; the backward runs the fused backward for dxp1 and dxp2 and forms
    the three recurrent weight gradients as float32 matrix products."""

    @staticmethod
    def forward(ctx, x1t, x2t, w1hh, w2v, w2hh, compute_bf16: bool):
        mmd = torch.bfloat16 if compute_bf16 else torch.float32
        args = [a.detach().to(mmd).contiguous() for a in (x1t, x2t, w1hh, w2v, w2hh)]
        g1, c1, g2, c2 = fused_s2vt_fwd(*args, x1t.shape[0] - 1)[:4]
        ctx.save_for_backward(g1, c1, g2, c2, *args[2:])
        return _h_from(g2, c2)

    @staticmethod
    def backward(ctx, dout2):
        g1, c1, g2, c2, w1hh, w2v, w2hh = ctx.saved_tensors
        dxp1, dxp2 = fused_s2vt_bwd(g1, c1, g2, c2, dout2.float().contiguous(), w1hh, w2v, w2hh)
        dxp1, dxp2 = dxp1.float(), dxp2.float()
        h1, h2 = _h_from(g1, c1), _h_from(g2, c2)
        return (dxp1, dxp2, _outer_sum(dxp1, _shift_in_zero(h1)), _outer_sum(dxp2, h1),
                _outer_sum(dxp2, _shift_in_zero(h2)), None)


def s2vt_fused_out2(x1t, x2t, w1hh, w2v, w2hh, compute_bf16: bool = True) -> torch.Tensor:
    """Teacher-forced S2VT core: word_rnn's hidden sequence out2 [T, B, H],
    differentiable in all five inputs.

    x1t [T, B, 4H]: vid inputs pre-projected (x @ W1ih^T + b1ih + b1hh).
    x2t [T, B, 4H]: word embedding part pre-projected (+ b2ih + b2hh); the
    vid-output part is added inside through w2v."""
    return _FusedOut2.apply(x1t, x2t, w1hh, w2v, w2hh, compute_bf16)
