"""Fused dual-LSTM S2VT forward: both LSTM chains in one CUDA launch.

Counterpart of ``s2vt_tpu/ops/pallas_s2vt.py`` (forward only). The S2VT
recurrence is two stacked LSTMs where word_rnn's step-t input holds vid_rnn's
step-t output. Skewed by one step, both chains advance together:

    iteration t:  z = [h1_{t-1} | h2_{t-2}],  big = z @ W_all
      layer 1 (t < T):       gates1_t     = x1_t     + big[:, :4H]
      layer 2 (1 <= t <= T): gates2_{t-1} = x2_{t-1} + big[:, 4H:]

    W_all = [[W1hh^T, W2v^T ],   W2v = the word W_ih columns that read
             [0,      W2hh^T]]   vid_rnn's output

``fused_s2vt_fwd`` launches the hand-written kernel
(``csrc/fused_s2vt_fwd.cu``) for CUDA tensors and runs
``fused_s2vt_fwd_reference``, the same recurrence in plain PyTorch, only for
CPU tensors. A CUDA tensor reaches the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build

_LIB_NAME = "fused_s2vt_fwd"
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
    lib.s2vt_cuda_error_string.argtypes = [ci]
    lib.s2vt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_s2vt_fwd(x1, x2, w1hh, w2v, w2hh, snap_idx: int):
    """The fused forward (``fused_s2vt_fwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel once and add one to
    ``fused_s2vt_fwd.launches``; CPU tensors run the plain version."""
    if x1.device.type == "cpu":
        return fused_s2vt_fwd_reference(x1, x2, w1hh, w2v, w2hh, snap_idx)
    _check_args(x1, x2, w1hh, w2v, w2hh, snap_idx)
    tensors = (x1, x2, w1hh, w2v, w2hh)
    if x1.device.type != "cuda":
        raise ValueError(f"fused_s2vt_fwd runs on CUDA or CPU tensors, got {x1.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_s2vt_fwd needs contiguous inputs")
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
    ptrs = [t.data_ptr() for t in (*tensors, g1, c1, g2, c2, fin, hbuf)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.s2vt_fused_fwd(*ptrs, T, B, H, units, snap_idx, int(mmd == torch.bfloat16),
                             dev.index if dev.index is not None else torch.cuda.current_device(),
                             stream)
    if err != 0:
        raise RuntimeError(f"fused_s2vt_fwd launch failed: "
                           f"{lib.s2vt_cuda_error_string(err).decode()} (cudaError {err})")
    fused_s2vt_fwd.launches += 1
    return (g1, c1, g2, c2, *fin.unbind(0))


fused_s2vt_fwd.launches = 0


def fused_shapes_ok(dim_hid: int, num_layers: int, rnn_type: str,
                    device: Optional[torch.device] = None) -> bool:
    """Whether the fused forward serves this model on ``device``: one LSTM
    layer per chain and, on a card, a block's resident weight rows, h tile
    and partial sums fit its opt-in shared memory at one block per SM, and H
    is even. On the CPU the plain version serves any width."""
    if num_layers != 1 or rnn_type != "lstm":
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    if dim_hid % 2:
        return False
    props = torch.cuda.get_device_properties(device)
    units = units_per_block(dim_hid, props.multi_processor_count)
    need = _kernel_lib().s2vt_fused_fwd_smem_bytes(dim_hid, units)
    return need <= props.shared_memory_per_block_optin


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


def s2vt_fused_out2(x1t, x2t, w1hh, w2v, w2hh, compute_bf16: bool = True) -> torch.Tensor:
    """Teacher-forced S2VT core: word_rnn's hidden sequence out2 [T, B, H].

    Forward only: the backward kernel comes with the training slice, so a
    call that autograd would have to differentiate raises."""
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x1t, x2t, w1hh, w2v, w2hh)):
        raise NotImplementedError(
            "backward kernel: training slice (ROADMAP.md queue 2, kernel #2); "
            "run the fused forward under torch.no_grad()")
    T = x1t.shape[0]
    _, out2, _, _, _ = s2vt_fused_infer(x1t, x2t, w1hh, w2v, w2hh, T - 1, compute_bf16)
    return out2
