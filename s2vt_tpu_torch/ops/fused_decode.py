"""One greedy step's out-projection and argmax in one CUDA launch.

Counterpart of ``s2vt_tpu/ops/pallas_decode.py``. ``argmax_linear`` computes,
per row of h [B, H],

    argmax(mask_invalid_vocab(h @ W_out^T + b, valid_vocab))

with W_out [V, H] in torch layout: the token a greedy step picks, without the
[B, V] logits ever reaching device memory. Ties go to the lowest index, as
``torch.argmax`` and ``jnp.argmax`` break them. With ``compute_bf16`` h and W
are rounded to bf16 as product operands and the sums stay float32, as
``apply_linear`` does.

``argmax_linear`` is a ``torch.library`` operator, so that an exported
decode (``serving/export.py``) holds it as one node: on CUDA tensors it
launches the hand-written kernel (``csrc/argmax_linear.cu``) and adds one to
``argmax_linear.launches``; on CPU tensors it runs
``argmax_linear_reference``, the same function in plain PyTorch. A CUDA
tensor reaches the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.layers import apply_linear, mask_invalid_vocab

_LIB_NAME = "argmax_linear"


def _check_args(h, weight, bias):
    if h.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"h must be [B, H], weight [V, H], bias [V]; got {tuple(h.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if weight.shape[1] != h.shape[1] or bias.shape[0] != weight.shape[0]:
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if any(t.dtype != torch.float32 for t in (h, weight, bias)):
        raise TypeError(f"h, weight and bias must be float32, got "
                        f"{[t.dtype for t in (h, weight, bias)]}")
    if len({t.device for t in (h, weight, bias)}) != 1:
        raise ValueError("h, weight and bias lie on several devices")


@torch.no_grad()
def argmax_linear_reference(h, weight, bias, valid_vocab: Optional[int] = None,
                            compute_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the logits through ``apply_linear``
    and ``mask_invalid_vocab``, then ``torch.argmax`` (first maximum). h [B, H],
    weight [V, H], bias [V], float32. Returns int64 [B]."""
    _check_args(h, weight, bias)
    logits = apply_linear(h, weight, bias, torch.bfloat16 if compute_bf16 else None)
    return torch.argmax(mask_invalid_vocab(logits, valid_vocab), dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.argmax_linear.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.argmax_linear.restype = ci
    lib.argmax_linear_vocab_tiles.argtypes = [ci, ci]
    lib.argmax_linear_vocab_tiles.restype = ci
    lib.argmax_linear_smem_bytes.argtypes = [ci]
    lib.argmax_linear_smem_bytes.restype = ctypes.c_size_t
    return lib


# The kernel's tile counters, per card and stream.
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _counter(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tile counters for a launch on ``device``'s
    current stream. Each launch leaves the counters it used at zero, so the
    launches of one stream, which run one after another, share a buffer;
    launches on two streams may overlap, and each stream has its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def argmax_linear_ok(batch, hidden: int, vocab: int,
                     device: Optional[torch.device] = None) -> bool:
    """Whether the kernel serves [batch, hidden] x [vocab, hidden] on
    ``device``: on a card, a 32-row tile of h in float32 must fit a block's
    opt-in shared memory (on an H100, hidden <= 1816); any batch and vocab
    size are tiled. On the CPU the plain version serves every shape. (The TPU
    gate ``pallas_decode.argmax_linear_ok`` -- B % 8, B <= 2048, H % 128, a
    128-multiple vocab block -- is a fact of the TPU's tiles and VMEM.)"""
    device = torch.device(device if device is not None else "cpu")
    if hidden < 1 or vocab < 1:
        return False
    if device.type != "cuda":
        return True
    return _kernel_lib().argmax_linear_smem_bytes(hidden) <= _build.smem_optin(device)


def _argmax_linear_impl(h, weight, bias, valid_vocab, compute_bf16):
    if h.device.type == "cpu":
        return argmax_linear_reference(h, weight, bias, valid_vocab, compute_bf16)
    _check_args(h, weight, bias)
    _build.check_cuda("argmax_linear", (h, weight, bias))
    B, H = h.shape
    V = weight.shape[0]
    if not argmax_linear_ok(B, H, V, h.device):
        raise ValueError(f"argmax_linear: hidden size {H} does not fit the kernel's shared "
                         f"memory on {h.device}")
    lib = _kernel_lib()
    tiles = lib.argmax_linear_vocab_tiles(B, V)
    out = torch.empty(B, dtype=torch.int64, device=h.device)
    pmax = torch.empty(tiles, B, dtype=torch.float32, device=h.device)
    pidx = torch.empty(tiles, B, dtype=torch.int32, device=h.device)
    counter = _counter(h.device, -(-B // 16))
    valid = V if valid_vocab is None else max(0, min(int(valid_vocab), V))
    _build.launch(lib, "argmax_linear", "argmax_linear", (h, weight, bias, out, pmax, pidx,
                                                         counter),
                  (B, H, V, valid, int(compute_bf16)))
    argmax_linear.launches += 1
    return out


def _argmax_linear_fake(h, weight, bias, valid_vocab, compute_bf16):
    return h.new_empty(h.shape[0], dtype=torch.int64)


_argmax_linear_op = _build.define_op(
    "argmax_linear", "(Tensor h, Tensor weight, Tensor bias, int? valid_vocab, "
    "bool compute_bf16) -> Tensor", _argmax_linear_impl, _argmax_linear_fake)


def argmax_linear(h, weight, bias, valid_vocab: Optional[int] = None,
                  compute_bf16: bool = False) -> torch.Tensor:
    """The greedy step's token (``argmax_linear_reference``'s contract):
    int64 [B]. CUDA tensors (contiguous, float32) launch the kernel once and
    add one to ``argmax_linear.launches``; CPU tensors run the plain
    version."""
    _build.check_device("argmax_linear", h)
    return _argmax_linear_op(h, weight, bias, valid_vocab, compute_bf16)


argmax_linear.launches = 0


def greedy_pick(out_w, out_b, valid_vocab: Optional[int], compute_dtype, use_pallas: bool):
    """The token picker of a greedy step, h [B, H] -> ids [B]: with
    ``use_pallas``, one ``argmax_linear`` per step (on CPU tensors its plain
    version), raising on a card whose shared memory ``argmax_linear_ok``
    refuses for this hidden size; without it ``apply_linear``,
    ``mask_invalid_vocab`` and ``torch.argmax``. The first maximum wins
    either way."""
    if use_pallas:
        if not argmax_linear_ok(1, out_w.shape[1], out_w.shape[0], out_w.device):
            raise NotImplementedError(
                f"the argmax_linear kernel does not serve hidden size {out_w.shape[1]} on "
                f"{out_w.device}: a 32-row tile of h does not fit a block's shared memory; "
                "build the model with use_pallas=False")
        bf16 = compute_dtype == torch.bfloat16
        return lambda h: argmax_linear(h.contiguous(), out_w, out_b, valid_vocab, bf16)

    def plain(h):
        logits = apply_linear(h, out_w, out_b, compute_dtype)
        return torch.argmax(mask_invalid_vocab(logits, valid_vocab), dim=-1)
    return plain
