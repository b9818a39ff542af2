"""One greedy step's out-projection and argmax in one CUDA launch.

Counterpart of ``s2vt_tpu/ops/pallas_decode.py``. ``argmax_linear`` computes,
per row of h [B, H],

    argmax(mask_invalid_vocab(h @ W_out^T + b, valid_vocab))

with W_out [V, H] in torch layout: the token a greedy step picks, without the
[B, V] logits ever reaching device memory. Ties go to the lowest index, as
``torch.argmax`` and ``jnp.argmax`` break them. h and b are float32, W
float32 or bf16. With ``compute_bf16`` h and W are rounded to bf16 as
product operands and the sums stay float32, as ``apply_linear`` does; a
bf16 W is that rounding done once, ahead (``greedy_pick`` does it once per
decode).

``argmax_linear`` is a ``torch.library`` operator, so that an exported
decode (``serving/export.py``) holds it as one node: on CUDA tensors it
launches the hand-written kernel (``csrc/argmax_linear.cu``) of the route
``argmax_linear_route`` picks and adds one to ``argmax_linear.launches`` and
to ``argmax_linear.route_launches[route]``: "mma", on the tensor cores (bf16
with a bf16 W, or float32 as three TF32 passes), where h and W come in
aligned 16-byte chunks; "direct", on the CUDA cores, for every other shape.
On CPU tensors it runs ``argmax_linear_reference``, the same function in
plain PyTorch. A CUDA tensor reaches a kernel or an exception.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted
from s2vt_tpu_torch.ops.layers import apply_linear, mask_invalid_vocab

_LIB_NAME = "argmax_linear"
_ENTRY = {"mma": "argmax_linear_mma", "direct": "argmax_linear"}
_VALUE_ENTRY = {"mma": "argmax_linear_mma_value", "direct": "argmax_linear_value"}


def _check_args(h, weight, bias):
    if h.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"h must be [B, H], weight [V, H], bias [V]; got {tuple(h.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if weight.shape[1] != h.shape[1] or bias.shape[0] != weight.shape[0]:
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if (h.dtype, bias.dtype) != (torch.float32, torch.float32) or \
            weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h and bias must be float32 and weight float32 or bfloat16, got "
                        f"{[t.dtype for t in (h, weight, bias)]}")
    if len({t.device for t in (h, weight, bias)}) != 1:
        raise ValueError("h, weight and bias lie on several devices")


@torch.no_grad()
def argmax_linear_reference(h, weight, bias, valid_vocab: Optional[int] = None,
                            compute_bf16: bool = False, with_value: bool = False):
    """Plain PyTorch version of the kernel: the logits through ``apply_linear``
    and ``mask_invalid_vocab``, then ``torch.argmax`` (first maximum). h [B, H]
    and bias [V] float32, weight [V, H] float32 or bf16 (its values, widened
    exactly). Returns int64 [B]; ``with_value``: (int64 [B], float32 [B]), the
    tokens and their logits, -inf where the token is a masked column (every
    row, when ``valid_vocab`` is 0)."""
    _check_args(h, weight, bias)
    logits = apply_linear(h, weight, bias, torch.bfloat16 if compute_bf16 else None)
    idx = torch.argmax(mask_invalid_vocab(logits, valid_vocab), dim=-1)
    if not with_value:
        return idx
    val = logits.gather(1, idx[:, None])[:, 0]
    if valid_vocab is not None:
        val = torch.where(idx < valid_vocab, val, torch.full_like(val, -math.inf))
    return idx, val


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in _ENTRY.values():
        getattr(lib, entry).argtypes = [vp] * 7 + [ci] * 6 + [vp]
        getattr(lib, entry).restype = ci
    for entry in _VALUE_ENTRY.values():
        getattr(lib, entry).argtypes = [vp] * 8 + [ci] * 6 + [vp]
        getattr(lib, entry).restype = ci
    lib.argmax_linear_vocab_tiles.argtypes = [ci, ci]
    lib.argmax_linear_vocab_tiles.restype = ci
    lib.argmax_linear_mma_vocab_tiles.argtypes = [ci, ci]
    lib.argmax_linear_mma_vocab_tiles.restype = ci
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


def argmax_linear_route(hidden: int, weight_dtype: torch.dtype, compute_bf16: bool,
                        pointers: Sequence[int] = ()) -> str:
    """The kernel that serves hidden size ``hidden`` with a weight of
    ``weight_dtype`` on the card: "mma" (tensor cores) where its 16-byte
    copies are legal -- the weight in the mode's operand type (bf16 with
    ``compute_bf16``, else float32), rows of ``hidden`` values that are whole
    16-byte chunks in both h (float32) and W (H % 4 == 0 in float32, H % 8 ==
    0 in bf16), and every address in ``pointers`` (h's and W's) 16-byte
    aligned -- else "direct" (CUDA cores, any H, W read as float32)."""
    mode_dtype = torch.bfloat16 if compute_bf16 else torch.float32
    row_ok = hidden % (8 if compute_bf16 else 4) == 0
    aligned = all(p % 16 == 0 for p in pointers)
    return "mma" if weight_dtype == mode_dtype and row_ok and aligned else "direct"


def argmax_linear_ok(batch, hidden: int, vocab: int,
                     device: Optional[torch.device] = None) -> bool:
    """Whether the kernel serves [batch, hidden] x [vocab, hidden] on
    ``device``: on a card, a 32-row tile of a chunk of h (at most 1792 values
    of k, in float32) must fit a block's opt-in shared memory for the direct
    route, the one that serves every shape (on an H100, any hidden size: the
    direct route stages h in chunks of k, and the mma route's shared memory
    does not grow with it); any batch and vocab size are tiled.
    On the CPU the plain version serves every shape. (The TPU gate
    ``pallas_decode.argmax_linear_ok`` -- B % 8, B <= 2048, H % 128, a
    128-multiple vocab block -- is a fact of the TPU's tiles and VMEM.)"""
    device = torch.device(device if device is not None else "cpu")
    if hidden < 1 or vocab < 1:
        return False
    if device.type != "cuda":
        return True
    return _kernel_lib().argmax_linear_smem_bytes(hidden) <= _build.smem_optin(device)


def _argmax_linear_impl(h, weight, bias, valid_vocab, compute_bf16, with_value=False):
    if h.device.type == "cpu":
        return argmax_linear_reference(h, weight, bias, valid_vocab, compute_bf16, with_value)
    _check_args(h, weight, bias)
    _build.check_cuda("argmax_linear", (h, weight, bias))
    B, H = h.shape
    if not argmax_linear_ok(B, H, weight.shape[0], h.device):
        raise ValueError(f"argmax_linear: hidden size {H} does not fit the kernel's shared "
                         f"memory on {h.device}")
    route = argmax_linear_route(H, weight.dtype, compute_bf16, (h.data_ptr(), weight.data_ptr()))
    return _launch(h, weight, bias, valid_vocab, compute_bf16, route, with_value)


def _launch(h, weight, bias, valid_vocab, compute_bf16, route, with_value=False):
    """One launch of ``route``'s kernel on CUDA tensors checked by the
    operator (or, to time one route beside the other, by the caller). The
    direct route reads W as float32: a bf16 W is widened (exactly) first.
    ``with_value``: the launch that also writes each row's winning logit;
    returns (tokens, values)."""
    if route == "direct" and weight.dtype != torch.float32:
        weight = weight.float()
    B, H = h.shape
    V = weight.shape[0]
    lib = _kernel_lib()
    tiles = (lib.argmax_linear_mma_vocab_tiles(V, int(compute_bf16)) if route == "mma"
             else lib.argmax_linear_vocab_tiles(B, V))
    out = torch.empty(B, dtype=torch.int64, device=h.device)
    pmax = torch.empty(tiles, B, dtype=torch.float32, device=h.device)
    pidx = torch.empty(tiles, B, dtype=torch.int32, device=h.device)
    counter = _counter(h.device, -(-B // 16))
    valid = V if valid_vocab is None else max(0, min(int(valid_vocab), V))
    val = torch.empty(B, dtype=torch.float32, device=h.device) if with_value else None
    _build.launch(lib, (_VALUE_ENTRY if with_value else _ENTRY)[route], "argmax_linear",
                  (h, weight, bias, out, *([val] if with_value else []), pmax, pidx, counter),
                  (B, H, V, valid, int(compute_bf16)))
    argmax_linear.launches += 1
    argmax_linear.route_launches[route] += 1
    return (out, val) if with_value else out


def _argmax_linear_fake(h, weight, bias, valid_vocab, compute_bf16):
    return h.new_empty(h.shape[0], dtype=torch.int64)


_argmax_linear_op = _build.define_op(
    "argmax_linear", "(Tensor h, Tensor weight, Tensor bias, int? valid_vocab, "
    "bool compute_bf16) -> Tensor", _argmax_linear_impl, _argmax_linear_fake)


def argmax_linear(h, weight, bias, valid_vocab: Optional[int] = None,
                  compute_bf16: bool = False) -> torch.Tensor:
    """The greedy step's token (``argmax_linear_reference``'s contract):
    int64 [B]. CUDA tensors (contiguous; h and bias float32, weight float32
    or bf16) launch the kernel of ``argmax_linear_route`` once and add one to
    ``argmax_linear.launches`` and to ``argmax_linear.route_launches[route]``;
    CPU tensors run the plain version."""
    _build.check_device("argmax_linear", h)
    return _argmax_linear_op(h, weight, bias, valid_vocab, compute_bf16)


counted(argmax_linear, "mma", "direct")


def argmax_linear_value(h, weight, bias, valid_vocab: Optional[int] = None,
                        compute_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``argmax_linear`` that also gives each row's winning logit: (int64 [B],
    float32 [B]), the value -inf where the token is a masked column (a vocab
    shard with no valid column: ``valid_vocab`` 0). One launch of the same
    kernel on CUDA tensors, counted in ``argmax_linear.launches`` and
    ``route_launches``; the plain version (``with_value``) on CPU tensors.
    Not an exported operator: a vocab-parallel decode (``parallel/vocab.py``)
    calls it on its shard of W and merges the shards."""
    _build.check_device("argmax_linear", h)
    return _argmax_linear_impl(h, weight, bias, valid_vocab, compute_bf16, with_value=True)


def pick_weight(out_w, compute_dtype):
    """The W a greedy decode hands the kernel: in bf16, where the mma route
    reads W as bf16, the weight rounded to bf16 once per decode (bit for bit
    what each step would round); else ``out_w`` itself."""
    if compute_dtype == torch.bfloat16 and argmax_linear_route(
            out_w.shape[1], torch.bfloat16, True) == "mma":
        return out_w.to(torch.bfloat16)
    return out_w


def greedy_pick(out_w, out_b, valid_vocab: Optional[int], compute_dtype, use_pallas: bool):
    """The token picker of a greedy step, h [B, H] -> ids [B]: with
    ``use_pallas``, one ``argmax_linear`` per step (on CPU tensors its plain
    version), raising on a card whose shared memory ``argmax_linear_ok``
    refuses for this hidden size (an H100 serves every width); in bf16,
    where the mma route reads W as bf16, the weight is rounded to bf16 here,
    once per decode (bit for bit what each step would round). Without
    ``use_pallas``: ``apply_linear``, ``mask_invalid_vocab`` and
    ``torch.argmax``. The first maximum wins either way."""
    if use_pallas:
        if not argmax_linear_ok(1, out_w.shape[1], out_w.shape[0], out_w.device):
            raise NotImplementedError(
                f"the argmax_linear kernel does not serve hidden size {out_w.shape[1]} on "
                f"{out_w.device}: a 32-row tile of a chunk of h does not fit a block's shared "
                "memory; build the model with use_pallas=False")
        bf16 = compute_dtype == torch.bfloat16
        w = pick_weight(out_w, compute_dtype)
        return lambda h: argmax_linear(h.contiguous(), w, out_b, valid_vocab, bf16)

    def plain(h):
        logits = apply_linear(h, out_w, out_b, compute_dtype)
        return torch.argmax(mask_invalid_vocab(logits, valid_vocab), dim=-1)
    return plain
