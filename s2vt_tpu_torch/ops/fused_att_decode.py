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

``att_decode_fwd`` launches the hand-written kernels (``csrc/att_decode_fwd.cu``)
for CUDA tensors and runs ``att_decode_fwd_reference``, the same loop in plain
PyTorch, only for CPU tensors. A CUDA tensor reaches a kernel or an
exception. The op has three routes, picked from the shapes, the mode and the
card before the launch: "mma" (the context product folded into one batched
tensor-core product P = enc_out @ W_ctx^T ahead of the loop, then the loop
on batch groups with three step-tagged exchanges per step;
``att_decode_plan`` lays it out) and "direct" (the grid-synchronised loop on
the CUDA cores), both picked by ``att_decode_fwd_route``, and "stream"
(``csrc/stream.cuh``: four launches per step, the weights read from global
memory), which ``launch`` runs in place of "direct" where the direct
blocks' weights do not fit (on an H100, H > 660 at L = 80). So the op
serves every width on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted
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


def set_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.att_decode_fwd.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    lib.att_decode_fwd.restype = ci
    lib.att_decode_fwd_smem_bytes.argtypes = [ci] * 4
    lib.att_decode_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.att_decode_fwd_tile_rows.argtypes = [ci, ci, ci, ctypes.c_size_t]
    lib.att_decode_fwd_tile_rows.restype = ci
    lib.att_decode_fwd_mma.argtypes = [vp] * 12 + [ci] * 11 + [vp]
    lib.att_decode_fwd_mma.restype = ci
    lib.att_decode_fwd_mma_smem_bytes.argtypes = [ci] * 8
    lib.att_decode_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.att_decode_fwd_stream.argtypes = [vp] * 11 + [ci] * 6 + [vp]
    lib.att_decode_fwd_stream.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The kernels' library (built on first use) with its C signatures."""
    return set_signatures(_build.load(_LIB_NAME))


def _layout(hidden: int, enc_len: int, device: torch.device):
    """(units per block, rows per batch tile) of the kernel on ``device``;
    rows 0 where its block does not fit in opt-in shared memory."""
    props = torch.cuda.get_device_properties(device)
    units = units_per_block(hidden, props.multi_processor_count)
    rows = _kernel_lib().att_decode_fwd_tile_rows(hidden, enc_len, units,
                                                  props.shared_memory_per_block_optin)
    return units, rows


_MMA_MAX_TILES = 4                 # m16 row tiles staged per pass
_MMA_MAX_HIDDEN = 512              # the widest width the route lays out
_MMA_SWEPT = (512, 80)             # the (H, L) of the route sweep
_MMA_MAX_BATCH = 200               # the largest batch measured


class AttPlan(NamedTuple):
    """The mma route's layout: U units per block, ``groups`` batch groups of
    ``rows`` rows (groups x H / U blocks), ``tiles`` m16 row tiles staged per
    pass and ``passes`` passes per step, and whether the group's slice of P
    and the block's score pairs' enc_wh rows are resident in shared
    memory."""
    units: int
    groups: int
    rows: int
    tiles: int
    passes: int
    p_resident: bool
    e_resident: bool


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def att_mma_smem_bytes(hidden: int, enc_len: int, units: int, rows: int, tiles: int,
                       p_resident: bool, e_resident: bool, compute_bf16: bool) -> int:
    """Dynamic shared memory of one mma-route block (``mma_route::smem_layout``
    of ``csrc/att_decode_fwd.cu``, each part 16-byte aligned): the 4U gate
    rows of W_hh and U rows of W_att padded to whole n8 tiles, and the staged
    h rows, in the operand type (rows padded by 16 bytes); the 8 warps' k
    shares of a pass's sums; the h part of the gates and x_proj [R, 4U]; P's
    slice [R, L, 4U] where resident; the score pairs' enc_wh rows [Q, H] where
    resident; the polled dw rows; w_apply; the attention weights [R, L]; c
    [R, U]. Float32 but for the operands."""
    es = 2 if compute_bf16 else 4
    cols = -(-5 * units // 8) * 8
    shares = 8                                   # one k share per warp
    stride = hidden + (8 if compute_bf16 else 4)
    staged = min(rows, 16 * tiles)
    pairs = -(-rows * enc_len // (hidden // units))
    span = min(rows, (pairs + enc_len - 2) // enc_len + 1)
    parts = (cols * stride * es, staged * stride * es, shares * staged * (cols + 4) * 4,
             rows * 4 * units * 4, rows * 4 * units * 4,
             rows * enc_len * 4 * units * 4 if p_resident else 0,
             pairs * hidden * 4 if e_resident else 0, span * hidden * 4, hidden * 4,
             rows * enc_len * 4, rows * units * 4)
    return sum(_align16(n) for n in parts)


def _measured_units(batch: int, compute_bf16: bool) -> int:
    """The U that tools/att_decode_variants.py --route layouts measured
    fastest at H = 512, T = 79, L = 80 on an NVIDIA H100 80GB HBM3 at 700 W:
    U = 8 at every batch in float32 (B = 16: 0.9134 ms, U = 4 1.0399, U = 16
    1.0660; B = 96: 4.9166, U = 4 6.0117; U = 16 does not fit), U = 8 up to
    B = 64 in bf16 (B = 16: 0.7108, U = 16 0.7125; B = 64: 2.4266, U = 16
    2.8187) and U = 16 from B = 80 (B = 96: 3.7750, U = 8 3.9497; B = 200:
    7.5330, U = 8 8.0019). (B = 32 bf16 measured U = 16 5 % faster, between
    B = 24 and 64 where U = 8 was as fast or faster; not taken.)"""
    return 16 if compute_bf16 and batch >= 80 else 8


@functools.lru_cache(maxsize=None)
def att_decode_plan(hidden: int, enc_len: int, batch: int, compute_bf16: bool, props,
                    units: Optional[int] = None) -> Optional[AttPlan]:
    """The mma route's layout for hidden size ``hidden``, ``enc_len`` encoder
    positions and batch ``batch`` on a card of ``props`` (anything with
    ``sms`` and ``smem_optin``), or None where it does not serve: 128 <= H <=
    512, H % 128 == 0, L even. At ``units`` (else at ``_measured_units``,
    the U the source instantiates: 8, and 16 in bf16; other U are the
    variant tool's builds) the batch splits into as many groups as the
    card's SMs hold (G H / U <= SMs); of the layouts whose block fits the
    opt-in shared memory the plan takes P's slice resident first, then the
    fewest passes, then the enc_wh rows resident; where none fits, no plan.
    Cached: the route and its launch ask for the same plan."""
    if not (128 <= hidden <= _MMA_MAX_HIDDEN and hidden % 128 == 0 and enc_len >= 2
            and enc_len % 2 == 0 and batch >= 1):
        return None

    u = units or _measured_units(batch, compute_bf16)
    groups = min(props.sms // (hidden // u), batch)
    if groups < 1:
        return None
    rows = -(-batch // groups)
    groups = -(-batch // rows)
    fits = [AttPlan(u, groups, rows, tiles, -(-rows // (16 * tiles)), p_res, e_res)
            for p_res in (True, False) for e_res in (True, False)
            for tiles in range(1, min(_MMA_MAX_TILES, -(-rows // 16)) + 1)
            if att_mma_smem_bytes(hidden, enc_len, u, rows, tiles, p_res, e_res,
                                  compute_bf16) <= props.smem_optin]
    return min(fits, key=_rank, default=None)


def _rank(plan: AttPlan):
    return (not plan.p_resident, plan.passes, not plan.e_resident, plan.tiles)


def att_decode_fwd_route(hidden: int, enc_len: int, batch: int, compute_bf16: bool,
                         device) -> str:
    """The kernel that serves hidden size ``hidden``, ``enc_len`` positions,
    batch ``batch`` and the mode ``compute_bf16`` on ``device`` (a card, or
    its ``_build.Card`` or any props with ``sms`` and ``smem_optin``): "mma"
    at H = 512, L = 80 (the shapes the sweep measured) where
    ``att_decode_plan`` serves and B <= 200, else "direct". On an
    NVIDIA H100 80GB HBM3 at 700 W the mma route was faster in all 30 cells
    of tools/att_decode_variants.py --route sweep (H = 512, T = 79, L = 80,
    B in 1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200, both
    modes, the two routes in turns): float32 B = 1 0.6098 against 1.0515
    ms, B = 16 0.9202 against 1.6696, B = 96 4.9442 against 8.9189, B = 200
    10.2689 against 18.1992; bf16 B = 1 0.4975 against 1.0810, B = 16
    0.7206 against 1.7467, B = 96 3.7836 against 9.3511, B = 200 7.5480
    against 19.1653. Larger batches, other widths and other lengths were
    not measured.
    Chosen before the launch, from the shapes, the mode and the card
    alone."""
    if batch > _MMA_MAX_BATCH or (hidden, enc_len) != _MMA_SWEPT:
        return "direct"
    props = device if hasattr(device, "smem_optin") else _build.card(device)
    return "mma" if att_decode_plan(hidden, enc_len, batch, compute_bf16, props) else "direct"


def att_decode_shapes_ok(batch: int, hidden: int, enc_len: int,
                         device: Optional[torch.device] = None,
                         compute_bf16: bool = False) -> bool:
    """Whether the kernel that ``att_decode_fwd_route`` picks for these shapes
    and the mode serves them on ``device`` with its weights resident in shared
    memory, that is on a route other than "stream": the mma route wherever
    it is picked (its plan fits the card); the direct route where one block
    per SM holds its units' gate rows of [W_ctx | W_hh] and W_att rows in
    opt-in shared memory (on an H100, H <= 660 at L = 80; it takes the batch
    in tiles of rows and reads the encoder tensors from device memory, so any
    batch). Every other shape runs on the stream route. On the CPU the plain
    version serves any shapes. (The TPU gate -- B % 8, B <= 32, H % 128 -- is
    a fact of the TPU's VMEM and tiles.)"""
    if batch < 1 or hidden < 1 or enc_len < 1:
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    if att_decode_fwd_route(hidden, enc_len, batch, compute_bf16, device) == "mma":
        return True
    return _layout(hidden, enc_len, device)[1] > 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels load float4s)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def att_decode_fwd(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0,
                   compute_bf16: bool):
    """The decode loop (``att_decode_fwd_reference``'s contract).

    CUDA tensors launch the route of ``att_decode_fwd_route`` once and add
    one to ``att_decode_fwd.launches`` and to
    ``att_decode_fwd.route_launches[route]``; CPU tensors run the plain
    version."""
    args = (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0)
    if xp_t.device.type == "cpu":
        return att_decode_fwd_reference(*args, compute_bf16)
    _check_args(*args)
    _build.check_cuda("att_decode_fwd", tuple(t.contiguous() for t in args))
    T, B, G = xp_t.shape
    route = att_decode_fwd_route(G // 4, enc_out.shape[1], B, compute_bf16, xp_t.device)
    return launch(*args, compute_bf16, route)


def launch(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0, compute_bf16,
           route, lib=None, plan=None):
    """One launch of ``route`` on CUDA tensors checked by the caller (or, to
    time one route beside the other, by chip_smoke.py and the variant tool,
    which may pass its own build as ``lib`` and an mma ``plan``). The mma
    route is two kernel launches (P, then the loop) and counts as one; the
    stream route, 4 T - 2 launches, counts as one too. "direct" where its
    blocks' weights do not fit one per SM runs as "stream".
    Returns the h sequence [T, B, H]."""
    T, B, G = xp_t.shape
    H, L = G // 4, enc_out.shape[1]
    dev = xp_t.device
    if route == "direct" and not _layout(H, L, dev)[1]:
        route = "stream"
    args = tuple(_aligned(t) for t in
                 (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0))
    out = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    if route == "mma":
        plan = plan or att_decode_plan(H, L, B, compute_bf16, _build.card(dev))
        if plan is None:
            raise ValueError(f"att_decode_fwd: the mma route does not serve H={H}, L={L}, B={B}")
        # P, [H / U][B L + B][4U], and this launch's exchange: h (two bf16
        # per word in bf16 mode), dw and et words by step parity; zeros tag
        # nothing.
        pbuf = torch.empty(4 * H * (B * L + B), dtype=torch.float32, device=dev)
        words = torch.zeros(2 * B * ((H // 2 if compute_bf16 else H) + H + L), dtype=torch.int64,
                            device=dev)
        _build.launch(lib or _kernel_lib(), "att_decode_fwd_mma", "att_decode_fwd",
                      (*args, out, pbuf, words),
                      (T, B, H, L, plan.units, plan.groups, plan.tiles, int(plan.p_resident),
                       int(plan.e_resident), int(compute_bf16)))
    elif route == "stream":
        # [W_ctx | W_hh], then c, dw, ctx and et
        scratch = torch.empty(12 * H * H + 4 * B * H + B * L, dtype=torch.float32, device=dev)
        _build.launch(lib or _kernel_lib(), "att_decode_fwd_stream", "att_decode_fwd",
                      (*args, out, scratch), (T, B, H, L, int(compute_bf16)))
    else:
        units, rows = _layout(H, L, dev)
        scratch = torch.empty(B * (4 * H + L), dtype=torch.float32, device=dev)
        _build.launch(lib or _kernel_lib(), "att_decode_fwd", "att_decode_fwd",
                      (*args, out, scratch), (T, B, H, L, units, rows, int(compute_bf16)))
    att_decode_fwd.launches += 1
    att_decode_fwd.route_launches[route] += 1
    return out


counted(att_decode_fwd, "mma", "direct", "stream")


def att_decode_sequence(xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0,
                        compute_dtype=None) -> torch.Tensor:
    """Drop-in for ``att_decode_sequence_pallas`` with torch-layout weights:
    the h sequence [T, B, H] (float32) of the teacher-forced decoder loop.
    No gradient flows through it (the TPU kernel has no backward)."""
    args = (a.detach().float() for a in
            (xp_t, w_ctx, w_hh, w_att, b_att, w_apply, enc_wh, enc_out, ctx0))
    return att_decode_fwd(*args, compute_dtype == torch.bfloat16)
