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
kernel or an exception. Each has two kernels, its "mma" and "direct"
routes, picked by ``fused_s2vt_fwd_route`` and ``fused_s2vt_bwd_route`` from
the shapes, the mode and the card before the launch. ``s2vt_fused_out2`` is
differentiable through both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted

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
    return set_fwd_signatures(_build.load(_LIB_NAME))


def set_fwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the forward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.s2vt_fused_fwd.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.s2vt_fused_fwd.restype = ci
    lib.s2vt_fused_fwd_smem_bytes.argtypes = [ci, ci]
    lib.s2vt_fused_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.s2vt_fused_fwd_mma.argtypes = [vp] * 11 + [ci] * 9 + [vp]
    lib.s2vt_fused_fwd_mma.restype = ci
    lib.s2vt_fused_fwd_mma_smem_bytes.argtypes = [ci] * 5
    lib.s2vt_fused_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    return lib


# The forward's "mma" route (csrc/fused_s2vt_fwd.cu, namespace mma_route):
# its blocks and what each holds.
_MMA_UNITS = (4, 8)                # instantiated hidden units per block (U)
_MMA_SLOTS = 32                    # (cell, gate) pairs a thread runs per iteration
_MMA_MAX_TILES = 4                 # m16 row tiles staged per pass
_MMA_MAX_HIDDEN = 512              # a lane's 16-byte exchange loads cover a row
_MMA_MAX_BATCH = 200               # the largest batch routed to it (the sweep's largest)


class FwdPlan(NamedTuple):
    """How the mma route lays out one launch: ``groups`` batch groups of
    ``rows`` rows (the last may hold fewer), each run by H / ``units``
    blocks that own ``units`` hidden units of both layers each; a block
    stages ``tiles`` m16 row tiles of its group per pass, ``passes`` passes
    per iteration."""
    units: int
    groups: int
    rows: int
    tiles: int
    passes: int


def fused_fwd_smem_bytes(hidden: int, units: int, tiles: int, compute_bf16: bool,
                         passes: int = 1) -> int:
    """Dynamic shared memory of one mma-route block (``smem_bytes`` in the
    source): the block's 12U weight rows (W1hh, W2v, W2hh) and ``tiles`` m16
    tiles of staged [h1 | h2] rows, in the operand type with 8 elements of
    padding per row; then the gate sums -- in bf16 the k shares of the
    warps (8 / (1.5U / 3) of them), laid over the staged rows; in float32
    the 8 slice partials of each (column, row), apart --, the c of each of
    the 256 threads' cell slots (tiles x U / 2 per pass) and two buffers of
    a pass's x [2 layers][rows][4 gates][U]."""
    es = 2 if compute_bf16 else 4
    n, rows = 12 * units, 16 * tiles
    weights = n * (hidden + 8) * es
    staged = rows * (2 * hidden + 8) * es
    cells = 4 * 256 * passes * tiles * units // 2
    x_bufs = 2 * 8 * rows * units * es
    if compute_bf16:
        shares = 8 // (n // 8 // 3)
        return weights + max(staged, 4 * shares * rows * (n + 4)) + cells + x_bufs
    per_slice = n * (rows + 1)             # slice_stride: rounded up to 4 mod 32
    return weights + staged + 4 * 8 * (per_slice + (4 - per_slice) % 32) + cells + x_bufs


def fused_fwd_plan(hidden: int, batch: int, compute_bf16: bool, props,
                   units: Optional[int] = None) -> Optional[FwdPlan]:
    """The mma route's layout for hidden size ``hidden`` and batch ``batch``
    on a card of ``props`` (a ``_build.Card`` or ``fused_rnn.CardProps``), or
    None where it does not serve: 128 <= H <= 512, H % 128 == 0. For each U
    (``units``, or 4 and 8) the batch splits into as many groups as the
    card's SMs hold (G H / U <= SMs); a block stages as many of its group's
    m16 tiles per pass as its shared memory and its 32 pairs per thread
    allow; of these the plan with the fewest passes, then the fewest padded
    products per block (m16 tiles per group x U), then rows per group is
    chosen. At H = 512 float32 fits only U = 4 (one group, one m16 tile per
    pass); bf16 takes U = 4 at B = 16 (0.6611 against 0.8216 ms at U = 8)
    and U = 8 in two groups of 48 rows at B = 96 (2.3696 against 3.2902 ms
    at U = 4 in two passes; tools/fused_fwd_variants.py, units4 and units8,
    on an NVIDIA H100 80GB HBM3 at 700 W)."""
    if not (128 <= hidden <= _MMA_MAX_HIDDEN and hidden % 128 == 0 and batch >= 1):
        return None
    plans = []
    for u in (units,) if units else _MMA_UNITS:
        groups = min(props.sms // (hidden // u), batch)
        if u not in _MMA_UNITS or groups < 1:
            continue
        rows = -(-batch // groups)
        groups = -(-batch // rows)
        m_tiles = -(-rows // 16)
        for tiles in range(min(m_tiles, _MMA_MAX_TILES), 0, -1):
            passes = -(-m_tiles // tiles)
            if (passes * tiles * u // 2 <= _MMA_SLOTS
                    and fused_fwd_smem_bytes(hidden, u, tiles, compute_bf16, passes)
                    <= props.smem_optin):
                plans.append(FwdPlan(u, groups, rows, tiles, passes))
                break
    return min(plans, key=lambda p: (p.passes, -(-p.rows // 16) * p.units, p.rows),
               default=None)


def fused_s2vt_fwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The kernel that serves hidden size ``hidden``, batch ``batch`` and the
    mode ``compute_bf16`` on ``device`` (a card, or its ``_build.Card``): "mma"
    where ``fused_fwd_plan`` serves and B <= 200, else "direct" (the
    grid-synchronised kernel on the CUDA cores). On an NVIDIA H100 80GB HBM3
    at 700 W the mma route was faster at every measured batch, in both
    modes (tools/fused_fwd_variants.py --route sweep, H = 512, T = 159, B in
    1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200, the two
    routes in turns): float32 0.8039 against 0.9619 ms at B = 1, 1.3497
    against 1.5955 at B = 16, 7.8768 against 8.3853 at B = 96, 16.7073
    against 17.5566 at B = 200 (the closest); bf16 0.5926 against 1.2459 at
    B = 1, 0.6484 against 1.7412 at B = 16, 2.3750 against 9.3312 at
    B = 96, 6.6816 against 19.7117 at B = 200. Larger batches were not
    measured. Chosen before the launch, from the shapes, the mode and the
    card alone."""
    if batch > _MMA_MAX_BATCH:
        return "direct"
    props = device if hasattr(device, "smem_optin") else _build.card(device)
    return "mma" if fused_fwd_plan(hidden, batch, compute_bf16, props) else "direct"


def launch_fwd(x1, x2, w1hh, w2v, w2hh, snap_idx: int, route: str, lib=None, plan=None):
    """One launch of ``route``'s kernel on CUDA tensors checked by the
    caller (or, to time one route beside the other, by chip_smoke.py and
    tools/fused_fwd_variants.py, which passes its own builds as ``lib`` and
    its layouts as the mma ``plan``). Returns (g1, c1, g2, c2, fin [6, B, H])."""
    T, B, G = x1.shape
    H = G // 4
    dev, mmd = x1.device, x1.dtype
    bf16 = mmd == torch.bfloat16
    g1 = torch.empty(T, B, G, dtype=mmd, device=dev)
    g2 = torch.empty(T, B, G, dtype=mmd, device=dev)
    c1 = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    c2 = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    fin = torch.empty(6, B, H, dtype=torch.float32, device=dev)
    tensors = (x1, x2, w1hh, w2v, w2hh, g1, c1, g2, c2, fin)
    if route == "mma":
        plan = plan or fused_fwd_plan(H, B, bf16, _build.card(dev))
        if plan is None:
            raise ValueError(f"fused_s2vt_fwd: the mma route does not serve H={H}, B={B}")
        # This launch's exchange: [h1 | h2] tagged with the iteration that
        # wrote it, by its parity (in bf16 two units per word); zeros tag
        # nothing.
        xch = torch.zeros(2 * B * (H if bf16 else 2 * H), dtype=torch.int64, device=dev)
        _build.launch(lib or _kernel_lib(), "s2vt_fused_fwd_mma", "fused_s2vt_fwd",
                      tensors + (xch,),
                      (T, B, H, snap_idx, plan.units, plan.groups, plan.tiles, int(bf16)))
    else:
        if H % 2:
            raise ValueError(f"the kernel loads h as float4 and needs an even H, got {H}")
        units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
        hbuf = torch.zeros(2, B, 2 * H, dtype=torch.float32, device=dev)
        _build.launch(lib or _kernel_lib(), "s2vt_fused_fwd", "fused_s2vt_fwd",
                      tensors + (hbuf,), (T, B, H, units, snap_idx, int(bf16)))
    fused_s2vt_fwd.launches += 1
    fused_s2vt_fwd.route_launches[route] += 1
    return g1, c1, g2, c2, fin


def _fused_s2vt_fwd_impl(x1, x2, w1hh, w2v, w2hh, snap_idx):
    if x1.device.type == "cpu":
        g1, c1, g2, c2, *fin = fused_s2vt_fwd_reference(x1, x2, w1hh, w2v, w2hh, snap_idx)
        return g1, c1, g2, c2, torch.stack(fin)
    _check_args(x1, x2, w1hh, w2v, w2hh, snap_idx)
    _build.check_cuda("fused_s2vt_fwd", (x1, x2, w1hh, w2v, w2hh))
    T, B, G = x1.shape
    route = fused_s2vt_fwd_route(G // 4, B, x1.dtype == torch.bfloat16, x1.device)
    return launch_fwd(x1, x2, w1hh, w2v, w2hh, snap_idx, route)


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

    CUDA tensors (contiguous) launch the kernel of ``fused_s2vt_fwd_route``
    once and add one to ``fused_s2vt_fwd.launches`` and to
    ``fused_s2vt_fwd.route_launches[route]``; CPU tensors run the plain
    version."""
    _build.check_device("fused_s2vt_fwd", x1)
    g1, c1, g2, c2, fin = _fused_s2vt_fwd_op(x1, x2, w1hh, w2v, w2hh, snap_idx)
    return (g1, c1, g2, c2, *fin.unbind(0))


counted(fused_s2vt_fwd, "mma", "direct")


@functools.lru_cache(maxsize=None)
def _bwd_kernel_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    return set_bwd_signatures(_build.load(_BWD_LIB_NAME))


def set_bwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the backward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.s2vt_fused_bwd.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.s2vt_fused_bwd.restype = ci
    lib.s2vt_fused_bwd_smem_bytes.argtypes = [ci]
    lib.s2vt_fused_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.s2vt_fused_bwd_units_per_block.argtypes = []
    lib.s2vt_fused_bwd_units_per_block.restype = ci
    lib.s2vt_fused_bwd_mma.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    lib.s2vt_fused_bwd_mma.restype = ci
    lib.s2vt_fused_bwd_mma_smem_bytes.argtypes = [ci] * 5
    lib.s2vt_fused_bwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.s2vt_fused_bwd_mma_xch_words.argtypes = [ci]
    lib.s2vt_fused_bwd_mma_xch_words.restype = ctypes.c_size_t
    lib.s2vt_fused_bwd_mma_active_clusters.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.s2vt_fused_bwd_mma_active_clusters.restype = ci
    return lib


# The backward's "mma" route (csrc/fused_s2vt_bwd.cu, namespace mma_route),
# bf16 only: its blocks, clusters and what each holds.
_BWD_UNITS = (8,)                  # instantiated hidden units per block (U)
_BWD_CLUSTERS = (2, 4)             # blocks per thread-block cluster (C)
_BWD_SLOTS = 4                     # cells a thread runs per pass
_BWD_MAX_ROWS = 48                 # batch rows per pass
_BWD_MAX_HIDDEN = 512              # the widest layout the route is checked at
_BWD_MIN_SMEM = 120 * 1024         # one block per SM
_BWD_MAX_BATCH = 200               # the largest batch the sweep measured


class BwdCard(NamedTuple):
    """What the backward's mma route depends on, of one card: its SMs, the
    opt-in shared memory of a block, and how many clusters of 2 and 4 of
    the route's blocks (one per SM) it holds at once."""
    sms: int
    smem_optin: int
    clusters: Tuple[int, int]


class BwdPlan(NamedTuple):
    """How the backward's mma route lays out one launch: ``groups`` batch
    groups of ``rows`` rows (the last may hold fewer), each run by H /
    ``units`` blocks in clusters of ``cluster`` blocks that split the k
    range of the products; a block runs ``pass_rows`` of its group's rows
    per pass, ``passes`` passes per iteration."""
    units: int
    cluster: int
    groups: int
    rows: int
    pass_rows: int
    passes: int


def _bwd_cells_per_pass(units: int, pass_rows: int) -> int:
    return -(-2 * pass_rows * units // 256)


def fused_bwd_smem_bytes(hidden: int, units: int, cluster: int, pass_rows: int,
                         passes: int = 1) -> int:
    """Dynamic shared memory of one mma-route block (``smem_bytes`` in the
    source), at least 120 KiB (one block per SM): the resident bf16 weights
    of the cluster's C U units over the block's k share (12 H U values, rows
    padded by 8), the staged operand rows of a pass (its share of [dg1' |
    dg2'], 8H / C bf16 values per row, padded by 8; at least the warps' k
    shares of the sums laid over them), the pushed partials [2][C][rows][2]
    [U] in float32, the dc carries, one word per cell slot of the 256
    threads for each pass, and the 7 input words of each cell slot of a
    pass."""
    kh, cu = 4 * hidden // cluster, cluster * units
    weights = (cu * (2 * kh + 8) + cu * (kh + 8)) * 2
    warps_n = cu // 16 if cu >= 32 else 1
    staged = max(pass_rows * (2 * kh + 8) * 2, 4 * (8 // warps_n) * pass_rows * (2 * cu + 4))
    rcv = 4 * 2 * cluster * pass_rows * units * 2
    cells = _bwd_cells_per_pass(units, pass_rows) * 256
    return max(weights + staged + rcv + 4 * passes * cells + 4 * 7 * cells, _BWD_MIN_SMEM)


@functools.lru_cache(maxsize=None)
def fused_bwd_plan(hidden: int, batch: int, compute_bf16: bool, props,
                   units: Optional[int] = None,
                   cluster: Optional[int] = None) -> Optional[BwdPlan]:
    """The backward's mma layout for hidden size ``hidden`` and batch
    ``batch`` on a card of ``props`` (a ``BwdCard``), or None where it does
    not serve: float32, or H outside 128-512, or H % 128 != 0. For U
    (``units``, or 8, the one layout the source instantiates) and each C
    (``cluster``, or 2 and 4) the batch splits into as many groups as the
    card's SMs and co-resident clusters hold; a block runs its group in one
    pass where its shared memory and its 4 cells per thread allow it (at
    most 48 rows), else passes of 16 rows. Of these the plan with the
    fewest passes, then the most units per cluster (C U: the fewest bytes
    read per iteration), then the fewest rows per group is chosen. On an
    H100 (30 co-resident clusters of 4) that is U = 8 in clusters of 4, one
    group, up to B = 32, then clusters of 2 in two groups, 16 rows per pass
    (B = 24: 1.1012 ms against 1.2317 for clusters of 2; B = 96: 3.0178
    against 4.4170 for clusters of 4 in one group, 6 passes;
    tools/fused_bwd_variants.py --route layouts, H = 512, T = 159, on an
    NVIDIA H100 80GB HBM3 at 700 W). Computed once per shape and card."""
    if not (compute_bf16 and 128 <= hidden <= _BWD_MAX_HIDDEN and hidden % 128 == 0
            and batch >= 1):
        return None
    plans = []
    for u in (units,) if units else _BWD_UNITS:
        for c in (cluster,) if cluster else _BWD_CLUSTERS:
            blocks = hidden // u
            if c not in _BWD_CLUSTERS or blocks % c or blocks > props.sms:
                continue
            groups = min(props.sms // blocks, props.clusters[_BWD_CLUSTERS.index(c)] * c // blocks,
                         batch)
            if groups < 1:
                continue
            rows = -(-batch // groups)
            groups = -(-batch // rows)
            # the group in one pass where it fits, else passes of one m16
            # tile (the layouts run measured them faster per row than passes
            # of 32 or 48 rows)
            for rp in (-(-rows // 16) * 16, 16):
                passes = -(-rows // rp)
                if (rp <= _BWD_MAX_ROWS and _bwd_cells_per_pass(u, rp) <= _BWD_SLOTS
                        and fused_bwd_smem_bytes(hidden, u, c, rp, passes) <= props.smem_optin):
                    plans.append(BwdPlan(u, c, groups, rows, rp, passes))
                    break
    return min(plans, key=lambda p: (p.passes, -p.units * p.cluster, p.rows), default=None)


@functools.lru_cache(maxsize=None)
def _bwd_card(index: int) -> BwdCard:
    lib = _bwd_kernel_lib()
    clusters = []
    for c in _BWD_CLUSTERS:
        n = ctypes.c_int(0)
        err = lib.s2vt_fused_bwd_mma_active_clusters(c, index, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"fused_s2vt_bwd: cudaOccupancyMaxActiveClusters failed: "
                               f"{lib.s2vt_cuda_error_string(err).decode()} (cudaError {err})")
        clusters.append(n.value)
    return BwdCard(*_build.card(torch.device("cuda", index)), tuple(clusters))


def bwd_card(device) -> BwdCard:
    """``BwdCard`` of card ``device``, read once per card."""
    device = torch.device(device)
    return _bwd_card(device.index if device.index is not None else torch.cuda.current_device())


def fused_s2vt_bwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The backward kernel that serves hidden size ``hidden``, batch
    ``batch`` and the mode ``compute_bf16`` on ``device`` (a card, or its
    ``BwdCard``): "mma" in bf16 where ``fused_bwd_plan`` serves and B <=
    200; else "direct" (the grid-synchronised kernel on the CUDA cores),
    every float32 shape included. On an NVIDIA H100 80GB HBM3 at 700 W
    (tools/fused_bwd_variants.py --route sweep, H = 512, T = 159, B in 1, 2,
    4, 8, 12, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200, the two routes
    in turns) the mma route was faster at every bf16 batch (0.6884 against
    0.8757 ms at B = 1, 0.7950 against 0.9680 at B = 16, the closest,
    3.0908 against 4.5264 at B = 96, 6.7525 against 9.4612 at B = 200).
    A float32 form of the route was slower than the direct route from B = 8
    on (1.1276 against 0.9555 ms at B = 8, 2.0248 against 1.1029 at B = 16)
    and left the source. Larger batches were not measured. Chosen before
    the launch, from the shapes, the mode and the card alone."""
    if not compute_bf16 or batch > _BWD_MAX_BATCH:
        return "direct"
    props = device if isinstance(device, BwdCard) else bwd_card(device)
    return "mma" if fused_bwd_plan(hidden, batch, compute_bf16, props) else "direct"


def launch_bwd(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh, route: str, lib=None, plan=None):
    """One launch of ``route``'s backward kernel on CUDA tensors checked by
    the caller (or, to time one route beside the other, by chip_smoke.py
    and tools/fused_bwd_variants.py, which passes its own builds as ``lib``
    and its layouts as the mma ``plan``). The mma route takes bf16 alone.
    Returns (dxp1, dxp2)."""
    T, B, G = g1.shape
    H = G // 4
    dev, mmd = g1.device, g1.dtype
    bf16 = mmd == torch.bfloat16
    dxp1 = torch.empty(T, B, G, dtype=mmd, device=dev)
    dxp2 = torch.empty(T, B, G, dtype=mmd, device=dev)
    tensors = (g1, c1, g2, c2, dout2, w1hh, w2v, w2hh, dxp1, dxp2)
    if route == "mma":
        plan = plan or fused_bwd_plan(H, B, bf16, bwd_card(dev))
        if plan is None or not bf16:
            raise ValueError(f"fused_s2vt_bwd: the mma route does not serve H={H}, B={B}, {mmd}")
        # This launch's exchange: [dg1 | dg2] tagged with the iteration that
        # wrote it, by its parity, two units per word; zeros tag nothing.
        lib = lib or _bwd_kernel_lib()
        xch = torch.zeros(2 * B * lib.s2vt_fused_bwd_mma_xch_words(H), dtype=torch.int64,
                          device=dev)
        _build.launch(lib, "s2vt_fused_bwd_mma", "fused_s2vt_bwd",
                      tensors + (xch,), (T, B, H, plan.units, plan.cluster, plan.groups,
                                         plan.pass_rows))
    else:
        if H % 2:
            raise ValueError(f"the kernel reads gate rows in 16-byte chunks and needs an even "
                             f"H, got {H}")
        dc = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
        _build.launch(lib or _bwd_kernel_lib(), "s2vt_fused_bwd", "fused_s2vt_bwd",
                      tensors + (dc,), (T, B, H, int(bf16)))
    fused_s2vt_bwd.launches += 1
    fused_s2vt_bwd.route_launches[route] += 1
    return dxp1, dxp2


def fused_s2vt_bwd(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh):
    """The fused backward (``fused_s2vt_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel of ``fused_s2vt_bwd_route``
    once and add one to ``fused_s2vt_bwd.launches`` and to
    ``fused_s2vt_bwd.route_launches[route]``; CPU tensors run the plain
    version."""
    if g1.device.type == "cpu":
        return fused_s2vt_bwd_reference(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    _check_bwd_args(g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    tensors = (g1, c1, g2, c2, dout2, w1hh, w2v, w2hh)
    _build.check_cuda("fused_s2vt_bwd", tensors)
    T, B, G = g1.shape
    route = fused_s2vt_bwd_route(G // 4, B, g1.dtype == torch.bfloat16, g1.device)
    return launch_bwd(*tensors, route)


counted(fused_s2vt_bwd, "mma", "direct")


def fused_shapes_ok(dim_hid: int, num_layers: int, rnn_type: str,
                    device: Optional[torch.device] = None) -> bool:
    """Whether the fused kernels serve this model on ``device``: one LSTM
    layer per chain and, on a card, H is even and both direct kernels fit
    (their blocks one per SM with their resident weights in opt-in shared
    memory). The route rules send every batch above 200 of both kernels,
    and every float32 batch of the backward, to the direct kernels, and an
    mma route only shapes its plan fits, so every batch of the model runs
    on a kernel that fits exactly when the direct kernels do. On the CPU
    the plain versions serve any width."""
    if num_layers != 1 or rnn_type != "lstm":
        return False
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    if dim_hid % 2:
        return False
    card = _build.card(device)
    units = units_per_block(dim_hid, card.sms)
    bwd = _bwd_kernel_lib()
    bwd_blocks = -(-dim_hid // bwd.s2vt_fused_bwd_units_per_block())
    return (_kernel_lib().s2vt_fused_fwd_smem_bytes(dim_hid, units) <= card.smem_optin
            and bwd.s2vt_fused_bwd_smem_bytes(dim_hid) <= card.smem_optin
            and bwd_blocks <= card.sms)


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
