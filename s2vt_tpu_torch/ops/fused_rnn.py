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
exception. Each has three routes: the forward "mma" and "direct", picked by
``lstm_seq_fwd_route``, the backward "cluster" and "direct", picked by
``lstm_seq_bwd_route``, each from the shapes, the mode and the card before
the launch; and for both "stream" (``csrc/stream.cuh``), launches per step
(one forward, two backward) with W_hh read from global memory, where the
width's weights do not fit the shared memory of the resident routes'
blocks (on an H100, H > ~1050). So the kernels serve every width on the
card, as the TPU kernels serve every width their gate admits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted
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


def set_fwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the forward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_seq_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.lstm_seq_fwd.restype = ci
    lib.lstm_seq_fwd_smem_bytes.argtypes = [ci, ci]
    lib.lstm_seq_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_seq_fwd_mma.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    lib.lstm_seq_fwd_mma.restype = ci
    lib.lstm_seq_fwd_mma_smem_bytes.argtypes = [ci] * 4
    lib.lstm_seq_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_seq_fwd_stream.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.lstm_seq_fwd_stream.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    """The forward kernel's library (built on first use) with its C signatures."""
    return set_fwd_signatures(_build.load(_FWD_LIB_NAME))


def set_bwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the backward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_seq_bwd.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.lstm_seq_bwd.restype = ci
    lib.lstm_seq_bwd_smem_bytes.argtypes = [ci, ci]
    lib.lstm_seq_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_seq_bwd_units_per_block.argtypes = [ci, ci]
    lib.lstm_seq_bwd_units_per_block.restype = ci
    lib.lstm_seq_bwd_cluster.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.lstm_seq_bwd_cluster.restype = ci
    lib.lstm_seq_bwd_cluster_serves.argtypes = [ci, ci]
    lib.lstm_seq_bwd_cluster_serves.restype = ci
    lib.lstm_seq_bwd_cluster_smem_bytes.argtypes = [ci, ci, ci]
    lib.lstm_seq_bwd_cluster_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_seq_bwd_cluster_active.argtypes = [ci, ctypes.POINTER(ci)]
    lib.lstm_seq_bwd_cluster_active.restype = ci
    lib.lstm_seq_bwd_stream.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.lstm_seq_bwd_stream.restype = ci
    lib.lstm_seq_bwd_stream_scratch_floats.argtypes = [ci, ci]
    lib.lstm_seq_bwd_stream_scratch_floats.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    return set_bwd_signatures(_build.load(_BWD_LIB_NAME))


def _lstm_seq_fwd_impl(x_proj_t, w_hh, h0, c0, compute_bf16):
    if x_proj_t.device.type == "cpu":
        outs, gates, cseq, hT, cT = lstm_seq_fwd_reference(x_proj_t, w_hh, h0, c0,
                                                           compute_bf16)
        return outs, gates, cseq, torch.stack([hT, cT])
    _check_fwd_args(x_proj_t, w_hh, h0, c0)
    _build.check_cuda("lstm_seq_fwd", (x_proj_t, w_hh, h0, c0))
    T, B, G = x_proj_t.shape
    route = lstm_seq_fwd_route(G // 4, B, compute_bf16, x_proj_t.device)
    return launch_fwd(x_proj_t, w_hh, h0, c0, compute_bf16, route)


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

    CUDA tensors (contiguous) launch the kernel of ``lstm_seq_fwd_route``
    once and add one to ``lstm_seq_fwd.launches`` and to
    ``lstm_seq_fwd.route_launches[route]`` (the stream route's T step
    launches are that one launch of the op); CPU tensors run the plain
    version."""
    _build.check_device("lstm_seq_fwd", x_proj_t)
    outs, gates, cseq, fin = _lstm_seq_fwd_op(x_proj_t, w_hh, h0, c0, compute_bf16)
    return outs, gates, cseq, fin[0], fin[1]


counted(lstm_seq_fwd, "mma", "direct", "stream")


def lstm_seq_bwd(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16: bool):
    """The backward (``lstm_seq_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel of ``lstm_seq_bwd_route``
    once and add one to ``lstm_seq_bwd.launches`` and to
    ``lstm_seq_bwd.route_launches[route]`` (the stream route's T + 1 step
    launches are that one launch of the op); CPU tensors run the plain
    version."""
    if gates.device.type == "cpu":
        return lstm_seq_bwd_reference(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16)
    _check_bwd_args(gates, cseq, cprev, w_hh, dout, dhT, dcT)
    _build.check_cuda("lstm_seq_bwd", (gates, cseq, cprev, w_hh, dout, dhT, dcT))
    T, B, G = gates.shape
    route = lstm_seq_bwd_route(G // 4, B, compute_bf16, gates.device)
    return launch_bwd(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16, route)


counted(lstm_seq_bwd, "cluster", "direct", "stream")

# The cluster route (csrc/lstm_seq_bwd.cu, namespace cluster_route): the
# shape of its clusters and blocks.
CLUSTER_BLOCKS = 8                 # blocks per cluster (kQ)
_CLUSTER_UNITS = 8                 # hidden units whose cells a block runs
_CLUSTER_MAX_BATCH = 256
_CLUSTER_MAX_HIDDEN = 512
_CLUSTER_MIN_SMEM = 120 * 1024     # one block per SM
_CLUSTER_MAX_SLICE = 256           # gate rows of a block's slice, 4H / 8


class CardProps(NamedTuple):
    """What the routes depend on, of one card: its SMs, the opt-in shared
    memory of a block (``_build.Card``), and the clusters of 8 cluster-route
    blocks (of the backward) the card holds at once."""
    sms: int
    smem_optin: int
    active_clusters: int


def cluster_smem_bytes(hidden: int, batch: int, compute_bf16: bool) -> int:
    """Dynamic shared memory of one cluster-route block (``smem_bytes`` in
    the source): two m16 row tiles of the gate slice, the k shares of two
    tiles, the two parities of the partials pushed by the cluster's 8
    blocks, and the staged inputs of the block's cells; at least
    ``_CLUSTER_MIN_SMEM``."""
    q = CLUSTER_BLOCKS
    cols = _CLUSTER_UNITS * q
    warps_k = 8 // (cols // 32)
    tiles = 2 * 16 * (4 * hidden // q + (8 if compute_bf16 else 4))
    shares = 2 * warps_k * 16 * (cols + 8)
    recv = 2 * q * -(-batch // 16) * 16 * _CLUSTER_UNITS
    cells = 7 * -(-batch // 32) * 256
    return max(4 * (tiles + shares + recv + cells), _CLUSTER_MIN_SMEM)


def cluster_serves(hidden: int, batch: int, props: CardProps) -> bool:
    """Whether the cluster route serves hidden size ``hidden`` and batch
    ``batch`` on a card of ``props``: 128 <= H <= 512 with H % 128 == 0 (a
    warp's k range, H / 8 gate rows, is whole k16 slices; its weight
    fragments are sized for H <= 512) and 1 <= B <= 256 (its cells per
    thread), with the H / 64 clusters co-resident at one block per SM and
    the shared memory of the batch (in bf16, the larger) within the card's
    (B <= 208 at H = 512)."""
    clusters = hidden // (_CLUSTER_UNITS * CLUSTER_BLOCKS)
    return (128 <= hidden <= _CLUSTER_MAX_HIDDEN and hidden % 128 == 0
            and 1 <= batch <= _CLUSTER_MAX_BATCH
            and 4 * hidden // CLUSTER_BLOCKS <= _CLUSTER_MAX_SLICE
            and clusters * CLUSTER_BLOCKS <= props.sms and props.active_clusters >= clusters
            and cluster_smem_bytes(hidden, batch, True) <= props.smem_optin)


@functools.lru_cache(maxsize=None)
def _card_props(index: int) -> CardProps:
    n = ctypes.c_int(0)
    lib = _bwd_lib()
    err = lib.lstm_seq_bwd_cluster_active(index, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd: cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.s2vt_cuda_error_string(err).decode()} (cudaError {err})")
    return CardProps(*_build.card(torch.device("cuda", index)), n.value)


def card_props(device) -> CardProps:
    """``CardProps`` of card ``device``, read once per card."""
    device = torch.device(device)
    return _card_props(device.index if device.index is not None else torch.cuda.current_device())


def lstm_seq_bwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The kernel that serves hidden size ``hidden``, batch ``batch`` and the
    mode ``compute_bf16`` on ``device`` (a card, or its ``CardProps``):
    in bf16 "cluster" where ``cluster_serves`` (H = 512 at every batch up to
    208 on an H100), else "direct" (the grid-synchronised kernel on the CUDA
    cores; where its weights do not fit, ``launch_bwd`` runs it as the
    "stream" route). Float32 always takes "direct": on an NVIDIA H100 80GB
    HBM3 at 700 W the cluster route's three TF32 passes made it slower there at
    every measured shape (H = 512: 0.7069 against 0.6480 ms at B = 16,
    T = 159; 3.0059 against 2.7962 at B = 96; 0.3699 against 0.3218 at
    B = 16, T = 80), and faster in bf16 (0.5645 against 0.7365 ms at B = 16,
    T = 159; chip_smoke.py phase 2). Chosen before the launch, from the
    shapes, the mode and the card alone."""
    if not compute_bf16:
        return "direct"
    props = device if isinstance(device, CardProps) else card_props(device)
    return "cluster" if cluster_serves(hidden, batch, props) else "direct"


def launch_bwd(gates, cseq, cprev, w_hh, dout, dhT, dcT, compute_bf16, route, lib=None):
    """One launch of ``route``'s kernel on CUDA tensors checked by the
    caller (or, to time one route beside the other, by chip_smoke.py and
    the variant tool, which may pass its own build as ``lib``). "direct"
    where its blocks' W_hh columns do not fit (``bwd_direct_fits``) runs as
    "stream": per iteration, the recurrent products in slices, then the
    cells, W_hh^T (transposed once per call into scratch) read from global
    memory."""
    T, B, G = gates.shape
    H = G // 4
    dev = gates.device
    if route == "direct" and not bwd_direct_fits(H, _build.card(dev)):
        route = "stream"
    dxp = torch.empty_like(gates)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    outs = (gates, cseq, cprev, w_hh, dout, dhT, dcT, dxp, dh0, dc0)
    if route == "cluster":
        # This launch's exchange: gate gradients tagged with their step, by
        # step parity; zeros tag nothing.
        xch = torch.zeros(2 * B * G, dtype=torch.int64, device=dev)
        _build.launch(lib or _bwd_lib(), "lstm_seq_bwd_cluster", "lstm_seq_bwd",
                      outs + (xch,), (T, B, H, int(compute_bf16)))
    elif route == "stream":
        lib = lib or _bwd_lib()
        scratch = torch.empty(lib.lstm_seq_bwd_stream_scratch_floats(B, H),
                              dtype=torch.float32, device=dev)     # W_hh^T, partial sums
        _build.launch(lib, "lstm_seq_bwd_stream", "lstm_seq_bwd", outs + (scratch,),
                      (T, B, H, int(compute_bf16)))
    else:
        units = _bwd_units(H, dev)
        if not units:
            raise ValueError(f"lstm_seq_bwd: hidden size {H} needs more blocks than the card "
                             "has SMs")
        _build.launch(lib or _bwd_lib(), "lstm_seq_bwd", "lstm_seq_bwd", outs,
                      (T, B, H, units, int(compute_bf16)))
    lstm_seq_bwd.launches += 1
    lstm_seq_bwd.route_launches[route] += 1
    return dxp, dh0, dc0


def _bwd_units(hidden: int, device: torch.device) -> int:
    """Hidden units per block of the direct route on ``device`` (0: none of
    its instantiations keeps one block per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _bwd_lib().lstm_seq_bwd_units_per_block(hidden, sms)


def fwd_direct_fits(hidden: int, props) -> bool:
    """Whether the forward's direct route serves hidden size ``hidden`` on a
    card of ``props`` (anything with ``sms`` and ``smem_optin``): the four
    gate rows of W_hh of its units, one block per SM, fit a block's opt-in
    shared memory."""
    units = units_per_block(hidden, props.sms)
    return _fwd_lib().lstm_seq_fwd_smem_bytes(hidden, units) <= props.smem_optin


def bwd_direct_fits(hidden: int, props) -> bool:
    """Whether the backward's direct route serves hidden size ``hidden`` on
    a card of ``props``: one of its instantiations keeps one block per SM,
    and that block's W_hh columns fit its opt-in shared memory."""
    units = _bwd_lib().lstm_seq_bwd_units_per_block(hidden, props.sms)
    return units > 0 and _bwd_lib().lstm_seq_bwd_smem_bytes(hidden, units) <= props.smem_optin


# The "mma" routes of the per-layer forwards (namespace mma_route of
# csrc/lstm_seq_fwd.cu, 4 gate rows per unit, and of csrc/gru_seq_fwd.cu, 3):
# their blocks and what each holds.
_MMA_UNITS = (4, 8, 16, 32)        # instantiated hidden units per block (U); 32 in bf16 only
_MMA_THREADS = 256
_MMA_CELL_LANES = {4: 4, 3: 1}     # per gate count: the lanes that run one cell
_MMA_SLOTS = {4: 16, 3: 4}         # per gate count: (cell, lane) slots a thread runs per step
_MMA_MAX_TILES = 4                 # m16 row tiles staged per pass
_MMA_MAX_HIDDEN = 512              # a lane's 16-byte exchange loads cover a row
_MMA_MAX_BATCH = 128               # the largest batch it was measured faster at (LSTM)


class MmaPlan(NamedTuple):
    """How the mma route lays out one launch: ``groups`` batch groups of
    ``rows`` rows (the last may hold fewer), each run by H / ``units``
    blocks that own ``units`` hidden units each; a block stages ``tiles``
    m16 row tiles of its group per pass, ``passes`` passes per step."""
    units: int
    groups: int
    rows: int
    tiles: int
    passes: int


def mma_smem_bytes(hidden: int, units: int, tiles: int, compute_bf16: bool,
                   gates: int = 4) -> int:
    """Dynamic shared memory of one mma-route block (``smem_bytes`` in the
    source) of the forward with ``gates`` gate rows per unit: the block's
    gates x U rows of W_hh (padded to whole n8 tiles) and ``tiles`` m16 tiles
    of h, in the operand type with 16 bytes of padding per row, and the gate
    sums (in bf16 one k share per warp of a column tile; float32 sums
    whole)."""
    es, pad = (2, 8) if compute_bf16 else (4, 4)
    n = -(-gates * units // 8) * 8
    n_tiles = n // 8
    per_warp = 3 if n_tiles % 3 == 0 else max(1, n_tiles // 8)   # n8 tiles per warp
    shares = 8 // (n_tiles // per_warp) if compute_bf16 else 1
    return (n + 16 * tiles) * (hidden + pad) * es + 4 * shares * 16 * tiles * (n + 4)


def mma_plan(hidden: int, batch: int, compute_bf16: bool, props: CardProps,
             units: Optional[int] = None, gates: int = 4,
             smem_bytes=None) -> Optional[MmaPlan]:
    """The mma route's layout for hidden size ``hidden`` and batch ``batch``
    on a card of ``props`` (anything with ``sms`` and ``smem_optin``), for
    the forward with ``gates`` gate rows per unit (4: LSTM, kernel #3; 3:
    GRU, kernel #5; 3 with ``smem_bytes(hidden, units, tiles,
    compute_bf16)``: the GRU backward, kernel #6), or None where it does not
    serve: 128 <= H <= 512, H % 128 == 0. For each U (``units``, or each
    instantiated one; 32 only in bf16) the batch splits into as many groups
    as the card's SMs hold
    (G H / U <= SMs), a block stages as many of its group's m16 tiles per
    pass as its shared memory and its thread slots allow (16 (cell, gate)
    pairs per thread for the LSTM's four lanes per cell, 4 cells for the
    GRU's one lane); of these the plan with the fewest padded products per
    block (m16 tiles per group x U), then passes, then rows per group is
    chosen (on an NVIDIA H100 80GB HBM3 at H = 512,
    tools/lstm_fwd_variants.py: U = 4 fastest at B = 16, U = 8 at B = 96 in
    float32)."""
    if not (128 <= hidden <= _MMA_MAX_HIDDEN and hidden % 128 == 0 and batch >= 1):
        return None
    lanes = _MMA_CELL_LANES[gates]
    smem = smem_bytes or functools.partial(mma_smem_bytes, gates=gates)
    plans = []
    for u in (units,) if units else _MMA_UNITS:
        groups = min(props.sms // (hidden // u), batch)
        if u not in _MMA_UNITS or (u == 32 and not compute_bf16) or groups < 1:
            continue
        rows = -(-batch // groups)
        groups = -(-batch // rows)
        m_tiles = -(-rows // 16)
        for tiles in range(min(m_tiles, _MMA_MAX_TILES), 0, -1):
            passes = -(-m_tiles // tiles)
            slots = passes * -(-16 * tiles * u * lanes // _MMA_THREADS)
            if (slots <= _MMA_SLOTS[gates]
                    and smem(hidden, u, tiles, compute_bf16) <= props.smem_optin):
                plans.append(MmaPlan(u, groups, rows, tiles, passes))
                break
    return min(plans, key=lambda p: (-(-p.rows // 16) * p.units, p.passes, p.rows),
               default=None)


def lstm_seq_fwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The kernel that serves hidden size ``hidden``, batch ``batch`` and the
    mode ``compute_bf16`` on ``device`` (a card, or its ``CardProps``):
    "mma" where ``mma_plan`` serves and B <= 128, else "direct" (the
    grid-synchronised kernel on the CUDA cores; where its weights do not
    fit, ``launch_fwd`` runs it as the "stream" route). On an NVIDIA H100
    80GB HBM3 at 700 W the mma route was faster at every measured batch up to 128, in
    both modes, at T = 80 and 159 (tools/lstm_fwd_variants.py --route
    sweep, H = 512, B in 1, 2, 4, 8, 16, 24, 32, 48, 64, 80, 96, 112, 128,
    the two routes in turns): float32, T = 80, 0.2216 against 0.2929 ms at
    B = 1, 0.3090 against 0.4159 at B = 16, 1.2661 against 2.2776 at B = 96,
    1.5196 against 2.9958 at B = 128; at T = 159 0.6437 against 0.9295 at
    B = 16 and 2.4872 against 4.5148 at B = 96 (the closest, B = 80: 2.8339
    against 3.7976); bf16, T = 80, 0.2358 against 0.4311 at B = 16 and
    0.6417 against 2.3189 at B = 96. Larger batches were not measured.
    Chosen before the launch, from the shapes, the mode and the card
    alone."""
    if batch > _MMA_MAX_BATCH:
        return "direct"
    props = device if isinstance(device, CardProps) else card_props(device)
    return "mma" if mma_plan(hidden, batch, compute_bf16, props) else "direct"


def launch_fwd(x_proj_t, w_hh, h0, c0, compute_bf16, route, lib=None, plan=None):
    """One launch of ``route``'s kernel on CUDA tensors checked by the
    caller (or, to time one route beside the other, by chip_smoke.py and
    the variant tool, which may pass its own build as ``lib`` and an mma
    ``plan``). Returns (h seq, gates, c seq, fin = [hT, cT]). "direct" where
    its blocks' W_hh rows do not fit (``fwd_direct_fits``) runs as "stream":
    one launch per step, W_hh read from global memory."""
    T, B, G = x_proj_t.shape
    H = G // 4
    dev = x_proj_t.device
    if route == "direct" and not fwd_direct_fits(H, _build.card(dev)):
        route = "stream"
    outs = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    cseq = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    fin = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    tensors = (x_proj_t, w_hh, h0, c0, outs, gates, cseq, fin)
    if route == "mma":
        plan = plan or mma_plan(H, B, compute_bf16, card_props(dev))
        if plan is None:
            raise ValueError(f"lstm_seq_fwd: the mma route does not serve H={H}, B={B}")
        # This launch's exchange: h tagged with its step, by step parity (in
        # bf16 two units per word); zeros tag nothing.
        xch = torch.zeros(2 * B * (H // 2 if compute_bf16 else H), dtype=torch.int64,
                          device=dev)
        _build.launch(lib or _fwd_lib(), "lstm_seq_fwd_mma", "lstm_seq_fwd", tensors + (xch,),
                      (T, B, H, plan.units, plan.groups, plan.tiles, int(compute_bf16)))
    elif route == "stream":
        _build.launch(lib or _fwd_lib(), "lstm_seq_fwd_stream", "lstm_seq_fwd", tensors,
                      (T, B, H, int(compute_bf16)))
    else:
        units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
        _build.launch(lib or _fwd_lib(), "lstm_seq_fwd", "lstm_seq_fwd", tensors,
                      (T, B, H, units, int(compute_bf16)))
    lstm_seq_fwd.launches += 1
    lstm_seq_fwd.route_launches[route] += 1
    return outs, gates, cseq, fin


def lstm_seq_shapes_ok(hidden: int, device: Optional[torch.device] = None) -> bool:
    """Whether both kernels serve hidden size ``hidden`` on ``device`` with
    their weights resident in shared memory, that is on a route other than
    "stream": on a card, each direct route's blocks fit one per SM with their
    W_hh rows in opt-in shared memory (on an H100, H <= ~1050). Every width
    is served either way; on the CPU the plain versions serve it. (The TPU
    gate ``pallas_shapes_ok`` -- B % 8, B <= 96, H % 128 -- is a fact of the
    TPU's VMEM and tiles.)"""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    props = _build.card(device)
    return fwd_direct_fits(hidden, props) and bwd_direct_fits(hidden, props)


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
