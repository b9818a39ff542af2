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
exception. Each has three routes, picked by ``gru_seq_fwd_route`` and
``gru_seq_bwd_route`` from the shapes, the mode and the card before the
launch: "mma" and "direct", and "stream" (``csrc/stream.cuh``), launches
per step (one forward, two backward) with W_hh read from global memory,
where the width's weights do not fit the shared memory of the resident
routes' blocks (on an H100, H > ~1050). So the kernels serve every width on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.launches import counted
from s2vt_tpu_torch.ops.fused_rnn import CardProps, _check_shapes, mma_plan
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


def set_fwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the forward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gru_seq_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.gru_seq_fwd.restype = ci
    lib.gru_seq_fwd_smem_bytes.argtypes = [ci, ci]
    lib.gru_seq_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.gru_seq_fwd_mma.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    lib.gru_seq_fwd_mma.restype = ci
    lib.gru_seq_fwd_mma_smem_bytes.argtypes = [ci] * 4
    lib.gru_seq_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.gru_seq_fwd_stream.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.gru_seq_fwd_stream.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    """The forward kernel's library (built on first use) with its C signatures."""
    return set_fwd_signatures(_build.load(_FWD_LIB_NAME))


def set_bwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the backward library's entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gru_seq_bwd.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.gru_seq_bwd.restype = ci
    lib.gru_seq_bwd_smem_bytes.argtypes = [ci, ci]
    lib.gru_seq_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.gru_seq_bwd_units_per_block.argtypes = [ci, ci]
    lib.gru_seq_bwd_units_per_block.restype = ci
    lib.gru_seq_bwd_mma.argtypes = [vp] * 10 + [ci] * 8 + [vp]
    lib.gru_seq_bwd_mma.restype = ci
    lib.gru_seq_bwd_mma_smem_bytes.argtypes = [ci] * 4
    lib.gru_seq_bwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.gru_seq_bwd_stream.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    lib.gru_seq_bwd_stream.restype = ci
    lib.gru_seq_bwd_stream_scratch_floats.argtypes = [ci, ci]
    lib.gru_seq_bwd_stream_scratch_floats.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library (built on first use) with its C signatures."""
    return set_bwd_signatures(_build.load(_BWD_LIB_NAME))


def _gru_seq_fwd_impl(x_proj_t, w_hh, b_hh, h0, compute_bf16):
    if x_proj_t.device.type == "cpu":
        return gru_seq_fwd_reference(x_proj_t, w_hh, b_hh, h0, compute_bf16)
    _check_fwd_args(x_proj_t, w_hh, b_hh, h0)
    _build.check_cuda("gru_seq_fwd", (x_proj_t, w_hh, b_hh, h0))
    T, B, G = x_proj_t.shape
    route = gru_seq_fwd_route(G // 3, B, compute_bf16, x_proj_t.device)
    return launch_fwd(x_proj_t, w_hh, b_hh, h0, compute_bf16, route)


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

    CUDA tensors (contiguous) launch the kernel of ``gru_seq_fwd_route``
    once and add one to ``gru_seq_fwd.launches`` and to
    ``gru_seq_fwd.route_launches[route]`` (the stream route's T step
    launches are that one launch of the op); CPU tensors run the plain
    version."""
    _build.check_device("gru_seq_fwd", x_proj_t)
    return _gru_seq_fwd_op(x_proj_t, w_hh, b_hh, h0, compute_bf16)


counted(gru_seq_fwd, "mma", "direct", "stream")

_GATES = 3                         # gate rows per unit: mma_plan's layout of csrc/gru_seq_fwd.cu
_MMA_MAX_BATCH = 200               # the largest batch either mma route was measured faster at


def _measured_units(batch: int, compute_bf16: bool) -> int:
    """The U that tools/gru_fwd_variants.py --route layouts measured fastest
    (or within 2.5 % of it) at H = 512, T = 159 on an NVIDIA H100 80GB HBM3
    at 700 W: U = 8 up to B = 32 in both modes (B = 16 float32: 0.5624 ms,
    U = 16 0.5671, U = 4 0.5935; bf16 0.4206, 0.4628, 0.4489), then 16 in
    float32 (B = 96: 2.0551, U = 8 2.1795), 16 up to B = 128 and 32 above
    in bf16 (B = 96: 0.6393, U = 32 0.6820; B = 200: 0.9464, U = 16
    1.0381). More groups of fewer rows: a block polls fewer rows and waits
    for fewer blocks, and its products stay U x rows."""
    if batch <= 32:
        return 8
    return 16 if not compute_bf16 or batch <= 128 else 32


@functools.lru_cache(maxsize=None)
def _plan(hidden: int, batch: int, compute_bf16: bool, props, units: Optional[int],
          measured_units, smem_bytes):
    """``fused_rnn.mma_plan`` with three gate rows per unit and the block's
    ``smem_bytes`` (None: the forward's): at ``units``, or at
    ``measured_units(batch, compute_bf16)`` where that one serves, else at
    the U mma_plan picks. Cached: the route and its launch ask for the same
    plan."""
    if units is None:
        plan = mma_plan(hidden, batch, compute_bf16, props,
                        units=measured_units(batch, compute_bf16), gates=_GATES,
                        smem_bytes=smem_bytes)
        if plan is not None:
            return plan
    return mma_plan(hidden, batch, compute_bf16, props, units=units, gates=_GATES,
                    smem_bytes=smem_bytes)


def _route(plan, hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """"mma" where ``plan`` lays the launch out on ``device`` (a card, or its
    ``CardProps`` or ``_build.Card``) and B <= 200, else "direct"."""
    if batch > _MMA_MAX_BATCH:
        return "direct"
    props = device if isinstance(device, (CardProps, _build.Card)) else _build.card(device)
    return "mma" if plan(hidden, batch, compute_bf16, props) else "direct"


def fwd_direct_fits(hidden: int, props) -> bool:
    """Whether the forward's direct route serves hidden size ``hidden`` on a
    card of ``props`` (anything with ``sms`` and ``smem_optin``): the three
    gate rows of W_hh of its units, one block per SM, fit a block's opt-in
    shared memory."""
    units = units_per_block(hidden, props.sms)
    return _fwd_lib().gru_seq_fwd_smem_bytes(hidden, units) <= props.smem_optin


def bwd_direct_fits(hidden: int, props) -> bool:
    """Whether the backward's direct route serves hidden size ``hidden`` on
    a card of ``props``: one of its instantiations keeps one block per SM,
    and that block's W_hh columns fit its opt-in shared memory."""
    units = _bwd_lib().gru_seq_bwd_units_per_block(hidden, props.sms)
    return units > 0 and _bwd_lib().gru_seq_bwd_smem_bytes(hidden, units) <= props.smem_optin


def gru_mma_plan(hidden: int, batch: int, compute_bf16: bool, props,
                 units: Optional[int] = None):
    """The forward's mma-route layout (``_plan`` at ``_measured_units``)."""
    return _plan(hidden, batch, compute_bf16, props, units, _measured_units, None)


def gru_seq_fwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The kernel that serves hidden size ``hidden``, batch ``batch`` and the
    mode ``compute_bf16`` on ``device`` (a card, or its ``CardProps`` or
    ``_build.Card``): "mma" where ``gru_mma_plan`` serves and B <= 200,
    else "direct" (the grid-synchronised kernel on the CUDA cores; where its
    weights do not fit, ``launch_fwd`` runs it as the "stream" route). On an
    NVIDIA H100 80GB HBM3 at 700 W the mma route was faster in all 60 cells
    of tools/gru_fwd_variants.py --route sweep (H = 512, B in 1, 2, 4, 8,
    16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 200, T = 80 and 159, both
    modes, the two routes in turns): float32 B = 16 0.2657 against 0.3393
    ms at T = 80 and 0.5704 against 0.8542 at T = 159, B = 96 1.1454
    against 2.2333 at T = 80; bf16 B = 16 0.2169 against 0.3682 and B = 96
    0.3482 against 2.0958 at T = 80; the closest float32 B = 4, T = 80
    (0.2322 against 0.2491), the widest bf16 B = 200, T = 159 (0.9754
    against 8.5819). Larger batches were not measured. Chosen before the
    launch, from the shapes, the mode and the card alone."""
    return _route(gru_mma_plan, hidden, batch, compute_bf16, device)


def launch_fwd(x_proj_t, w_hh, b_hh, h0, compute_bf16, route, lib=None, plan=None):
    """One launch of ``route``'s kernel on CUDA tensors checked by the
    caller (or, to time one route beside the other, by chip_smoke.py and
    the variant tool, which may pass its own build as ``lib`` and an mma
    ``plan``). Returns (h seq, gates, gh_n seq, hT). "direct" where its
    blocks' W_hh rows do not fit (``fwd_direct_fits``) runs as "stream": one
    launch per step, W_hh read from global memory."""
    T, B, G = x_proj_t.shape
    H = G // 3
    dev = x_proj_t.device
    if route == "direct" and not fwd_direct_fits(H, _build.card(dev)):
        route = "stream"
    outs = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    ghn = torch.empty_like(outs)
    gates = torch.empty_like(x_proj_t)
    hT = torch.empty(B, H, dtype=torch.float32, device=dev)
    tensors = (x_proj_t, w_hh, b_hh, h0, outs, gates, ghn, hT)
    if route == "mma":
        plan = plan or gru_mma_plan(H, B, compute_bf16, _build.card(dev))
        if plan is None:
            raise ValueError(f"gru_seq_fwd: the mma route does not serve H={H}, B={B}")
        # This launch's exchange: h tagged with its step, by step parity (in
        # bf16 two units per word); zeros tag nothing.
        xch = torch.zeros(2 * B * (H // 2 if compute_bf16 else H), dtype=torch.int64,
                          device=dev)
        _build.launch(lib or _fwd_lib(), "gru_seq_fwd_mma", "gru_seq_fwd", tensors + (xch,),
                      (T, B, H, plan.units, plan.groups, plan.tiles, int(compute_bf16)))
    elif route == "stream":
        _build.launch(lib or _fwd_lib(), "gru_seq_fwd_stream", "gru_seq_fwd", tensors,
                      (T, B, H, int(compute_bf16)))
    else:
        units = units_per_block(H, torch.cuda.get_device_properties(dev).multi_processor_count)
        _build.launch(lib or _fwd_lib(), "gru_seq_fwd", "gru_seq_fwd", tensors,
                      (T, B, H, units, int(compute_bf16)))
    gru_seq_fwd.launches += 1
    gru_seq_fwd.route_launches[route] += 1
    return outs, gates, ghn, hT


def gru_seq_bwd(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16: bool):
    """The backward (``gru_seq_bwd_reference``'s contract).

    CUDA tensors (contiguous) launch the kernel of ``gru_seq_bwd_route``
    once and add one to ``gru_seq_bwd.launches`` and to
    ``gru_seq_bwd.route_launches[route]`` (the stream route's T + 1 step
    launches are that one launch of the op); CPU tensors run the plain
    version."""
    if gates.device.type == "cpu":
        return gru_seq_bwd_reference(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16)
    _check_bwd_args(gates, ghn, hprev, w_hh, dout, dhT)
    _build.check_cuda("gru_seq_bwd", (gates, ghn, hprev, w_hh, dout, dhT))
    T, B, G = gates.shape
    route = gru_seq_bwd_route(G // 3, B, compute_bf16, gates.device)
    return launch_bwd(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16, route)


counted(gru_seq_bwd, "mma", "direct", "stream")


def gru_bwd_smem_bytes(hidden: int, units: int, tiles: int, compute_bf16: bool) -> int:
    """Dynamic shared memory of one mma-route block of the backward
    (``smem_bytes`` in csrc/gru_seq_bwd.cu): the block's W_hh columns, 3H x
    U values (in bf16 U padded to whole n8 tiles), and ``tiles`` m16 tiles of
    operand rows, 3H values each, in the operand type with 16 bytes of
    padding per row; and the partial sums (bf16: one per warp's k share, 8;
    float32: one per slice warp of the direct order, 4)."""
    k = 3 * hidden
    if compute_bf16:
        n = -(-units // 8) * 8
        weights, stride, es, shares = n * (k + 8), k + 8, 2, 8
    else:
        n = units
        weights, stride, es, shares = k * units, k + 4, 4, 4
    return (weights + 16 * tiles * stride) * es + 4 * shares * 16 * tiles * (n + 4)


def _measured_bwd_units(batch: int, compute_bf16: bool) -> int:
    """The U that tools/gru_bwd_variants.py --route layouts measured fastest
    at H = 512, T = 159 on an NVIDIA H100 80GB HBM3 at 700 W: in float32 U =
    4 at B = 1 (0.3113 ms; U = 16 0.4041), 8 up to B = 4 (0.3572; U = 16
    0.3948), then 16 (B = 16 0.5676, U = 8 0.7661; B = 96 2.6188, U = 8
    4.1097); in bf16 U = 8 up to B = 2 (0.3924; U = 32 0.4905), 16 up to
    B = 12 (0.5250; U = 32 0.5438), then 32 (B = 14 0.5423, U = 16 0.5783;
    B = 96 1.1613, U = 16 1.8565). More groups of fewer rows: a block polls
    fewer rows and waits for fewer blocks, while its products stay R x U."""
    if compute_bf16:
        return 8 if batch <= 2 else (16 if batch <= 12 else 32)
    return 4 if batch == 1 else (8 if batch <= 4 else 16)


def gru_bwd_mma_plan(hidden: int, batch: int, compute_bf16: bool, props,
                     units: Optional[int] = None):
    """The backward's mma-route layout (``_plan`` at ``_measured_bwd_units``
    with ``gru_bwd_smem_bytes``; one lane per cell, as the forward's)."""
    return _plan(hidden, batch, compute_bf16, props, units, _measured_bwd_units,
                 gru_bwd_smem_bytes)


def gru_seq_bwd_route(hidden: int, batch: int, compute_bf16: bool, device) -> str:
    """The backward kernel that serves hidden size ``hidden``, batch
    ``batch`` and the mode ``compute_bf16`` on ``device`` (a card, or its
    ``CardProps`` or ``_build.Card``): "mma" where ``gru_bwd_mma_plan``
    serves and B <= 200, else "direct" (the grid-synchronised kernel on the
    CUDA cores; where its weights do not fit, ``launch_bwd`` runs it as the
    "stream" route). On an NVIDIA H100 80GB HBM3 at 700 W the mma route was
    faster in all 76 cells of tools/gru_bwd_variants.py --route sweep (H =
    512, B in 1, 2, 4, 8, 12, 14, 16, 18, 20, 24, 32, 48, 64, 80, 96, 112,
    128, 160, 200, T = 80 and 159, both modes, the two routes in turns):
    float32 B = 16 0.5674 against 0.6459 ms at T = 159 and 0.2840 against
    0.3180 at T = 80, B = 96 2.6213 against 2.8416 at T = 159; bf16 B = 16
    0.5363 against 0.7247 and B = 96 1.1568 against 3.4151 at T = 159; the
    closest float32 B = 80, T = 80 (1.1531 against 1.2171). Larger batches
    were not measured.
    Chosen before the launch, from the shapes, the mode and the card
    alone."""
    return _route(gru_bwd_mma_plan, hidden, batch, compute_bf16, device)


def launch_bwd(gates, ghn, hprev, w_hh, dout, dhT, compute_bf16, route, lib=None, plan=None):
    """One launch of the backward's ``route`` on CUDA tensors checked by the
    caller (or, to time one route beside the other, by chip_smoke.py and the
    variant tool, which may pass its own build as ``lib`` and an mma
    ``plan``). Returns (dxp, dghn, dh0). "direct" where its blocks' W_hh
    columns do not fit (``bwd_direct_fits``) runs as "stream": per
    iteration, the recurrent products in slices, then the cells, W_hh^T
    (transposed once per call into scratch) read from global memory."""
    T, B, G = gates.shape
    H = G // 3
    dev = gates.device
    if route == "direct" and not bwd_direct_fits(H, _build.card(dev)):
        route = "stream"
    dxp = torch.empty_like(gates)
    dghn = torch.empty_like(ghn)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=dev)
    tensors = (gates, ghn, hprev, w_hh, dout, dhT, dxp, dghn, dh0)
    if route == "mma":
        plan = plan or gru_bwd_mma_plan(H, B, compute_bf16, _build.card(dev))
        if plan is None:
            raise ValueError(f"gru_seq_bwd: the mma route does not serve H={H}, B={B}")
        # This launch's exchange: dh tagged with its iteration, by iteration
        # parity; zeros tag nothing.
        xch = torch.zeros(2 * B * H, dtype=torch.int64, device=dev)
        _build.launch(lib or _bwd_lib(), "gru_seq_bwd_mma", "gru_seq_bwd", tensors + (xch,),
                      (T, B, H, plan.units, plan.groups, plan.tiles, int(compute_bf16)))
    elif route == "stream":
        lib = lib or _bwd_lib()
        scratch = torch.empty(lib.gru_seq_bwd_stream_scratch_floats(B, H),
                              dtype=torch.float32, device=dev)     # W_hh^T, partial sums
        _build.launch(lib, "gru_seq_bwd_stream", "gru_seq_bwd", tensors + (scratch,),
                      (T, B, H, int(compute_bf16)))
    else:
        units = _bwd_units(H, dev, lib)
        if not units:
            raise ValueError(f"gru_seq_bwd: hidden size {H} needs more blocks than the card "
                             "has SMs")
        _build.launch(lib or _bwd_lib(), "gru_seq_bwd", "gru_seq_bwd", tensors,
                      (T, B, H, units, int(compute_bf16)))
    gru_seq_bwd.launches += 1
    gru_seq_bwd.route_launches[route] += 1
    return dxp, dghn, dh0


def _bwd_units(hidden: int, device: torch.device, lib=None) -> int:
    """Hidden units per block of the backward's direct route on ``device``
    (0: none of its instantiations keeps one block per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (lib or _bwd_lib()).gru_seq_bwd_units_per_block(hidden, sms)


def gru_seq_shapes_ok(hidden: int, device: Optional[torch.device] = None) -> bool:
    """Whether both GRU sequence kernels serve hidden size ``hidden`` on
    ``device`` with their weights resident in shared memory, that is on a
    route other than "stream": on a card, each direct route's blocks fit one
    per SM with their W_hh rows in opt-in shared memory (on an H100,
    H <= ~1050). Every width is served either way; on the CPU the plain
    versions serve it. (The TPU gate ``pallas_shapes_ok`` -- B % 8, B <= 96,
    H % 128 -- is a fact of the TPU's VMEM and tiles.)"""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return True
    props = _build.card(device)
    return fwd_direct_fits(hidden, props) and bwd_direct_fits(hidden, props)


class _GRUSeq(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` ``_gru_seq`` in ``pallas_gru.py``
    (``_gru_seq_fwd`` / ``_gru_seq_bwd``): the forward kernel saves the h,
    gate and gh_n sequences; the backward kernel gives dx_proj, dghn and dh0,
    and dW_hh and db_hh are float32 reductions of the recurrent-side gate
    gradients [dr_pre | dz_pre | dghn] against the previous-step h sequence.
    Each kernel runs on the route its wrapper picks for the batch and mode."""

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
