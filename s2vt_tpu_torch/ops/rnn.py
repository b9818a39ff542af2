"""Torch-semantics recurrent cells written out op by op.

Counterpart of ``s2vt_tpu/ops/rnn.py``. Gate order and biases follow
``torch.nn.LSTM`` / ``torch.nn.GRU``:

LSTM (i, f, g, o):  gates = x @ W_ih^T + b_ih + h @ W_hh^T + b_hh
                    c' = f*c + i*g ;  h' = o * tanh(c')
GRU (r, z, n):      n = tanh(gi_n + r * (h @ W_hn^T + b_hn))
                    h' = (1-z)*n + z*h

The cells are explicit rather than ``nn.LSTM`` because the reference's bf16
mode (bf16 matmul operands, float32 state and gate math) is not what
``nn.LSTM`` does in bf16. The input projection of a whole sequence is one
matmul outside the time loop. With ``use_pallas``, ``TorchRNN`` runs every
layer, at every width, through the per-layer sequence kernels:
``ops/fused_rnn.py`` for an LSTM, ``ops/fused_gru.py`` for a GRU.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from s2vt_tpu_torch.ops.layers import dropout, mm_operand


class LSTMState(NamedTuple):
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]  (zeros and unused for GRU)


def input_projection(xs: torch.Tensor, params, compute_dtype=None) -> torch.Tensor:
    """[..., in] -> [..., gates*H]: x @ W_ih^T + b_ih in float32."""
    proj = mm_operand(xs, compute_dtype) @ mm_operand(params["w_ih"], compute_dtype).T
    return proj + params["b_ih"].float()


def _hidden_projection(h: torch.Tensor, params, compute_dtype=None) -> torch.Tensor:
    proj = mm_operand(h, compute_dtype) @ mm_operand(params["w_hh"], compute_dtype).T
    return proj + params["b_hh"].float()


def lstm_step(state: LSTMState, x_proj: torch.Tensor, params,
              compute_dtype=None) -> Tuple[LSTMState, torch.Tensor]:
    """One LSTM step given the precomputed input projection x_proj [B, 4H]."""
    h, c = state
    gates = x_proj + _hidden_projection(h, params, compute_dtype)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return LSTMState(h_new, c_new), h_new


def gru_step(state: LSTMState, x_proj: torch.Tensor, params,
             compute_dtype=None) -> Tuple[LSTMState, torch.Tensor]:
    """One GRU step. state.c is carried untouched (torch GRU has no cell)."""
    h = state.h
    gh = _hidden_projection(h, params, compute_dtype)
    gi_r, gi_z, gi_n = x_proj.chunk(3, dim=-1)
    gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    h_new = (1.0 - z) * n + z * h
    return LSTMState(h_new, state.c), h_new


_STEP_FNS = {"lstm": lstm_step, "gru": gru_step}


def rnn_sequence(xs: torch.Tensor, params, h0: Optional[LSTMState] = None,
                 rnn_type: str = "lstm", reverse: bool = False,
                 compute_dtype=None) -> Tuple[torch.Tensor, LSTMState]:
    """One RNN direction over a sequence. xs [B, T, in] ->
    (outputs [B, T, H], final LSTMState); ``reverse`` walks time backwards
    and leaves each output at its own time index."""
    B, T, _ = xs.shape
    H = params["w_hh"].shape[1]
    step_fn = _STEP_FNS[rnn_type]
    if h0 is None:
        zeros = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
        h0 = LSTMState(zeros, zeros)
    x_proj = input_projection(xs, params, compute_dtype)       # [B, T, gates*H]
    outs: List[Optional[torch.Tensor]] = [None] * T
    state = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        state, outs[t] = step_fn(state, x_proj[:, t], params, compute_dtype)
    return torch.stack(outs, dim=1), state


def kernel_sequence(xs: torch.Tensor, params, h0: Optional[LSTMState] = None,
                    rnn_type: str = "lstm", reverse: bool = False,
                    compute_dtype=None) -> Tuple[torch.Tensor, LSTMState]:
    """``rnn_sequence`` through the sequence kernels
    (``ops/fused_rnn.py::lstm_sequence`` or ``ops/fused_gru.py::gru_sequence``).
    The kernels run forward in time only, so ``reverse`` flips time around
    them, as the JAX package does."""
    if rnn_type == "lstm":
        from s2vt_tpu_torch.ops.fused_rnn import lstm_sequence as sequence
    else:
        from s2vt_tpu_torch.ops.fused_gru import gru_sequence as sequence
    if not reverse:
        return sequence(xs, params, h0, compute_dtype)
    out, fin = sequence(torch.flip(xs, dims=[1]), params, h0, compute_dtype)
    return torch.flip(out, dims=[1]), fin


def multilayer_rnn(xs: torch.Tensor, layer_params: Sequence, h0: Optional[Sequence] = None,
                   rnn_type: str = "lstm", bidirectional: bool = False,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = True,
                   compute_dtype=None,
                   sequence_fn=rnn_sequence) -> Tuple[torch.Tensor, list]:
    """Stacked (optionally bidirectional) RNN with ``nn.LSTM`` semantics:
    dropout between layers only. For bidirectional, ``layer_params`` holds
    (forward, reverse) pairs. ``sequence_fn`` runs one direction of one
    layer (``rnn_sequence``'s signature). Returns (outputs [B, T, H*dirs],
    finals)."""
    out = xs
    finals = []
    n_layers = len(layer_params)
    for li, lp in enumerate(layer_params):
        init = h0[li] if h0 is not None else None
        if bidirectional:
            fwd_p, bwd_p = lp
            init_f, init_b = init if init is not None else (None, None)
            out_f, fin_f = sequence_fn(out, fwd_p, init_f, rnn_type, False, compute_dtype)
            out_b, fin_b = sequence_fn(out, bwd_p, init_b, rnn_type, True, compute_dtype)
            out = torch.cat([out_f, out_b], dim=-1)
            finals.append((fin_f, fin_b))
        else:
            out, fin = sequence_fn(out, lp, init, rnn_type, False, compute_dtype)
            finals.append(fin)
        if li < n_layers - 1:
            out = dropout(out, dropout_rate, generator, deterministic)
    return out, finals


def multilayer_step(states: Sequence[LSTMState], x: torch.Tensor, layer_params: Sequence,
                    rnn_type: str = "lstm",
                    compute_dtype=None) -> Tuple[list, torch.Tensor]:
    """One step of a stacked unidirectional RNN. x: [B, in] -> [B, H]."""
    step_fn = _STEP_FNS[rnn_type]
    new_states = []
    out = x
    for params, st in zip(layer_params, states):
        x_proj = input_projection(out, params, compute_dtype)
        st2, out = step_fn(st, x_proj, params, compute_dtype)
        new_states.append(st2)
    return new_states, out


def _rnn_params(gates: int, input_size: int, hidden_size: int) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w_ih": nn.Parameter(torch.empty(gates * hidden_size, input_size)),
        "w_hh": nn.Parameter(torch.empty(gates * hidden_size, hidden_size)),
        "b_ih": nn.Parameter(torch.empty(gates * hidden_size)),
        "b_hh": nn.Parameter(torch.empty(gates * hidden_size)),
    })


class TorchRNN(nn.Module):
    """Torch-layout RNN parameters, one ``ParameterDict`` per layer and
    direction: ``l{i}`` (and ``l{i}_reverse``), each holding w_ih, w_hh,
    b_ih and b_hh, so the state_dict keys mirror the JAX param tree."""

    def __init__(self, hidden_size: int, input_size: int, num_layers: int = 1,
                 bidirectional: bool = False, rnn_type: str = "lstm",
                 dropout: float = 0.0, compute_dtype=None, use_pallas: bool = False):
        super().__init__()
        self.hidden_size, self.input_size = hidden_size, input_size
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.rnn_type, self.dropout = rnn_type, dropout
        self.compute_dtype, self.use_pallas = compute_dtype, use_pallas
        gates = 4 if rnn_type == "lstm" else 3
        dirs = 2 if bidirectional else 1
        for li in range(num_layers):
            in_size = input_size if li == 0 else hidden_size * dirs
            self.add_module(f"l{li}", _rnn_params(gates, in_size, hidden_size))
            if bidirectional:
                self.add_module(f"l{li}_reverse", _rnn_params(gates, in_size, hidden_size))
        self.reset_parameters()

    @property
    def layers(self) -> tuple:
        """Per-layer params (pairs when bidirectional), as the JAX module's."""
        if self.bidirectional:
            return tuple((getattr(self, f"l{i}"), getattr(self, f"l{i}_reverse"))
                         for i in range(self.num_layers))
        return tuple(getattr(self, f"l{i}") for i in range(self.num_layers))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's default RNN init: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        k = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def forward(self, xs: torch.Tensor, h0=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """xs [B, T, in] -> (outputs [B, T, H*dirs], finals per layer). With
        ``use_pallas``, each layer and direction runs through the sequence
        kernels of its cell type (on CPU tensors: their plain versions), as
        the JAX module routes to its Pallas kernels. The kernels serve every
        width on the card: a width whose weights do not fit their blocks'
        shared memory takes their "stream" route."""
        sequence_fn = kernel_sequence if self.use_pallas else rnn_sequence
        return multilayer_rnn(xs, self.layers, h0, self.rnn_type, self.bidirectional,
                              self.dropout, generator, deterministic, self.compute_dtype,
                              sequence_fn)
