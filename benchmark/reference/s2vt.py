"""Plain S2VT in float32 PyTorch: the benchmark's reference.

Written from the reference's equations (Kamino666/S2VT-video-caption,
S2VTModel.py:10-110, train.py:89-122) with ``torch.nn.LSTM`` / ``nn.GRU``
gate order and biases; it imports nothing of the program under test.

- ``feat_linear`` projects the [B, L, F] features to H; ``vid_rnn`` runs over
  them and L-1 zero steps (2L-1 steps); ``word_rnn`` reads [embedding;
  vid_rnn's output], the embedding zero over the first L steps and then
  that of the previous word; ``out_linear`` maps word_rnn's last L-1
  outputs to the vocabulary.
- The loss is the masked mean cross-entropy of labels[:, 1:].
- Training steps are Adam(W) with lr, betas (0.9, 0.999), eps 1e-8 and the
  configuration's weight decay, written out.
- ``decode_gaps`` follows a greedy decode's served tokens: at each decoding
  step it feeds the previous served token (<sos> first) and reads how far
  the served token's logit lies below the step's best.

Every matrix product goes through ``matmul``: float32 with TF32 off
(``precision="float32"``), or, for the control, with both operands and the
backward's gradient rounded to TF32 (``precision="tf32"``), which is what
the tensor cores' TF32 mode computes, on any device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.T, a.T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """[M, K] @ [K, N] in the given precision, TF32 mode switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    if precision != "float32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: str) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T + b."""
    y = matmul(x.reshape(-1, x.shape[-1]), w.T, precision).view(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


def lstm_cell(xp, h, c, w_hh, b_hh, precision):
    gates = xp + linear(h, w_hh, b_hh, precision)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell(xp, h, w_hh, b_hh, precision):
    gh = linear(h, w_hh, b_hh, precision)
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


class Chain:
    """One single-layer RNN's weights and state, stepped by hand."""

    def __init__(self, params: Params, prefix: str, rnn_type: str, batch: int,
                 precision: str):
        self.w_ih, self.w_hh = params[f"{prefix}.l0.w_ih"], params[f"{prefix}.l0.w_hh"]
        self.b_ih, self.b_hh = params[f"{prefix}.l0.b_ih"], params[f"{prefix}.l0.b_hh"]
        self.lstm, self.precision = rnn_type == "lstm", precision
        H = self.w_hh.shape[1]
        self.h = torch.zeros(batch, H, device=self.w_hh.device)
        self.c = torch.zeros_like(self.h)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w_ih, self.b_ih, self.precision)

    def step(self, xp: torch.Tensor) -> torch.Tensor:
        if self.lstm:
            self.h, self.c = lstm_cell(xp, self.h, self.c, self.w_hh, self.b_hh,
                                       self.precision)
        else:
            self.h = gru_cell(xp, self.h, self.w_hh, self.b_hh, self.precision)
        return self.h


def _vid_outputs(params: Params, feats: torch.Tensor, cfg: dict,
                 precision: str) -> torch.Tensor:
    """vid_rnn's outputs [B, 2L-1, H] over [feat_linear(feats); zeros]."""
    B, L = feats.shape[0], cfg["length"]
    fp = linear(feats, params["feat_linear.weight"], params["feat_linear.bias"], precision)
    x = torch.cat([fp, fp.new_zeros(B, L - 1, fp.shape[-1])], dim=1)
    vid = Chain(params, "vid_rnn", cfg["rnn_type"], B, precision)
    xp = vid.project(x)
    return torch.stack([vid.step(xp[:, t]) for t in range(2 * L - 1)], dim=1)


def train_logits(params: Params, feats: torch.Tensor, labels: torch.Tensor, cfg: dict,
                 precision: str) -> torch.Tensor:
    """Teacher-forced logits [B, L-1, V] of labels[:, :-1] (S2VTModel.py:69-81)."""
    B, L, E = feats.shape[0], cfg["length"], cfg["dim_embed"]
    out1 = _vid_outputs(params, feats, cfg, precision)
    emb = params["embedding.weight"][labels[:, :L - 1]]
    emb = torch.cat([emb.new_zeros(B, L, E), emb], dim=1)
    word = Chain(params, "word_rnn", cfg["rnn_type"], B, precision)
    xp = word.project(torch.cat([emb, out1], dim=-1))
    outs = [word.step(xp[:, t]) for t in range(2 * L - 1)]
    h = torch.stack(outs[L:], dim=1)
    return linear(h, params["out_linear.weight"], params["out_linear.bias"], precision)


def masked_ce(logits, labels, mask, valid) -> torch.Tensor:
    """Mean of -log p(labels[:, 1:]) weighted by mask[:, 1:] and each row's
    ``valid`` (utils.py:13-26, as intended)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, 1:, None]).squeeze(-1)
    w = mask[:, 1:] * valid[:, None]
    return (nll * w).sum() / w.sum().clamp(min=1.0)


class AdamW:
    """torch.optim.AdamW's update, written out."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8, state: Optional[tuple] = None):
        """``state``: (m, v, t) to start from; fresh moments by default."""
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, *betas, eps
        if state is None:
            state = ({k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()}, 0)
        self.m, self.v, self.t = state

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(params: Params, batches, cfg: dict, precision: str,
                half_batch: bool = False,
                state: Optional[tuple] = None) -> Tuple[List[float], Params, Params]:
    """Run the train steps of ``batches`` ((feats, labels, mask, valid) each)
    from ``params`` and AdamW's ``state`` (m, v, t; fresh by default), both
    updated in place. Returns each step's loss, the first step's gradients
    and the parameters after the last step.
    ``half_batch`` plants a fault: each loss is the mean over the first half
    of the rows only."""
    opt = AdamW(params, cfg["lr"], cfg["weight_decay"], state=state)
    losses, first = [], None
    for feats, labels, mask, valid in batches:
        if half_batch:
            n = feats.shape[0] // 2
            feats, labels, mask, valid = feats[:n], labels[:n], mask[:n], valid[:n]
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = masked_ce(train_logits(leaves, feats, labels, cfg, precision), labels, mask,
                         valid)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
    return losses, first, params


@torch.no_grad()
def decode_logits(params: Params, feats: torch.Tensor, tokens: torch.Tensor,
                  cfg: dict, precision: str) -> Iterator[torch.Tensor]:
    """The logits [B, V] of each decoding step t = 0 .. L-2 of a greedy decode
    that served ``tokens`` [B, L-1] (S2VTModel.py:82-110): the encoding
    stage runs word_rnn over [zeros; vid_rnn's first L outputs], step t
    feeds the embedding of tokens[:, t-1] (<sos> at t = 0) beside vid_rnn's
    output L + t."""
    B, L, E = feats.shape[0], cfg["length"], cfg["dim_embed"]
    out1 = _vid_outputs(params, feats, cfg, precision)
    word = Chain(params, "word_rnn", cfg["rnn_type"], B, precision)
    xp = word.project(torch.cat([out1.new_zeros(B, L, E), out1[:, :L]], dim=-1))
    for t in range(L):
        word.step(xp[:, t])
    emb = params["embedding.weight"]
    prev = torch.full((B,), cfg["sos_ix"], dtype=torch.long, device=feats.device)
    for t in range(L - 1):
        h = word.step(word.project(torch.cat([emb[prev], out1[:, L + t]], dim=-1)))
        yield linear(h, params["out_linear.weight"], params["out_linear.bias"], precision)
        prev = tokens[:, t].long()


@torch.no_grad()
def decode_gaps(params: Params, feats: torch.Tensor, tokens: torch.Tensor, cfg: dict,
                control: Optional[str] = None) -> float:
    """The widest gap by which a served token's float32 logit lies below the
    step's best. With ``control`` (a lower precision), the served token of
    each step is instead the one that precision puts first, fed the same
    served tokens: the control's reading."""
    ref = decode_logits(params, feats, tokens, cfg, "float32")
    low = decode_logits(params, feats, tokens, cfg, control) if control else None
    widest = 0.0
    for t, logits in enumerate(ref):
        pick = next(low).argmax(dim=-1) if low is not None else tokens[:, t].long()
        gap = logits.max(dim=-1).values - logits.gather(-1, pick[:, None]).squeeze(-1)
        widest = max(widest, float(gap.max()))
    return widest
