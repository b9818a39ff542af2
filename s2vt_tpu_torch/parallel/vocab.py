"""Vocab-parallel operators: what XLA inserts from the shardings in JAX.

In the JAX package a vocab-sharded embedding, out-projection and loss need
no code: XLA reads the parameters' shardings (``s2vt_tpu/parallel/mesh.py``)
and inserts the collectives itself. Here each is an explicit operator over
the model group, with its backward in a ``torch.autograd.Function``:

 - ``embed``: the lookup on a vocab shard. Rows outside the shard read as
   zeros, the forward sums the shards' outputs over the model group, and
   each shard's gradient is that of its own rows.
 - ``to_vocab_shards``: the out-projection's input. The forward is the
   identity; the backward sums dh over the model group, since each shard's
   logits give only their part of it. Without it the gradients of the
   replicated RNN weights would be one shard's.
 - ``token_nll``: cross-entropy over vocab-sharded logits: the maximum over
   the group, then the sum of exponentials, then the target's logit, which
   lives in one shard. The backward is softmax minus one-hot on each shard.
 - ``greedy_pick``: each shard picks its token with kernel #8
   (``ops/fused_decode.py::argmax_linear_value``, or its plain version on
   CPU tensors), and the ranks merge the gathered (value, global index)
   pairs with ``merge_argmax``: the first maximum of the whole vocab.
 - ``step_log_probs``: a beam step's logit shards gathered into [N, V],
   so that the beam search runs unchanged on the whole row.

Every operator is a collective: all ranks of the model group call it with
the same shapes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.nn import functional as F

from s2vt_tpu_torch.ops.layers import mask_invalid_vocab


class VocabShard(NamedTuple):
    """One model rank's part of a vocab of ``vocab`` rows: rows [offset,
    offset + rows) of the embedding, the out-projection and its bias."""
    group: object            # the model axis's ProcessGroup
    size: int                # model ranks
    rank: int                # this rank's place on the model axis
    offset: int
    rows: int
    vocab: int

    def local_valid(self, valid_vocab: Optional[int]) -> int:
        """The valid columns of this shard: clamp(valid - offset, 0, rows)."""
        valid = self.vocab if valid_vocab is None else int(valid_vocab)
        return max(0, min(valid - self.offset, self.rows))


def make_shard(mesh, vocab: int) -> Optional[VocabShard]:
    """This rank's ``VocabShard`` of a ``vocab``-row vocab on ``mesh``, or
    None where the vocab stays replicated: a model axis of 1, or a vocab the
    model size does not divide (JAX's fallback)."""
    from s2vt_tpu_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size
    tp = axis_size(mesh, MODEL_AXIS)
    if tp == 1 or vocab % tp:
        return None
    rows = vocab // tp
    r = axis_rank(mesh, MODEL_AXIS)
    return VocabShard(mesh.get_group(MODEL_AXIS), tp, r, r * rows, rows, vocab)


def _local_ids(ids: torch.Tensor, shard: VocabShard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids relative to the shard, clamped into it; whether each id is in it)."""
    local = ids.long() - shard.offset
    inside = (local >= 0) & (local < shard.rows)
    return local.clamp(0, shard.rows - 1), inside


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight, shard, padding_idx):
        local, inside = _local_ids(ids, shard)
        out = F.embedding(local, weight)
        out = torch.where(inside.unsqueeze(-1), out, torch.zeros_like(out))
        dist.all_reduce(out, group=shard.group)
        ctx.save_for_backward(local, inside)
        ctx.shard, ctx.padding_idx, ctx.weight_shape = shard, padding_idx, weight.shape
        return out

    @staticmethod
    def backward(ctx, grad_out):
        local, inside = ctx.saved_tensors
        grad = torch.zeros(ctx.weight_shape, dtype=grad_out.dtype, device=grad_out.device)
        grad.index_add_(0, local[inside], grad_out[inside])
        pad = ctx.padding_idx
        if pad is not None and 0 <= pad - ctx.shard.offset < ctx.shard.rows:
            grad[pad - ctx.shard.offset] = 0.0
        return None, grad, None, None


def embed(ids: torch.Tensor, weight: torch.Tensor, shard: VocabShard,
          padding_idx: Optional[int] = None) -> torch.Tensor:
    """The embedding of global ``ids`` from this rank's rows ``weight``
    [V/tp, E]: [..., E] on every rank of the model group. ``padding_idx``
    (a global id) gets no gradient, as in ``nn.Embedding``."""
    return _Embed.apply(ids, weight, shard, padding_idx)


class _ToVocabShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


def to_vocab_shards(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """``x``, the input of the vocab-sharded out-projection: the identity,
    whose backward sums the gradient over the model group."""
    return _ToVocabShards.apply(x, shard)


class _TokenNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, shard):
        gmax = logits.amax(dim=-1)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=shard.group)
        exp = torch.exp(logits - gmax.unsqueeze(-1))
        local, inside = _local_ids(targets, shard)
        gold = logits.gather(-1, local.unsqueeze(-1)).squeeze(-1)
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        sums = torch.stack([exp.sum(dim=-1), gold])
        dist.all_reduce(sums, group=shard.group)
        ctx.save_for_backward(exp, sums[0], local, inside)
        return gmax + torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, grad):
        exp, sumexp, local, inside = ctx.saved_tensors
        g = exp / sumexp.unsqueeze(-1)
        g.scatter_add_(-1, local.unsqueeze(-1), -inside.to(g.dtype).unsqueeze(-1))
        return g * grad.unsqueeze(-1), None, None


def token_nll(logits: torch.Tensor, targets: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """Per-token negative log-likelihood [...] of global ``targets`` under
    this rank's logit columns ``logits`` [..., V/tp] (taken in float32), the
    same on every rank of the model group: ``ops/losses.py::_token_nll`` over
    the whole vocab."""
    return _TokenNll.apply(logits.float(), targets, shard)


def merge_argmax(values: Sequence[torch.Tensor],
                 indices: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global index, value) per row from the shards' (value [B], global
    index [B]) pairs: the largest value, then the lowest index, which is the
    whole vocab's first maximum (``torch.argmax``'s and ``jnp.argmax``'s
    pick). A pure function of the gathered lists."""
    vals, idx = torch.stack(list(values)), torch.stack(list(indices)).long()
    best = vals.amax(dim=0)
    none = torch.full_like(idx, torch.iinfo(idx.dtype).max)
    cand = torch.where(vals == best.unsqueeze(0), idx, none)
    return cand.amin(dim=0), best


def _all_gather(t: torch.Tensor, shard: VocabShard) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return parts


def greedy_pick(out_w: torch.Tensor, out_b: torch.Tensor, valid_vocab: Optional[int],
                compute_dtype, use_pallas: bool, shard: VocabShard):
    """The token picker of a greedy step on vocab shards, h [B, H] -> global
    ids [B]: ``ops/fused_decode.py::greedy_pick`` with each rank's rows
    ``out_w`` [V/tp, H], ``out_b`` [V/tp]. With ``use_pallas`` each shard
    launches kernel #8 once per step (``argmax_linear_value``); otherwise
    its plain version. The gathered pairs go through ``merge_argmax``."""
    from s2vt_tpu_torch.ops.fused_decode import (argmax_linear_reference, argmax_linear_value,
                                                 pick_weight)
    bf16 = compute_dtype == torch.bfloat16
    valid = shard.local_valid(valid_vocab)
    if use_pallas:
        w = pick_weight(out_w, compute_dtype)

        def local(h):
            return argmax_linear_value(h.contiguous(), w, out_b, valid, bf16)
    else:
        def local(h):
            return argmax_linear_reference(h.contiguous(), out_w, out_b, valid, bf16,
                                           with_value=True)

    def pick(h):
        idx, val = local(h)
        idx = idx + shard.offset
        return merge_argmax(_all_gather(val, shard), _all_gather(idx, shard))[0]
    return pick


def step_log_probs(h: torch.Tensor, logits_fn, valid_vocab: Optional[int],
                   shard: Optional[VocabShard]) -> torch.Tensor:
    """A beam step's log-probabilities [N, V]: ``logits_fn(h)`` (this rank's
    columns with a shard), gathered whole, the pad vocab masked, then
    ``log_softmax`` in float32, as the replicated step computes them."""
    logits = logits_fn(h)
    if shard is not None:
        logits = torch.cat(_all_gather(logits, shard), dim=-1)
    return torch.log_softmax(mask_invalid_vocab(logits, valid_vocab).float(), dim=-1)


def shard_model_(model, mesh) -> Optional[VocabShard]:
    """Split ``model``'s vocab leaves (``embedding.weight``,
    ``out_linear.weight``, ``out_linear.bias``) over the mesh's model axis
    in place: each rank keeps its rows as the parameters, and
    ``model.vocab_shard`` records the shard (None where the vocab stays
    replicated). Call it on the whole model, before the optimizer is
    built; a model split already stays as it is. Returns the shard."""
    if getattr(model, "vocab_shard", None) is not None:
        return model.vocab_shard
    shard = make_shard(mesh, model.vocab_size)
    model.vocab_shard = shard
    if shard is None:
        return None
    lo, hi = shard.offset, shard.offset + shard.rows
    with torch.no_grad():
        for mod in (model.embedding, model.out_linear):
            for name in ("weight", "bias"):
                p = getattr(mod, name, None)
                if p is not None:
                    setattr(mod, name, torch.nn.Parameter(p[lo:hi].clone()))
    return shard

