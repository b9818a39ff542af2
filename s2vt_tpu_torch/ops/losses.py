"""Sequence losses.

Counterpart of ``s2vt_tpu/ops/losses.py``. The reference's ``MaskCriterion``
(utils.py:6-26) intends masked-mean cross-entropy but builds
``nn.CrossEntropyLoss()`` with ``reduction='mean'``, so the mask cancels and
the published model was trained with plain mean CE over every position, pads
included. Both are kept:

 - :func:`masked_cross_entropy`: the intended masked-mean CE (default).
 - :func:`reference_mean_cross_entropy`: the reference's effective loss.

Shapes follow train.py:120-122: logits [B, L-1, V] predicted from
targets[:, :-1], compared against targets[:, 1:] / mask[:, 1:]. The
log-normaliser is taken in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch


def _token_nll(logits: torch.Tensor, targets: torch.Tensor, shard=None) -> torch.Tensor:
    """Per-token negative log-likelihood. logits [..., V], targets [...].
    With a ``parallel/vocab.py::VocabShard``, ``logits`` are this rank's
    columns [..., V/tp] and the log-normaliser and the target's logit are
    taken over the model group (``parallel/vocab.py::token_nll``)."""
    if shard is not None:
        from s2vt_tpu_torch.parallel.vocab import token_nll
        return token_nll(logits, targets, shard)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return logz - gold


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Masked-mean CE. logits [B, L-1, V]; targets, mask [B, L]."""
    msk = mask[:, 1:].float()
    nll = _token_nll(logits, targets[:, 1:])
    return (nll * msk).sum() / msk.sum().clamp(min=1.0)


def reference_mean_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Plain mean CE over all positions, pads included (the mask is unused,
    as in the reference)."""
    del mask
    return _token_nll(logits, targets[:, 1:]).mean()
