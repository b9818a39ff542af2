"""Batched, fixed-shape beam search.

Counterpart of ``s2vt_tpu/models/beam.py`` (which replaces the reference's
per-sentence PriorityQueue decoder, S2VTModel.py:149-269). Beams live as a
[B, W] tensor dimension; each round expands every live beam over the
vocabulary, scores candidates by ``cum_logp / len^alpha`` (S2VTModel.py:
261-269, alpha = 0.7), masks expansion to each node's top-``expand_k`` tokens
(S2VTModel.py:216 uses top-20), freezes finished (<eos>) beams with their
score (S2VTModel.py:203-205), and stops when every beam has finished or after
``max_depth`` rounds (S2VTModel.py:186, 227).

The result equals the JAX search's exactly, not only its sentences: the loop
stops at the round where JAX's ``while_loop`` stops (positions never reached
keep ``sos_ix``), top-k is taken as k first-index argmax passes (the order and
tie-break of ``lax.top_k``), sorts are stable, and scores stay float32.

The search is generic over ``step_fn(states, last_tokens[N]) -> (new_states,
logp[N, V])``, where every state tensor has leading dim N = B*W and states
are tensors in tuples, lists and named tuples.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

NEG_INF = -1e30   # finite: dead root duplicates and masked candidates


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # [B, W, max_depth + 1] int32; position 0 is <sos>
    lengths: torch.Tensor  # [B, W] int32: node length incl. <sos> (and <eos> if hit)
    scores: torch.Tensor   # [B, W] float32 length-normalized scores, sorted desc


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` on every tensor of a tree of tuples, lists and named tuples (with
    the matching tensors of the trees ``rest``, of the same structure)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *leaves) for leaves in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    raise TypeError(f"beam states hold tensors in tuples and lists, got {type(tree)}")


def _first_leaf(tree) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


def _topk_small(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along dim 1 by k argmax passes: the same elements in the
    same order as ``lax.top_k``, ties broken toward the lower index
    (``torch.argmax`` returns the first maximum; ``torch.topk`` promises no
    order among ties).

    Precondition: every entry of ``x`` is strictly greater than -inf. Selected
    entries are masked with -inf, so the k indices are distinct; beam
    candidates satisfy this (dead slots hold the finite NEG_INF)."""
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = torch.argmax(cur, dim=1)
        vals.append(torch.gather(cur, 1, i[:, None])[:, 0])
        idxs.append(i)
        cur = torch.where(cols == i[:, None], torch.full_like(cur, -torch.inf), cur)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: argmax passes up to k = 8, else a stable descending sort
    (``lax.top_k``'s order for wide k)."""
    if k <= 8:
        return _topk_small(x, k)
    vals, idxs = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idxs[:, :k]


def _tile_states(states, width: int):
    def tile(x):
        return x[:, None].expand(x.shape[0], width, *x.shape[1:]).reshape(
            x.shape[0] * width, *x.shape[1:])
    return _tree_map(tile, states)


def _gather_states(states, parent: torch.Tensor):
    """parent: [B, W] indices into the old beam axis."""
    B, W = parent.shape

    def gather(x):
        xw = x.reshape(B, W, *x.shape[1:])
        idx = parent.reshape(B, W, *(1,) * (x.dim() - 1)).expand(B, W, *x.shape[1:])
        return torch.gather(xw, 1, idx).reshape(x.shape)
    return _tree_map(gather, states)


@torch.no_grad()
def beam_search(step_fn: Callable, init_states, *, sos_ix: int, eos_ix: int,
                vocab_size: int, beam_width: int = 3, max_depth: int = 30,
                alpha: float = 0.7, expand_k: int = 20,
                score_mode: str = "cumulative") -> BeamResult:
    """Under ``torch.export`` all ``max_depth`` rounds run with no host sync
    (a program cannot hold the stopping test); rounds after every beam has
    finished leave the carry unchanged, so the result equals the stopping
    loop's.

    score_mode:
      'cumulative' (default): candidates ranked by the accumulated sequence
        log-prob, length-normalized: sum(logp) / len^alpha.
      'reference': the reference's scoring quirk: each node is ranked by
        only the LAST step's token log-prob over len^alpha
        (S2VTModel.py:221-223 passes ``prob``, not ``n.logp + prob``).
    """
    if score_mode not in ("cumulative", "reference"):
        raise ValueError(f"score_mode must be 'cumulative' or 'reference', got {score_mode!r}")
    leaf = _first_leaf(init_states)
    B, dev = leaf.shape[0], leaf.device
    W, V = beam_width, vocab_size
    expand_k = min(expand_k, V)
    f32 = dict(dtype=torch.float32, device=dev)

    states = _tile_states(init_states, W)
    tokens = torch.full((B, W, max_depth + 1), sos_ix, dtype=torch.long, device=dev)
    # Beam 0 carries the root; its duplicates start at NEG_INF so that the
    # first expansion yields W distinct continuations of <sos>.
    cum = torch.where(torch.arange(W, device=dev) == 0, torch.zeros(W, **f32),
                      torch.full((W,), NEG_INF, **f32))[None, :].repeat(B, 1)
    length = torch.ones(B, W, dtype=torch.long, device=dev)
    finished = torch.zeros(B, W, dtype=torch.bool, device=dev)
    score = torch.zeros(B, W, **f32)
    last = torch.full((B, W), sos_ix, dtype=torch.long, device=dev)
    rank0 = (torch.arange(W, device=dev) == 0)[None, None, :]
    neg = torch.tensor(NEG_INF, **f32)

    def expand(d, states, tokens, cum, length, finished, score, last):
        """One round: every live beam over the vocabulary, the global top-W
        kept; finished beams carried unchanged."""
        new_states, logp = step_fn(states, last.reshape(B * W))
        logp = logp.reshape(B, W, V)
        # Per-node top-expand_k masking (S2VTModel.py:216). For expand_k >= W
        # it cannot change the result (the global top-W holds at most W
        # candidates of a node, and those are its top-W by logp), so it is
        # skipped, as in the JAX search.
        if expand_k < W:
            kth = torch.topk(logp, expand_k, dim=-1).values[..., -1:]
            logp = torch.where(logp >= kth, logp, neg)

        # The global top-W lies inside each node's top-W by logp, so scores
        # are formed only for these W*W survivors.
        logp_cand, tok_cand = _topk(logp.reshape(B * W, V), W)
        logp_cand = logp_cand.reshape(B, W, W)           # rank-ordered per node
        tok_cand = tok_cand.reshape(B, W, W)

        cum_cand = cum[..., None] + logp_cand            # [B, W, W]
        cand_len = (length + 1).float()[..., None]
        if score_mode == "cumulative":
            basis = cum_cand
        else:
            # dead root duplicates must stay masked under last-step scoring
            basis = torch.where(cum_cand <= NEG_INF / 2, neg, logp_cand)
        cand_score = basis / torch.pow(cand_len, alpha)

        # Finished beams persist unchanged: one frozen candidate at rank 0
        # carrying <eos> and the frozen score, the others NEG_INF.
        fin = finished[..., None]
        cand_score = torch.where(fin, torch.where(rank0, score[..., None], neg), cand_score)
        cum_cand = torch.where(fin, cum[..., None], cum_cand)
        tok_cand = torch.where(fin, torch.full_like(tok_cand, eos_ix), tok_cand)

        new_score, flat_idx = _topk(cand_score.reshape(B, W * W), W)
        parent = torch.div(flat_idx, W, rounding_mode="floor")
        token = torch.gather(tok_cand.reshape(B, W * W), 1, flat_idx)
        new_cum = torch.gather(cum_cand.reshape(B, W * W), 1, flat_idx)
        parent_fin = torch.gather(finished, 1, parent)
        parent_len = torch.gather(length, 1, parent)
        new_length = torch.where(parent_fin, parent_len, parent_len + 1)
        new_finished = parent_fin | (token == eos_ix)

        tokens = torch.gather(tokens, 1, parent[..., None].expand_as(tokens))
        tokens[:, :, d + 1] = torch.where(parent_fin, torch.full_like(token, eos_ix), token)
        return (_gather_states(new_states, parent), tokens, new_cum, new_length, new_finished,
                new_score, token)

    carry = (states, tokens, cum, length, finished, score, last)
    if torch.compiler.is_exporting():
        # Every round runs; once every beam has finished, a round keeps the
        # carry as it is, so the result is the stopping loop's.
        for d in range(max_depth):
            go = ~carry[4].all()
            new = expand(d, *carry)
            carry = _tree_map(lambda n, c: torch.where(go, n, c), new, carry)
    else:
        d = 0
        while d < max_depth and not bool(carry[4].all()):
            carry = expand(d, *carry)
            d += 1
    states, tokens, cum, length, finished, score, last = carry

    # Unfinished survivors keep their running normalized score, like the
    # reference's final nodes.get() over a queue that may hold live nodes.
    if score_mode == "cumulative":
        final_score = torch.where(
            finished, score, cum / torch.pow(length.clamp(min=1).float(), alpha))
    else:
        final_score = score
    order = torch.argsort(-final_score, dim=1, stable=True)
    return BeamResult(
        tokens=torch.gather(tokens, 1, order[..., None].expand_as(tokens)).to(torch.int32),
        lengths=torch.gather(length, 1, order).to(torch.int32),
        scores=torch.gather(final_score, 1, order),
    )
