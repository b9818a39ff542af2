"""Bi-LSTM encoder + additive-attention decoder baseline.

Counterpart of ``s2vt_tpu/models/attention.py``, with the same constructor,
parameter tree (encoder, decoder, feat_linear, embedding, out_linear,
att_enc, att_prev_hid, att_apply) and modes. The encoder is one
bidirectional ``TorchRNN``; with ``use_pallas`` each direction runs through
the per-layer sequence kernels (``ops/fused_rnn.py``). ``att_enc(enc_out)``
is computed once, outside the decoder loop.

Attention: Bahdanau-style additive scores ``att_apply(tanh(W_e enc + W_h
h))``. ``att_mode='softmax'`` (default) is the intended softmax over the L
encoder positions; ``'reference_sum'`` reproduces the reference's softmax
over a singleton axis, i.e. constant weights 1 (sum-pooling).

Routes of ``teacher_forced``, chosen by mode, not by failure:
 - with ``use_pallas``, ``att_mode='softmax'`` and no gradient being
   recorded (``torch.is_grad_enabled()`` false: the Trainer's validation
   pass), the decoder loop is one call of the attention-decoder kernel
   (``ops/fused_att_decode.py``) at every width: a width whose weights do
   not fit the card's shared memory takes the op's stream route;
 - otherwise the loop runs step by step in PyTorch: the kernel has no
   backward (nor has its TPU counterpart) and implements softmax only.

With its vocab split over a mesh's model axis (``vocab_shard``, set by
``parallel/vocab.py::shard_model_``), the embedding lookups, the
out-projection, the greedy pick and the beam step's logits go through the
vocab-parallel operators, as in S2VT.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from s2vt_tpu_torch.models import beam as beam_mod
from s2vt_tpu_torch.ops.fused_decode import greedy_pick
from s2vt_tpu_torch.ops.layers import TorchEmbedding, TorchLinear, apply_linear, dropout
from s2vt_tpu_torch.ops.rnn import LSTMState, TorchRNN, input_projection, multilayer_step
from s2vt_tpu_torch.parallel import vocab as vocab_par

ATT_MODES = ("softmax", "reference_sum")


class AttBaseline(nn.Module):
    """Constructor mirrors the JAX module (the reference's Att_Baseline)."""

    def __init__(self, vocab_size: int, dim_feat: int, length: int, dim_hid: int = 500,
                 dim_embed: int = 500, feat_dropout: float = 0.0, out_dropout: float = 0.0,
                 sos_ix: int = 3, eos_ix: int = 4, att_mode: str = "softmax",
                 compute_dtype: Optional[torch.dtype] = None, use_pallas: bool = False,
                 valid_vocab: Optional[int] = None):
        super().__init__()
        if att_mode not in ATT_MODES:
            raise ValueError(f"att_mode must be one of {ATT_MODES}, got {att_mode!r}")
        self.vocab_size, self.dim_feat, self.length = vocab_size, dim_feat, length
        self.dim_hid, self.dim_embed = dim_hid, dim_embed
        self.feat_dropout, self.out_dropout = feat_dropout, out_dropout
        self.sos_ix, self.eos_ix, self.att_mode = sos_ix, eos_ix, att_mode
        self.compute_dtype, self.use_pallas = compute_dtype, use_pallas
        self.valid_vocab = valid_vocab
        cdt = compute_dtype
        self.encoder = TorchRNN(dim_hid, dim_hid, bidirectional=True, compute_dtype=cdt,
                                use_pallas=use_pallas)
        self.decoder = TorchRNN(dim_hid, 2 * dim_hid + dim_embed, compute_dtype=cdt)
        self.feat_linear = TorchLinear(dim_hid, dim_feat, compute_dtype=cdt)
        self.embedding = TorchEmbedding(vocab_size, dim_embed, padding_idx=0)
        self.out_linear = TorchLinear(vocab_size, dim_hid, compute_dtype=cdt)
        self.att_enc = TorchLinear(dim_hid, 2 * dim_hid, compute_dtype=cdt)
        self.att_prev_hid = TorchLinear(dim_hid, dim_hid, compute_dtype=cdt)
        self.att_apply = TorchLinear(1, dim_hid, use_bias=False, compute_dtype=cdt)
        self.vocab_shard: Optional[vocab_par.VocabShard] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Torch's default init for every submodule, drawn from ``generator``."""
        for mod in (self.encoder, self.decoder, self.feat_linear, self.embedding,
                    self.out_linear, self.att_enc, self.att_prev_hid, self.att_apply):
            mod.reset_parameters(generator)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(*shape, dtype=torch.float32, device=self.feat_linear.weight.device)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Embeddings of global token ids (row 0, the padding, gets no
        gradient), from this rank's rows with a shard."""
        if self.vocab_shard is None:
            return self.embedding(ids)
        return vocab_par.embed(ids, self.embedding.weight, self.vocab_shard,
                               self.embedding.padding_idx)

    def _lookup(self, word: torch.Tensor) -> torch.Tensor:
        """A decode step's embeddings (no gradient)."""
        if self.vocab_shard is None:
            return self.embedding.weight[word]
        return vocab_par.embed(word, self.embedding.weight, self.vocab_shard)

    def _attention(self, enc_out, enc_wh, h):
        """context [B, 2H] from enc_out [B, L, 2H], enc_wh = att_enc(enc_out)
        [B, L, H] and the decoder's hidden state h [B, H]."""
        dec_wh = self.att_prev_hid(h)[:, None, :]                    # [B, 1, H]
        et = self.att_apply(torch.tanh(enc_wh + dec_wh))             # [B, L, 1]
        if self.att_mode == "reference_sum":
            at = torch.ones_like(et)
        else:
            at = torch.softmax(et, dim=1)
        return (at * enc_out).sum(dim=1)

    def _encode(self, feats, deterministic, generator=None):
        """(enc_out [B, L, 2H], att_enc(enc_out) [B, L, H], context0 [B, 2H]):
        the encoder's outputs and the attention at h = 0."""
        feats = self.feat_linear(dropout(feats, self.feat_dropout, generator, deterministic))
        enc_out, _ = self.encoder(feats, deterministic=deterministic, generator=generator)
        enc_wh = self.att_enc(enc_out)
        return enc_out, enc_wh, self._attention(enc_out, enc_wh, self._zeros(feats.shape[0],
                                                                              self.dim_hid))

    def _step(self, state, context, emb, enc_out, enc_wh):
        """One decoder step on [emb | context]: (state, h, new context)."""
        states, h = multilayer_step([state], torch.cat([emb, context], dim=-1),
                                    self.decoder.layers, "lstm", self.compute_dtype)
        return states[0], h, self._attention(enc_out, enc_wh, h)

    def forward(self, feats, targets=None, mode: str = "train", beam_width: int = 3,
                max_beam_depth: int = 30, deterministic: Optional[bool] = None,
                beam_score_mode: str = "cumulative",
                generator: Optional[torch.Generator] = None):
        """mode='train' -> logits [B, L-1, V] (teacher forcing);
        mode='test' -> greedy token ids [B, L]; mode='beam_search' ->
        BeamResult (tokens [B, W, D+1], lengths [B, W], scores [B, W])."""
        if deterministic is None:
            deterministic = mode != "train"
        if mode == "train":
            return self.teacher_forced(feats, targets, deterministic, generator)
        if mode == "test":
            return self.greedy(feats)
        if mode == "beam_search":
            return self.beam(feats, beam_width, max_beam_depth, score_mode=beam_score_mode)
        raise ValueError(f"unknown mode {mode!r}")

    def _kernel_route(self) -> bool:
        return self.use_pallas and self.att_mode == "softmax" and not torch.is_grad_enabled()

    def _decode_kernel(self, embed, enc_out, enc_wh, context0):
        """The decoder loop as one call of the attention-decoder kernel:
        embed [B, T, E] -> hs [B, T, H]."""
        from s2vt_tpu_torch.ops.fused_att_decode import att_decode_sequence
        dec, E = self.decoder.l0, self.dim_embed
        emb_part = {"w_ih": dec["w_ih"][:, :E], "b_ih": dec["b_ih"] + dec["b_hh"]}
        xp_t = input_projection(embed, emb_part, self.compute_dtype).transpose(0, 1)
        hs = att_decode_sequence(xp_t, dec["w_ih"][:, E:], dec["w_hh"], self.att_prev_hid.weight,
                                 self.att_prev_hid.bias, self.att_apply.weight[0], enc_wh,
                                 enc_out, context0, self.compute_dtype)
        return hs.transpose(0, 1)

    def teacher_forced(self, feats, targets, deterministic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Teacher forcing over the L-1 target steps. feats [B, L, F];
        targets [B, L-1] token ids. Returns logits [B, L-1, V]."""
        enc_out, enc_wh, context = self._encode(feats, deterministic, generator)
        embed = self._embed(targets)                                   # [B, L-1, E]
        if self._kernel_route():
            hs = self._decode_kernel(embed, enc_out, enc_wh, context)
        else:
            z = self._zeros(feats.shape[0], self.dim_hid)
            state, outs = LSTMState(z, z), []
            for t in range(embed.shape[1]):
                state, h, context = self._step(state, context, embed[:, t], enc_out, enc_wh)
                outs.append(h)
            hs = torch.stack(outs, dim=1)                              # [B, L-1, H]
        hs = dropout(hs, self.out_dropout, generator, deterministic)
        if self.vocab_shard is not None:
            hs = vocab_par.to_vocab_shards(hs, self.vocab_shard)
        return self.out_linear(hs)

    def _logits(self, h):
        """This rank's logit columns of a decode step (all of them without a
        shard), before the pad-vocab mask."""
        return apply_linear(h, self.out_linear.weight, self.out_linear.bias, self.compute_dtype)

    @torch.no_grad()
    def greedy(self, feats) -> torch.Tensor:
        """Greedy decode, L steps from <sos>. Returns token ids [B, L] (int32)."""
        enc_out, enc_wh, context = self._encode(feats, True)
        z = self._zeros(feats.shape[0], self.dim_hid)
        state = LSTMState(z, z)
        word = torch.full((feats.shape[0],), self.sos_ix, dtype=torch.long, device=feats.device)
        args = (self.out_linear.weight, self.out_linear.bias, self.valid_vocab,
                self.compute_dtype, self.use_pallas)
        pick = (greedy_pick(*args) if self.vocab_shard is None
                else vocab_par.greedy_pick(*args, self.vocab_shard))
        tokens = []
        for _ in range(self.length):
            state, h, context = self._step(state, context, self._lookup(word), enc_out, enc_wh)
            word = pick(h)                                             # first max wins
            tokens.append(word)
        return torch.stack(tokens, dim=1).to(torch.int32)

    @torch.no_grad()
    def beam(self, feats, beam_width: int = 3, max_depth: int = 30,
             length_norm_alpha: float = 0.7, expand_k: int = 20,
             score_mode: str = "cumulative") -> beam_mod.BeamResult:
        """Batched beam search over the attention decoder (the reference's
        Att_Baseline has none). The beam state is (LSTMState, context); the
        encoder tensors are tiled once, beam-minor as the states are."""
        enc_out, enc_wh, context = self._encode(feats, True)
        z = self._zeros(feats.shape[0], self.dim_hid)
        enc_out_t = enc_out.repeat_interleave(beam_width, dim=0)
        enc_wh_t = enc_wh.repeat_interleave(beam_width, dim=0)

        def step_fn(states, word):
            state, h, ctx = self._step(*states, self._lookup(word), enc_out_t, enc_wh_t)
            return (state, ctx), vocab_par.step_log_probs(h, self._logits, self.valid_vocab,
                                                          self.vocab_shard)

        return beam_mod.beam_search(
            step_fn, (LSTMState(z, z), context), sos_ix=self.sos_ix, eos_ix=self.eos_ix,
            vocab_size=self.vocab_size, beam_width=beam_width, max_depth=max_depth,
            alpha=length_norm_alpha, expand_k=expand_k, score_mode=score_mode)
