"""S2VT: two-LSTM encode-then-decode video captioner.

Counterpart of ``s2vt_tpu/models/s2vt.py``, with the same constructor and
parameter tree (vid_rnn, word_rnn, feat_linear, out_linear, embedding).

Stage layout (reference S2VTModel.py:63-81): video features are projected to
dim_hid, padded with L-1 zero steps, and run through ``vid_rnn`` for 2L-1
steps. ``word_rnn`` sees [zero embedding; vid_out] for the first L
(encoding) steps and [token embedding; vid_out] for the last L-1 (decoding)
steps; only the decoding-stage outputs are projected to the vocabulary.

With ``use_pallas`` on and ``fused_shapes_ok``, both LSTM chains run in one
launch of the fused kernel (``ops/fused_s2vt.py``), and a training step's
backward in one launch of the fused backward kernel. Where the fused kernels
do not apply (``num_layers > 1``, ``rnn_type='gru'``, and the beam encode
over the raw L steps), ``vid_rnn`` and ``word_rnn`` run each layer through
the per-layer sequence kernels (``ops/fused_rnn.py`` for an LSTM,
``ops/fused_gru.py`` for a GRU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from s2vt_tpu_torch.models import beam as beam_mod
from s2vt_tpu_torch.ops.fused_decode import greedy_pick
from s2vt_tpu_torch.ops.layers import (TorchEmbedding, TorchLinear, apply_linear,
                                       dropout, mask_invalid_vocab)
from s2vt_tpu_torch.ops.rnn import LSTMState, TorchRNN, input_projection, multilayer_step


class S2VT(nn.Module):
    """Reference-compatible constructor signature (S2VTModel.py:11-12)."""

    def __init__(self, vocab_size: int, feat_dim: int, length: int, dim_hid: int = 500,
                 dim_embed: int = 500, feat_dropout: float = 0.0, rnn_dropout: float = 0.0,
                 out_dropout: float = 0.0, num_layers: int = 1, bidirectional: bool = False,
                 rnn_type: str = "lstm", sos_ix: int = 3, eos_ix: int = 4,
                 compute_dtype: Optional[torch.dtype] = None, use_pallas: bool = False,
                 valid_vocab: Optional[int] = None):
        super().__init__()
        if bidirectional:
            raise ValueError("bidirectional S2VT is unsupported (as in the reference)")
        self.vocab_size, self.feat_dim, self.length = vocab_size, feat_dim, length
        self.dim_hid, self.dim_embed = dim_hid, dim_embed
        self.feat_dropout, self.rnn_dropout, self.out_dropout = (
            feat_dropout, rnn_dropout, out_dropout)
        self.num_layers, self.rnn_type = num_layers, rnn_type
        self.sos_ix, self.eos_ix = sos_ix, eos_ix
        self.compute_dtype, self.use_pallas = compute_dtype, use_pallas
        self.valid_vocab = valid_vocab  # real vocab size when vocab_size is
        #   padded (Opt.vocab_pad_multiple); decode masks the padding rows
        rnn_kw = dict(num_layers=num_layers, rnn_type=rnn_type, dropout=rnn_dropout,
                      compute_dtype=compute_dtype, use_pallas=use_pallas)
        self.vid_rnn = TorchRNN(dim_hid, dim_hid, **rnn_kw)
        self.word_rnn = TorchRNN(dim_hid, dim_hid + dim_embed, **rnn_kw)
        self.feat_linear = TorchLinear(dim_hid, feat_dim, compute_dtype=compute_dtype)
        self.out_linear = TorchLinear(vocab_size, dim_hid, compute_dtype=compute_dtype)
        self.embedding = TorchEmbedding(vocab_size, dim_embed)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Torch's default init for every submodule, drawn from ``generator``."""
        for mod in (self.vid_rnn, self.word_rnn, self.feat_linear, self.out_linear,
                    self.embedding):
            mod.reset_parameters(generator)

    # ------------------------------------------------------------------
    # shared encode
    # ------------------------------------------------------------------

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(*shape, dtype=torch.float32, device=self.feat_linear.weight.device)

    def _project_feats(self, feats, deterministic, generator=None):
        """feat_drop -> feat_linear (S2VTModel.py:52-54)."""
        return self.feat_linear(dropout(feats, self.feat_dropout, generator, deterministic))

    def _vid_pass(self, feats, deterministic, generator=None):
        """vid_rnn over [feats; zeros(L-1)] — 2L-1 steps (S2VTModel.py:64-67)."""
        pad = self._zeros(feats.shape[0], self.length - 1, self.dim_hid)
        output1, _ = self.vid_rnn(torch.cat([feats, pad], dim=1), deterministic=deterministic,
                                  generator=generator)
        return output1

    def _fused_ok(self) -> bool:
        from s2vt_tpu_torch.ops.fused_s2vt import fused_shapes_ok
        return self.use_pallas and fused_shapes_ok(
            self.dim_hid, self.num_layers, self.rnn_type, self.feat_linear.weight.device)

    def _fused_bf16(self) -> bool:
        return self.compute_dtype == torch.bfloat16

    def _fused_inputs(self, feats_proj, pad_embed):
        """The fused kernel's pre-projected time-major inputs and weights:
        x1 carries vid b_hh, x2 carries word b_ih + b_hh, and w2v is the
        word W_ih block that reads vid_rnn's output."""
        B = feats_proj.shape[0]
        vid_p, word_p = self.vid_rnn.l0, self.word_rnn.l0
        pad = self._zeros(B, self.length - 1, self.dim_hid)
        pad_feats = torch.cat([feats_proj, pad], dim=1)               # [B, T, H]
        x1 = input_projection(pad_feats, vid_p, self.compute_dtype)
        x1 = x1 + vid_p["b_hh"].float()
        E = self.dim_embed
        w2e = {"w_ih": word_p["w_ih"][:, :E], "b_ih": word_p["b_ih"] + word_p["b_hh"]}
        x2 = input_projection(pad_embed, w2e, self.compute_dtype)
        w2v = word_p["w_ih"][:, E:]
        return x1.transpose(0, 1), x2.transpose(0, 1), vid_p["w_hh"], w2v, word_p["w_hh"]

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------

    def forward(self, feats, targets=None, mode: str = "train", beam_width: int = 3,
                max_beam_depth: int = 30, deterministic: Optional[bool] = None,
                beam_score_mode: str = "cumulative", early_stop: bool = False,
                generator: Optional[torch.Generator] = None):
        """Dispatch like the reference forward (S2VTModel.py:39-61).

        mode='train' -> logits [B, L-1, V] (teacher forcing)
        mode='test'  -> greedy token ids [B, L-1]; early_stop=True exits
            when every row has emitted <eos>
        mode='beam_search' -> BeamResult (tokens [B, W, D+1], lengths [B, W],
            scores [B, W])
        """
        if deterministic is None:
            deterministic = mode != "train"
        if mode == "train":
            return self.teacher_forced(feats, targets, deterministic, generator)
        if mode == "test":
            return self.greedy(feats, early_stop=early_stop)
        if mode == "beam_search":
            return self.beam(feats, beam_width, max_beam_depth, score_mode=beam_score_mode)
        raise ValueError(f"unknown mode {mode!r}")

    def teacher_forced(self, feats, targets, deterministic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Training pass (S2VTModel.py:69-81): one scan per RNN, or with
        ``use_pallas`` both layers in the fused kernels, forward and backward.

        feats: [B, L, feat_dim]; targets: [B, L-1] token ids.
        Returns logits [B, L-1, vocab].
        """
        B = feats.shape[0]
        feats = self._project_feats(feats, deterministic, generator)
        embed = self.embedding(targets)                               # [B, L-1, E]
        pad_embed = torch.cat([self._zeros(B, self.length, self.dim_embed), embed], dim=1)
        if self._fused_ok():
            from s2vt_tpu_torch.ops.fused_s2vt import s2vt_fused_out2
            x1t, x2t, w1hh, w2v, w2hh = self._fused_inputs(feats, pad_embed)
            out2 = s2vt_fused_out2(x1t, x2t, w1hh, w2v, w2hh, self._fused_bf16())
            result = out2.transpose(0, 1)[:, self.length:, :]
        else:
            output1 = self._vid_pass(feats, deterministic, generator)  # [B, 2L-1, H]
            input2 = torch.cat([pad_embed, output1], dim=-1)          # [B, 2L-1, E+H]
            output2, _ = self.word_rnn(input2, deterministic=deterministic,
                                       generator=generator)
            result = output2[:, self.length:, :]                      # [B, L-1, H]
        result = dropout(result, self.out_dropout, generator, deterministic)
        return self.out_linear(result)

    @torch.no_grad()
    def greedy(self, feats, early_stop: bool = False) -> torch.Tensor:
        """Greedy decode (vs S2VTModel.py:82-110). Returns token ids [B, L-1]
        (int32).

        Encoding stage: word_rnn over [zeros; output1[:, :L]] yields state2.
        Decoding stage: L-1 steps; step t consumes output1[:, L+t] and the
        embedding of the previous argmax (sos at t=0).

        ``early_stop=True`` stops once every row has emitted ``<eos>`` and
        fills the remaining positions with ``<eos>``; the sentences, cut at
        the first ``<eos>``, are the same.
        """
        B = feats.shape[0]
        feats = self._project_feats(feats, True)
        if self._fused_ok():
            from s2vt_tpu_torch.ops.fused_s2vt import s2vt_fused_infer
            T = 2 * self.length - 1
            pad_embed = self._zeros(B, T, self.dim_embed)
            x1t, x2t, w1hh, w2v, w2hh = self._fused_inputs(feats, pad_embed)
            out1, _, _, _, (h2s, c2s) = s2vt_fused_infer(
                x1t, x2t, w1hh, w2v, w2hh, snap_idx=self.length - 1,
                compute_bf16=self._fused_bf16())
            output1 = out1.transpose(0, 1)                            # [B, T, H]
            states2 = [LSTMState(h2s, c2s)]
        else:
            output1 = self._vid_pass(feats, True)                     # [B, 2L-1, H]
            enc_pad = self._zeros(B, self.length, self.dim_embed)
            input2 = torch.cat([enc_pad, output1[:, :self.length, :]], dim=-1)
            _, states2 = self.word_rnn(input2, deterministic=True)

        emb_table = self.embedding.weight
        word_layers = self.word_rnn.layers
        out_w, out_b = self.out_linear.weight, self.out_linear.bias
        vid_tail = output1[:, self.length:, :].transpose(0, 1)        # [L-1, B, H]

        pick = greedy_pick(out_w, out_b, self.valid_vocab, self.compute_dtype,
                           self.use_pallas)

        def decode_one(states, word, vid_out_t):
            x = torch.cat([emb_table[word], vid_out_t], dim=-1)       # [B, E+H]
            states, h = multilayer_step(states, x, word_layers, self.rnn_type,
                                        self.compute_dtype)
            return states, pick(h)

        n_steps = self.length - 1
        states = states2
        word = torch.full((B,), self.sos_ix, dtype=torch.long, device=feats.device)
        tokens = torch.full((n_steps, B), self.eos_ix, dtype=torch.long, device=feats.device)
        done = torch.zeros(B, dtype=torch.bool, device=feats.device)
        for t in range(n_steps):
            if early_stop and bool(done.all()):
                break
            states, word = decode_one(states, word, vid_tail[t])
            if early_stop:
                tokens[t] = torch.where(done, torch.full_like(word, self.eos_ix), word)
                done = done | (word == self.eos_ix)
            else:
                tokens[t] = word
        return tokens.transpose(0, 1).to(torch.int32)                 # [B, L-1]

    @torch.no_grad()
    def encode_for_beam(self, feats):
        """Beam-mode encoding (S2VTModel.py:56-60): vid_rnn over the RAW L
        steps (no zero padding, unlike train and greedy), then word_rnn over
        [zeros; output1] for its encoding state. Returns (states1, states2),
        one LSTMState per layer each."""
        B = feats.shape[0]
        feats = self._project_feats(feats, True)
        output1, states1 = self.vid_rnn(feats, deterministic=True)
        input2 = torch.cat([self._zeros(B, self.length, self.dim_embed), output1], dim=-1)
        _, states2 = self.word_rnn(input2, deterministic=True)
        return states1, states2

    @torch.no_grad()
    def beam(self, feats, beam_width: int = 3, max_depth: int = 30,
             length_norm_alpha: float = 0.7, expand_k: int = 20,
             score_mode: str = "cumulative") -> beam_mod.BeamResult:
        """Batched fixed-shape beam search (vs S2VTModel.py:149-269)."""
        states1, states2 = self.encode_for_beam(feats)
        emb_table = self.embedding.weight
        vid_layers, word_layers = self.vid_rnn.layers, self.word_rnn.layers
        out_w, out_b = self.out_linear.weight, self.out_linear.bias

        def step_fn(states, word):
            """(states1, states2), word ids [N] -> new states, log-probs [N, V].
            Each step continues vid_rnn with a zero input (S2VTModel.py:208-210)
            and feeds [embed(word); vid_out] to word_rnn."""
            st1, st2 = states
            st1, vid_out = multilayer_step(st1, self._zeros(word.shape[0], self.dim_hid),
                                           vid_layers, self.rnn_type, self.compute_dtype)
            x = torch.cat([emb_table[word], vid_out], dim=-1)
            st2, h = multilayer_step(st2, x, word_layers, self.rnn_type, self.compute_dtype)
            logits = apply_linear(h, out_w, out_b, self.compute_dtype)
            logits = mask_invalid_vocab(logits, self.valid_vocab)
            return (st1, st2), torch.log_softmax(logits.float(), dim=-1)

        return beam_mod.beam_search(
            step_fn, (states1, states2), sos_ix=self.sos_ix, eos_ix=self.eos_ix,
            vocab_size=self.vocab_size, beam_width=beam_width, max_depth=max_depth,
            alpha=length_norm_alpha, expand_k=expand_k, score_mode=score_mode)
