"""Model factory of the training harness.

Counterpart of ``build_model`` in ``s2vt_tpu/training/loop.py``; the
trainer itself comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.models.s2vt import S2VT


def build_model(opt: Opt, vocab_size: int, valid_vocab: Optional[int] = None) -> S2VT:
    """Model factory dispatching on opt.model.

    ``vocab_size`` may be padded up (Opt.vocab_pad_multiple); pass the real
    corpus vocab as ``valid_vocab`` so decode masks the padding rows."""
    cdt = torch.bfloat16 if opt.compute_dtype == "bfloat16" else None
    if opt.model == "s2vt":
        return S2VT(vocab_size=vocab_size, feat_dim=opt.feat_dim,
                    length=opt.train_length, dim_hid=opt.dim_hidden,
                    dim_embed=opt.dim_embed, feat_dropout=opt.feat_dropout,
                    rnn_dropout=opt.rnn_dropout, out_dropout=opt.out_dropout,
                    num_layers=opt.num_layers, bidirectional=opt.bidirectional,
                    rnn_type=opt.rnn_type, sos_ix=opt.sos_ix, eos_ix=opt.eos_ix,
                    compute_dtype=cdt, use_pallas=opt.use_pallas,
                    valid_vocab=valid_vocab)
    if opt.model == "att_baseline":
        raise NotImplementedError(
            "the attention baseline is not ported yet (ROADMAP.md queue 1, "
            "attention baseline)")
    raise ValueError(f"unknown model {opt.model!r}")
