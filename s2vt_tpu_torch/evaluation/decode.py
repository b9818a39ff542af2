"""Inference harness: greedy caption decoding over a dataset split.

Counterpart of ``s2vt_tpu/evaluation/decode.py`` (greedy only; beam, the
scorer and the CLIs come in a later slice). The model is rebuilt from the
checkpoint's ``opt.json`` and its weights loaded from ``params.npz``
(training/checkpoint.py). Batches are fixed-shape with a ``valid`` row mask.

Every entry point takes ``device=None``, meaning the card; without a card it
raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset
from s2vt_tpu_torch.models.s2vt import S2VT
from s2vt_tpu_torch.training.checkpoint import load_checkpoint, load_config
from s2vt_tpu_torch.training.loop import build_model, pad_to_multiple
from s2vt_tpu_torch.utils.device import resolve_device
from s2vt_tpu_torch.utils.weights import params_from_jax


def ids_to_sentence(ids, ix2word: Dict[int, str], eos_ix: int,
                    sos_ix: Optional[int] = None, pad_ix: int = 0) -> str:
    """Token ids -> sentence, truncated at the first <eos> (eval.py:54-58).
    When ``sos_ix`` is given, leading <sos> tokens are stripped too."""
    words: List[str] = []
    for ix in np.asarray(ids).tolist():
        if ix == eos_ix:
            break
        if sos_ix is not None and ix == sos_ix and not words:
            continue
        if ix == pad_ix:
            continue
        words.append(ix2word.get(int(ix), "<unk>"))
    return " ".join(words)


class CaptionDecoder:
    """Batch greedy decoding of a ``VideoDataset`` split with a model that
    holds its weights."""

    def __init__(self, model: S2VT, dataset: VideoDataset, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        sp = dataset.specials
        self.eos_ix, self.sos_ix, self.pad_ix = sp["eos_ix"], sp["sos_ix"], sp["pad_ix"]

    def greedy(self, batch_size: int = 10) -> Dict[str, str]:
        """{video_id: caption} over the split (eval.py:30-60 semantics)."""
        preds: Dict[str, str] = {}
        for batch in self.dataset.batches(batch_size, shuffle=False):
            feats = torch.from_numpy(batch.feats).to(self.device)
            out = self.model.greedy(feats).cpu().numpy()
            for row, vid in enumerate(batch.ids):
                if batch.valid[row] == 0.0 or not vid:
                    continue
                preds[vid] = ids_to_sentence(out[row], self.dataset.ix2word,
                                             self.eos_ix, pad_ix=self.pad_ix)
        return preds


def model_from_checkpoint(checkpoint_path: str, real_vocab: int,
                          device=None) -> Tuple[Opt, S2VT]:
    """Rebuild (opt, model) from a checkpoint directory, weights loaded and
    the model on ``device``."""
    dev = resolve_device(device)
    cfg = load_config(checkpoint_path)
    opt = Opt(**cfg) if cfg else Opt()
    vocab = pad_to_multiple(real_vocab, opt.vocab_pad_multiple)
    model = build_model(opt, vocab, valid_vocab=real_vocab)
    model.load_state_dict(params_from_jax(load_checkpoint(checkpoint_path)))
    return opt, model.to(dev).eval()


def greedy_eval(checkpoint_path: str, captions_file: str = None, feats_path: str = None,
                batch_size: int = 10, mode: str = "test", device=None) -> Dict[str, str]:
    """The ``eval()`` entry point (eval.py:30): checkpoint -> predictions.
    Decoding runs on one device; ``opt.mesh_shape`` is not read."""
    dev = resolve_device(device)
    cfg = load_config(checkpoint_path)
    opt = Opt(**cfg) if cfg else Opt()
    ds = VideoDataset(captions_file or opt.caption_file, feats_path or opt.feats_path,
                      max_len=opt.train_length, mode=mode, seed=opt.seed)
    _, model = model_from_checkpoint(checkpoint_path, ds.vocab_size, dev)
    return CaptionDecoder(model, ds, dev).greedy(batch_size)
