"""Inference harness: greedy and beam caption decoding over a dataset split.

Counterpart of ``s2vt_tpu/evaluation/decode.py`` (the reference's ``eval()``
and ``beam_eval()``, eval.py:30-99; the scorer and the CLIs come in a later
slice). The model is rebuilt from the checkpoint's ``opt.json`` and its
weights loaded from ``params.npz`` (training/checkpoint.py). Batches are
fixed-shape with a ``valid`` row mask. Decoding runs on one device.

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
    """Batch decoding of a ``VideoDataset`` split with a model that holds its
    weights: greedy, or beam search with the given width, depth and score
    mode."""

    def __init__(self, model: S2VT, dataset: VideoDataset, device=None, beam_width: int = 3,
                 max_beam_depth: int = 30, beam_score_mode: str = "cumulative"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        sp = dataset.specials
        self.eos_ix, self.sos_ix, self.pad_ix = sp["eos_ix"], sp["sos_ix"], sp["pad_ix"]
        self.beam_width, self.max_beam_depth = beam_width, max_beam_depth
        self.beam_score_mode = beam_score_mode

    def _run(self, batch_size: int, decode, sos_ix: Optional[int] = None) -> Dict[str, str]:
        """{video_id: sentence} over the split; ``decode`` maps a batch of
        features to token rows [B, n], cut at the first <eos> (and stripped of
        leading ``sos_ix`` tokens when it is given)."""
        preds: Dict[str, str] = {}
        for batch in self.dataset.batches(batch_size, shuffle=False):
            out = decode(torch.from_numpy(batch.feats).to(self.device)).cpu().numpy()
            for row, vid in enumerate(batch.ids):
                if batch.valid[row] == 0.0 or not vid:
                    continue
                preds[vid] = ids_to_sentence(out[row], self.dataset.ix2word, self.eos_ix,
                                             sos_ix=sos_ix, pad_ix=self.pad_ix)
        return preds

    def greedy(self, batch_size: int = 10) -> Dict[str, str]:
        """{video_id: caption} over the split (eval.py:30-60 semantics)."""
        return self._run(batch_size, self.model.greedy)

    def beam(self, batch_size: int = 10) -> Dict[str, str]:
        """Best-beam captions (eval.py:63-99 semantics: strip <sos>/<eos>)."""
        def best_beam(feats):
            # tokens [B, W, D+1] sorted by score, best first: beam 0 without
            # its <sos> history slot.
            return self.model.beam(feats, self.beam_width, self.max_beam_depth,
                                   score_mode=self.beam_score_mode).tokens[:, 0, 1:]
        return self._run(batch_size, best_beam, self.sos_ix)


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


def _decoder_from_checkpoint(checkpoint_path: str, captions_file: Optional[str],
                             feats_path: Optional[str], mode: str = "test", device=None,
                             **kw) -> CaptionDecoder:
    """The checkpoint's model and its ``mode`` split in a decoder on
    ``device``; beam settings from ``kw``, else from the checkpoint's opt.
    ``opt.mesh_shape`` is not read: decoding runs on one device."""
    dev = resolve_device(device)
    cfg = load_config(checkpoint_path)
    opt = Opt(**cfg) if cfg else Opt()
    ds = VideoDataset(captions_file or opt.caption_file, feats_path or opt.feats_path,
                      max_len=opt.train_length, mode=mode, seed=opt.seed)
    opt, model = model_from_checkpoint(checkpoint_path, ds.vocab_size, dev)
    return CaptionDecoder(model, ds, dev,
                          beam_width=kw.get("beam_width", opt.beam_width),
                          max_beam_depth=kw.get("max_beam_depth", opt.max_beam_depth),
                          beam_score_mode=kw.get("beam_score_mode", opt.beam_score_mode))


def greedy_eval(checkpoint_path: str, captions_file: str = None, feats_path: str = None,
                batch_size: int = 10, mode: str = "test", device=None) -> Dict[str, str]:
    """The ``eval()`` entry point (eval.py:30): checkpoint -> predictions."""
    dec = _decoder_from_checkpoint(checkpoint_path, captions_file, feats_path, mode, device)
    return dec.greedy(batch_size)


def beam_eval(checkpoint_path: str, captions_file: str = None, feats_path: str = None,
              batch_size: int = 10, beam_width: int = 3, max_beam_depth: int = 30,
              mode: str = "test", beam_score_mode: str = "cumulative",
              device=None) -> Dict[str, str]:
    """The ``beam_eval()`` entry point (eval.py:63): checkpoint -> best-beam
    predictions."""
    dec = _decoder_from_checkpoint(checkpoint_path, captions_file, feats_path, mode, device,
                                   beam_width=beam_width, max_beam_depth=max_beam_depth,
                                   beam_score_mode=beam_score_mode)
    return dec.beam(batch_size)
