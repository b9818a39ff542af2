"""Inference harness: greedy and beam caption decoding over a dataset split.

Counterpart of ``s2vt_tpu/evaluation/decode.py`` (the reference's ``eval()``
and ``beam_eval()``, eval.py:30-99; scoring is ``evaluation/scorer.py``, the
command line ``cli/eval.py``). The model is rebuilt from the checkpoint's
``opt.json`` and its weights loaded from ``params.npz``
(training/checkpoint.py). Batches are fixed-shape with a ``valid`` row mask.
Decoding runs on one device, or with a mesh (``parallel/mesh.py``) split over
the ranks: each batch's rows over the data axis, the vocab over the model
axis (``parallel/vocab.py``), the captions gathered on every rank.

Every entry point takes ``device=None``, meaning the card; without a card it
raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.corpus import ids_to_sentence  # noqa: F401  (re-exported)
from s2vt_tpu_torch.data.dataset import VideoDataset
from s2vt_tpu_torch.training.checkpoint import load_checkpoint, load_config
from s2vt_tpu_torch.parallel import mesh as mesh_lib
from s2vt_tpu_torch.parallel.vocab import shard_model_
from s2vt_tpu_torch.training.loop import Model, build_model
from s2vt_tpu_torch.utils.device import resolve_device
from s2vt_tpu_torch.utils.weights import params_from_jax


class CaptionDecoder:
    """Batch decoding of a ``VideoDataset`` split with a model that holds its
    weights (S2VT or the attention baseline): greedy, or beam search with the
    given width, depth and score mode.

    ``feature_bank``: an optional [N, L, D] tensor on ``device``, row i the
    features of ``dataset.feat_paths[i]`` (the Trainer's bank). With it,
    batches read no features from disk; each batch's rows are gathered on
    the device by ``Batch.rows``, so repeated decodes (the Trainer's metric
    eval) do not stream the split again.

    ``mesh``: a (data, model) ``DeviceMesh``. Each batch's rows are split
    over the data ranks (ceil(B / dp) each, the last ranks fewer), a
    whole model's vocab leaves over the model ranks (a model the Trainer
    split already stays as it is), and every rank returns all captions."""

    def __init__(self, model: Model, dataset: VideoDataset, device=None, beam_width: int = 3,
                 max_beam_depth: int = 30, beam_score_mode: str = "cumulative",
                 feature_bank: Optional[torch.Tensor] = None, mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            shard_model_(self.model, mesh)
        self.dataset = dataset
        self.bank = feature_bank
        sp = dataset.specials
        self.eos_ix, self.sos_ix, self.pad_ix = sp["eos_ix"], sp["sos_ix"], sp["pad_ix"]
        self.beam_width, self.max_beam_depth = beam_width, max_beam_depth
        self.beam_score_mode = beam_score_mode

    def _run(self, batch_size: int, decode, sos_ix: Optional[int] = None) -> Dict[str, str]:
        """{video_id: sentence} over the split; ``decode`` maps a batch of
        features to token rows [B, n], cut at the first <eos> (and stripped of
        leading ``sos_ix`` tokens when it is given)."""
        preds: Dict[str, str] = {}
        lo, hi = ((0, batch_size) if self.mesh is None
                  else mesh_lib.batch_rows(batch_size, self.mesh, even=False))
        rows = None if self.mesh is None else (lo, hi)
        for batch in self.dataset.batches(batch_size, shuffle=False,
                                          include_feats=self.bank is None, feat_rows=rows):
            if self.bank is not None:
                idx = torch.from_numpy(batch.rows[lo:hi]).to(self.device, torch.long)
                feats = self.bank[idx]
            else:
                feats = torch.from_numpy(batch.feats).to(self.device)
            if lo == hi:        # no rows here (nor on this rank's model group)
                continue
            out = decode(feats).cpu().numpy()
            for row, vid in enumerate(batch.ids[lo:hi]):
                if batch.valid[lo + row] == 0.0 or not vid:
                    continue
                preds[vid] = ids_to_sentence(out[row], self.dataset.ix2word, self.eos_ix,
                                             sos_ix=sos_ix, pad_ix=self.pad_ix)
        if self.mesh is not None:
            parts = [None] * mesh_lib.axis_size(self.mesh, mesh_lib.DATA_AXIS)
            dist.all_gather_object(parts, preds,
                                   group=self.mesh.get_group(mesh_lib.DATA_AXIS))
            preds = {vid: sent for part in parts for vid, sent in part.items()}
        return preds

    def greedy(self, batch_size: int = 10) -> Dict[str, str]:
        """{video_id: caption} over the split (eval.py:30-60 semantics). S2VT
        rows are L-1 tokens wide, attention-baseline rows L; both are cut at
        the first <eos>."""
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
                          device=None) -> Tuple[Opt, Model]:
    """Rebuild (opt, model) from a checkpoint directory, weights loaded and
    the model on ``device``. The checkpoint holds whole tensors whatever
    mesh trained it, so the model is whole."""
    dev = resolve_device(device)
    cfg = load_config(checkpoint_path)
    opt = Opt(**cfg) if cfg else Opt()
    vocab = mesh_lib.pad_to_multiple(real_vocab, opt.vocab_pad_multiple)
    model = build_model(opt, vocab, valid_vocab=real_vocab)
    model.load_state_dict(params_from_jax(load_checkpoint(checkpoint_path)))
    return opt, model.to(dev).eval()


def _decoder_from_checkpoint(checkpoint_path: str, captions_file: Optional[str],
                             feats_path: Optional[str], mode: str = "test", device=None,
                             **kw) -> CaptionDecoder:
    """The checkpoint's model and its ``mode`` split in a decoder on
    ``device``; beam settings from ``kw``, else from the checkpoint's opt.
    An ``opt.mesh_shape`` other than (1, 1) builds that mesh, as JAX's
    does (``make_mesh`` raises where the world size does not fit)."""
    dev = resolve_device(device)
    cfg = load_config(checkpoint_path)
    opt = Opt(**cfg) if cfg else Opt()
    ds = VideoDataset(captions_file or opt.caption_file, feats_path or opt.feats_path,
                      max_len=opt.train_length, mode=mode, seed=opt.seed)
    opt, model = model_from_checkpoint(checkpoint_path, ds.vocab_size, dev)
    mesh = None
    if tuple(opt.mesh_shape) != (1, 1):
        mesh = mesh_lib.make_mesh(tuple(opt.mesh_shape), dev)
    return CaptionDecoder(model, ds, dev,
                          beam_width=kw.get("beam_width", opt.beam_width),
                          max_beam_depth=kw.get("max_beam_depth", opt.max_beam_depth),
                          beam_score_mode=kw.get("beam_score_mode", opt.beam_score_mode),
                          mesh=mesh)


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
