"""A seeded MSVD-format corpus: ``captions.json`` and one ``feats/<clip>.npy``
per clip, in the layout the reference's prepare_captions.py writes and the
program's ``VideoDataset`` reads.

A frozen copy, grown to MSVD's scale, of ``make_synthetic_corpus`` in
``s2vt_tpu_torch/data/dataset.py``: the vocabulary is given whole
(``<pad>``, ``<unk>``, ``<sos>``, ``<eos>``, then ``w0`` ...), so that it has
exactly the configuration's size; captions are ``<sos>`` w ... ``<eos>``
with MSVD's lengths (a few to about 25 words) and words drawn by a Zipf
law, a few captions per clip; features are [L, F] rows of ReLU(N(0, 1)),
as vgg16_bn's fc7 activations are non-negative. They are stored as
float16 to halve what a run writes, and read back as float32.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List

import numpy as np
import torch

SPECIALS = ("<pad>", "<unk>", "<sos>", "<eos>")
PAD_IX, UNK_IX, SOS_IX, EOS_IX = range(4)


def vocabulary(vocab_size: int) -> List[str]:
    """Word i of the corpus' vocabulary."""
    return list(SPECIALS) + [f"w{i}" for i in range(vocab_size - len(SPECIALS))]


def clip_names(n: int, prefix: str) -> List[str]:
    return [f"{prefix}{i:05d}" for i in range(n)]


def captions_for(rng: np.random.Generator, vocab_size: int, n_clips: int,
                 traffic: dict) -> List[List[List[int]]]:
    """Per clip, ``captions_per_clip`` drawn captions as token ids with their
    <sos> and <eos>: lengths uniform in [min_words, max_words], word ranks
    from a Zipf law of exponent ``zipf_a`` over the non-special words."""
    lo, hi = traffic["min_words"], traffic["max_words"]
    n_words = vocab_size - len(SPECIALS)
    out = []
    for _ in range(n_clips):
        caps = []
        for _ in range(traffic["captions_per_clip"]):
            n = int(rng.integers(lo, hi + 1))
            ranks = (rng.zipf(traffic["zipf_a"], size=n) - 1) % n_words
            caps.append([SOS_IX] + [len(SPECIALS) + int(r) for r in ranks] + [EOS_IX])
        out.append(caps)
    return out


def clip_features(gen: torch.Generator, n: int, length: int, feat_dim: int,
                  device) -> torch.Tensor:
    """[n, L, F] float16 ReLU(N(0, 1)) features from ``gen``, made on ``device``
    in one call."""
    x = torch.randn(n, length, feat_dim, generator=gen, device=device)
    return x.clamp_(min=0).to(torch.float16)


def write_corpus(root: str, cfg: dict, traffic: dict, seed_words: int,
                 gen: torch.Generator, device) -> Dict[str, object]:
    """Write ``captions.json`` and ``feats/*.npy`` under ``root``: the train
    split of ``cfg['train_clips']`` clips and a valid split of
    ``traffic['valid_clips']``. Returns the paths and, per train clip,
    its captions (the benchmark's own copy, which judges the program's
    feed)."""
    root_p = pathlib.Path(root)
    feat_dir = root_p / "feats"
    feat_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed_words)
    V, L, F = cfg["vocab_size"], cfg["length"], cfg["feat_dim"]
    n_train, n_valid = cfg["train_clips"], traffic["valid_clips"]
    splits = {"train": clip_names(n_train, "tr"), "valid": clip_names(n_valid, "va"),
              "test": []}
    names = splits["train"] + splits["valid"]
    caps = captions_for(rng, V, len(names), traffic)
    feats = clip_features(gen, len(names), L, F, device).cpu().numpy()
    for name, row in zip(names, feats):
        np.save(feat_dir / f"{name}.npy", row)
    words = vocabulary(V)
    captions = dict(zip(names, caps))
    with open(root_p / "captions.json", "w", encoding="utf-8") as f:
        json.dump({"word2ix": {w: i for i, w in enumerate(words)},
                   "ix2word": {i: w for i, w in enumerate(words)},
                   "captions": captions, "splits": splits}, f)
    return {"captions_file": str(root_p / "captions.json"), "feats_path": str(feat_dir),
            "captions": captions}


def encode(tokens: List[int], length: int):
    """(label [L] int64, mask [L] float32) of one caption: the tokens cut to
    L and zero-padded, the mask 1 over them (train.py's collate)."""
    tokens = tokens[:length]
    label = np.zeros(length, np.int64)
    label[:len(tokens)] = tokens
    mask = np.zeros(length, np.float32)
    mask[:len(tokens)] = 1.0
    return label, mask
