"""Learnable synthetic corpus: a generative rule a model must generalize.

Counterpart of ``s2vt_tpu/data/learnable.py``; numpy only. For one seed and
shape it writes the same ``captions.json``, ``gts.json`` and ``feats/*.npy``
as the JAX package.

 - A catalog of atoms (subjects, verbs, objects), each with a fixed random
   pattern vector in its own third of the feature dimensions.
 - Each clip's latent state is a distinct (subject, verb, object) triple;
   every frame carries the three patterns plus per-frame Gaussian noise.
 - Captions are 2-4 templated realizations of the triple ("a {s} is {v} a
   {o}", ...), several references per clip as in MSVD.
 - The valid and test splits hold unseen triples whose atoms all appear in
   training, so only a model that learned the feature -> word mapping scores
   well there (near the METEOR ceiling of identical 7-word sentences, ~0.59);
   one that memorized the training clips scores ~0.

The artifacts use the schema of ``data/corpus.py`` (captions.json + gts.json
+ feats/*.npy), so ``VideoDataset``, the Trainer and the metric eval read
them unchanged. The default is MSVD-shaped (1400/450/120 clips of [80, 4096]
float32, vocab ~1k); tests use small shapes.
"""

from __future__ import annotations

import json
import pathlib
from collections import Counter
from typing import Dict

import numpy as np

from s2vt_tpu_torch.data.corpus import build_vocab, tokenize_caption

TEMPLATES = (
    "a {s} is {v} a {o}",
    "the {s} is {v} the {o}",
    "{s} {v} {o}",
    "a {s} {v} the {o}",
)


def _fresh_triple_error(what: str) -> RuntimeError:
    return RuntimeError(f"could not draw a fresh (s,v,o) triple for {what} in 1000 tries; "
                        f"enlarge the atom catalogs")


def make_learnable_corpus(root: str, n_train: int = 1400, n_valid: int = 450,
                          n_test: int = 120, n_subjects: int = 440,
                          n_verbs: int = 280, n_objects: int = 280,
                          feat_len: int = 80, feat_dim: int = 4096,
                          noise: float = 0.1, seed: int = 0,
                          pattern_scale: float = 1.0,
                          max_captions_per_clip: int = 4) -> Dict[str, str]:
    """Build the corpus under ``root``; returns paths and metadata.

    Every atom occurs in at least one train clip (train clips take each
    catalog round-robin before random draws), and all clips carry distinct
    triples, so every valid/test triple is an unseen combination of seen
    atoms."""
    n_total = n_train + n_valid + n_test
    if n_subjects * n_verbs * n_objects < n_total * 2:
        raise ValueError("catalog too small for distinct triples")
    if n_train < max(n_subjects, n_verbs, n_objects):
        raise ValueError("n_train must cover every atom at least once")

    rng = np.random.default_rng(seed)
    subjects = [f"subj{i}" for i in range(n_subjects)]
    verbs = [f"verb{i}" for i in range(n_verbs)]
    objects = [f"obj{i}" for i in range(n_objects)]

    # Each role's patterns live in its own third of the feature dims; rows of
    # N(0, 1) / sqrt(d) are near-orthogonal, so a linear readout separates
    # them once the noise and the subspaces are learned.
    d1, d2 = feat_dim // 3, 2 * feat_dim // 3
    dims = {"s": (0, d1), "v": (d1, d2), "o": (d2, feat_dim)}
    pat = {}
    for role, n_atoms in (("s", n_subjects), ("v", n_verbs), ("o", n_objects)):
        lo, hi = dims[role]
        scale = pattern_scale / np.sqrt(hi - lo)
        pat[role] = rng.normal(size=(n_atoms, hi - lo)).astype(np.float32) * scale

    # Distinct triples; train covers each catalog round-robin first.
    seen = set()
    triples = []
    for i in range(n_train):
        for _ in range(1000):
            t = (i % n_subjects if i < n_subjects else rng.integers(n_subjects),
                 i % n_verbs if i < n_verbs else rng.integers(n_verbs),
                 i % n_objects if i < n_objects else rng.integers(n_objects))
            t = tuple(int(x) for x in t)
            if t not in seen:
                break
        else:
            # Keeping a repeated triple would break the held-out guarantee.
            raise _fresh_triple_error(f"train clip {i}")
        seen.add(t)
        triples.append(t)
    misses = 0
    while len(triples) < n_total:
        t = (int(rng.integers(n_subjects)), int(rng.integers(n_verbs)),
             int(rng.integers(n_objects)))
        if t not in seen:
            misses = 0
            seen.add(t)
            triples.append(t)
        else:
            misses += 1
            if misses > 1000:
                raise _fresh_triple_error(f"clip {len(triples)}")

    root_p = pathlib.Path(root)
    feat_dir = root_p / "feats"
    feat_dir.mkdir(parents=True, exist_ok=True)

    sentences: Dict[str, list] = {}
    counter: Counter = Counter()
    gts: Dict[str, list] = {}
    names = []
    for i, (si, vi, oi) in enumerate(triples):
        vid = f"clip{i:05d}"
        names.append(vid)
        feats = rng.normal(size=(feat_len, feat_dim)).astype(np.float32) * noise
        feats[:, dims["s"][0]:dims["s"][1]] += pat["s"][si]
        feats[:, dims["v"][0]:dims["v"][1]] += pat["v"][vi]
        feats[:, dims["o"][0]:dims["o"][1]] += pat["o"][oi]
        np.save(feat_dir / f"{vid}.npy", feats)

        k = int(rng.integers(2, max_captions_per_clip + 1))
        tmpl_ix = rng.choice(len(TEMPLATES), size=k, replace=False)
        sentences[vid] = []
        gts[vid] = []
        for c, ti in enumerate(tmpl_ix):
            sent = TEMPLATES[ti].format(s=subjects[si], v=verbs[vi], o=objects[oi])
            toks = tokenize_caption(sent)
            counter.update(toks)
            sentences[vid].append(toks)
            gts[vid].append({"image_id": vid, "cap_id": c, "caption": sent,
                             "tokenized": sent})

    word2ix, ix2word = build_vocab(counter)
    unk = word2ix["<unk>"]
    captions = {vid: [[word2ix.get(w, unk) for w in toks] for toks in caps]
                for vid, caps in sentences.items()}
    split_dict = {"train": names[:n_train],
                  "valid": names[n_train:n_train + n_valid],
                  "test": names[n_train + n_valid:]}

    with open(root_p / "captions.json", "w", encoding="utf-8") as f:
        json.dump({"word2ix": word2ix, "ix2word": ix2word,
                   "captions": captions, "splits": split_dict}, f)
    with open(root_p / "gts.json", "w", encoding="utf-8") as f:
        json.dump({"gts": gts}, f)

    return {"captions_file": str(root_p / "captions.json"),
            "gts_file": str(root_p / "gts.json"),
            "feat_path": str(feat_dir), "vocab_size": len(word2ix),
            "feat_len": feat_len, "feat_dim": feat_dim}
