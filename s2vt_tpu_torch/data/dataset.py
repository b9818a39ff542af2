"""Fixed-shape host-side batch pipeline (numpy backend).

Counterpart of ``s2vt_tpu/data/dataset.py``. Batches have static shapes —
[B, L, feat_dim] feats, [B, L] labels/mask — and the final partial batch is
zero-padded to the batch size with a per-sample ``valid`` weight. Label
sampling is seeded by (seed, epoch) exactly as in the JAX package, so both
see the same batches. A consumer that keeps the whole split on the card
(the trainer's feature bank) reads it once with ``load_all_features`` and
asks for batches without features (``include_feats=False``). The C++
``native`` reader and device prefetching are not ported yet.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

from s2vt_tpu_torch.data.corpus import load_captions, special_token_indices


class Batch(NamedTuple):
    feats: Optional[np.ndarray]  # [B, L, feat_dim] float32 (None when the
    #   consumer gathers from a device-resident feature bank by `rows`)
    labels: np.ndarray   # [B, max_len] int32
    mask: np.ndarray     # [B, max_len] float32 (1 over real tokens incl. <sos>/<eos>)
    valid: np.ndarray    # [B] float32 (0 for padding samples in the last batch)
    ids: tuple           # video ids (len B; '' for padding samples)
    rows: np.ndarray = None  # [B] int32 dataset row of each sample (0 for
    #   padding samples; row i corresponds to feat_paths[i])


class VideoDataset:
    """Iterable over fixed-shape batches of (features, caption, mask)."""

    def __init__(self, captions_file: str, feat_path: str, max_len: int = 80,
                 mode: str = "train", seed: int = 0):
        data = load_captions(captions_file)
        self.word2ix: Dict[str, int] = data["word2ix"]
        # JSON stringifies int keys; normalize ix2word to int keys.
        self.ix2word: Dict[int, str] = {int(k): v for k, v in data["ix2word"].items()}
        self.captions: Dict[str, list] = data["captions"]
        self.splits = data["splits"]
        self.specials = special_token_indices(self.word2ix)

        split_set = set(self.splits[mode])
        self.feat_paths: List[pathlib.Path] = sorted(
            p for p in pathlib.Path(feat_path).glob("*.npy") if p.stem in split_set)
        if not self.feat_paths:
            raise FileNotFoundError(
                f"no .npy features for split {mode!r} under {feat_path}")
        self.max_len = max_len
        self.mode = mode
        self.seed = seed
        probe = np.load(str(self.feat_paths[0]), mmap_mode="r")
        self.feat_len, self.feat_dim = int(probe.shape[0]), int(probe.shape[1])

    def __len__(self) -> int:
        return len(self.feat_paths)

    @property
    def vocab_size(self) -> int:
        return len(self.word2ix)

    def _load_feat(self, i: int) -> np.ndarray:
        feat = np.load(str(self.feat_paths[i])).astype(np.float32)
        # 'free'-mode extraction gives ragged lengths: truncate or zero-pad
        # rows to the probed feat_len.
        if feat.shape[0] != self.feat_len:
            out = np.zeros((self.feat_len, self.feat_dim), np.float32)
            rows = min(feat.shape[0], self.feat_len)
            out[:rows] = feat[:rows]
            return out
        return feat

    def _encode_caption(self, tokens: List[int]) -> tuple:
        L = self.max_len
        tokens = tokens[:L]
        label = np.zeros((L,), np.int32)
        label[:len(tokens)] = tokens
        mask = np.zeros((L,), np.float32)
        mask[:len(tokens)] = 1.0
        return label, mask

    def load_all_features(self) -> np.ndarray:
        """The whole split as one [N, feat_len, feat_dim] float32 array, row i
        from feat_paths[i]: the host copy of a device feature bank."""
        out = np.empty((len(self.feat_paths), self.feat_len, self.feat_dim), np.float32)
        for i in range(len(self.feat_paths)):
            out[i] = self._load_feat(i)
        return out

    def nbytes(self) -> int:
        """Bytes of the split's features as float32."""
        return len(self.feat_paths) * self.feat_len * self.feat_dim * 4

    def batches(self, batch_size: int, shuffle: Optional[bool] = None,
                epoch: int = 0, drop_last: bool = False,
                include_feats: bool = True) -> Iterator[Batch]:
        """Yield fixed-shape batches, deterministic given (seed, epoch).
        ``include_feats=False`` reads no features (Batch.feats is None), for
        consumers that gather from a feature bank by ``Batch.rows``; label
        sampling is the same either way."""
        if shuffle is None:
            shuffle = self.mode == "train"
        n = len(self.feat_paths)
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(n) if shuffle else np.arange(n)
        if drop_last:
            order = order[:(n // batch_size) * batch_size]

        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            B = batch_size
            labels = np.zeros((B, self.max_len), np.int32)
            mask = np.zeros((B, self.max_len), np.float32)
            valid = np.zeros((B,), np.float32)
            rows = np.zeros((B,), np.int32)
            ids = [""] * B
            feats = (np.zeros((B, self.feat_len, self.feat_dim), np.float32)
                     if include_feats else None)
            for row, i in enumerate(idx):
                vid = self.feat_paths[i].stem
                caps = self.captions[vid]
                cap = caps[rng.integers(len(caps))]
                labels[row], mask[row] = self._encode_caption(cap)
                if include_feats:
                    feats[row] = self._load_feat(i)
                valid[row] = 1.0
                rows[row] = i
                ids[row] = vid
            yield Batch(feats, labels, mask, valid, tuple(ids), rows)


def make_synthetic_corpus(root: str, n_videos: int = 6, vocab_extra: int = 30,
                          feat_len: int = 8, feat_dim: int = 16,
                          max_caption_words: int = 6, seed: int = 0,
                          splits=(0.5, 0.25)) -> dict:
    """Build a tiny self-consistent corpus + .npy features for tests/demos,
    byte-for-byte the one ``s2vt_tpu`` builds from the same arguments.
    Returns paths and metadata."""
    from collections import Counter

    from s2vt_tpu_torch.data.corpus import build_vocab, tokenize_caption

    root_p = pathlib.Path(root)
    feat_dir = root_p / "feats"
    feat_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    words = [f"w{i}" for i in range(vocab_extra)]
    sentences: Dict[str, list] = {}
    counter: Counter = Counter()
    gts: Dict[str, list] = {}
    for v in range(n_videos):
        vid = f"vid{v:03d}"
        sentences[vid] = []
        gts[vid] = []
        for c in range(rng.integers(1, 4)):
            n_words = int(rng.integers(2, max_caption_words))
            sent = " ".join(rng.choice(words, n_words))
            toks = tokenize_caption(sent)
            counter.update(toks)
            sentences[vid].append(toks)
            gts[vid].append({"image_id": vid, "cap_id": c, "caption": sent,
                             "tokenized": sent.lower()})
        np.save(feat_dir / f"{vid}.npy",
                rng.normal(size=(feat_len, feat_dim)).astype(np.float32))

    word2ix, ix2word = build_vocab(counter)
    unk = word2ix["<unk>"]
    captions = {vid: [[word2ix.get(w, unk) for w in toks] for toks in caps]
                for vid, caps in sentences.items()}

    names = sorted(captions.keys())
    n_train = max(1, int(len(names) * splits[0]))
    n_valid = max(1, int(len(names) * splits[1]))
    split_dict = {"train": names[:n_train],
                  "valid": names[n_train:n_train + n_valid],
                  "test": names[n_train + n_valid:] or names[-1:]}

    captions_file = root_p / "captions.json"
    gts_file = root_p / "gts.json"
    with open(captions_file, "w", encoding="utf-8") as f:
        json.dump({"word2ix": word2ix, "ix2word": ix2word,
                   "captions": captions, "splits": split_dict}, f)
    with open(gts_file, "w", encoding="utf-8") as f:
        json.dump({"gts": gts}, f)

    return {"captions_file": str(captions_file), "gts_file": str(gts_file),
            "feat_path": str(feat_dir), "vocab_size": len(word2ix),
            "feat_len": feat_len, "feat_dim": feat_dim}
