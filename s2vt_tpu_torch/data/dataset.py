"""Fixed-shape host-side batch pipeline.

Counterpart of ``s2vt_tpu/data/dataset.py``. Batches have static shapes —
[B, L, feat_dim] feats, [B, L] labels/mask — and the final partial batch is
zero-padded to the batch size with a per-sample ``valid`` weight. Label
sampling is seeded by (seed, epoch) exactly as in the JAX package, so both
see the same batches. A consumer that keeps the whole split on the card
(the trainer's feature bank) reads it once with ``load_all_features`` and
asks for batches without features (``include_feats=False``).

Features stream through one of two backends: ``native``, the C++ reader
pool of ``native/s2vt_loader.cpp`` (``data/native_loader.py``), which reads
files ahead of the consumer on its own threads, or ``numpy`` (``np.load``
per file); ``preload`` reads the split once into host memory. A consumer
may hand ``batches`` the array each batch's features are written into
(``feats_alloc``), e.g. a view of pinned host memory, so that the batch
goes to the card without another host copy. ``read_ahead`` assembles the
next batches on a thread of its own, and ``prefetch_to_device`` keeps
``depth`` batches' device copies in flight ahead of the consuming step.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from s2vt_tpu_torch.data.corpus import load_captions, special_token_indices


def _npy_native_compatible(path) -> bool:
    """Header-only probe: True iff the C++ loader can read this file
    (little-endian float32, C-order, 2-D: s2vt_loader.cpp parse_npy_header).
    Files that fail (float64 or big-endian saves, say) still load through
    the numpy path, which converts them."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    except Exception:
        return False
    return not fortran and len(shape) == 2 and dtype == np.dtype("<f4")


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
                 mode: str = "train", seed: int = 0, preload: bool = False,
                 backend: str = "auto"):
        """backend: 'numpy' (np.load per file), 'native' (the C++ reader
        pool; raises unless every file is a little-endian float32 C-order
        2-D .npy and the library builds), or 'auto' (native when every file
        passes that header probe and the library builds, else numpy)."""
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"backend={backend!r}: expected 'auto', 'native' or 'numpy'")
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
        self._cache: Optional[list] = None
        if preload:
            self._cache = [np.load(str(p)).astype(np.float32) for p in self.feat_paths]
        probe = np.load(str(self.feat_paths[0]), mmap_mode="r")
        self.feat_len, self.feat_dim = int(probe.shape[0]), int(probe.shape[1])

        self._native = None
        self._native_ok = False
        self._backend_pref = backend
        if backend in ("auto", "native") and not preload:
            # Probe headers up front: the C++ loader reads only <f4 C-order
            # 2-D files. With backend='auto' an incompatible file routes the
            # whole dataset to the numpy path, never a failure at iteration.
            bad = [str(p) for p in self.feat_paths if not _npy_native_compatible(p)]
            if bad and backend == "native":
                raise ValueError(f"backend='native' requires little-endian float32 C-order "
                                 f"2-D .npy files; incompatible: {bad[:3]}")
            self._native_ok = not bad
        # Provisional until the first streaming use: 'native' here means the
        # header probe passed; the library builds lazily, and a failed build
        # (backend='auto') demotes to 'numpy' then. effective_backend() gives
        # the answer after the build.
        self.backend = "native" if self._native_ok else "numpy"

    def effective_backend(self) -> str:
        """The backend batches actually stream through: builds the C++
        library now (``_ensure_native``), so an 'auto' dataset whose build
        fails reports 'numpy' instead of the provisional 'native'."""
        self._ensure_native()
        return self.backend

    def _ensure_native(self):
        """Start the C++ reader pool on the FIRST streaming use: a consumer
        that gathers from a device feature bank (include_feats=False) never
        builds the library or holds the pool."""
        if self._native is None and self._native_ok:
            try:
                from s2vt_tpu_torch.data.native_loader import NativeFeatureLoader
                self._native = NativeFeatureLoader([str(p) for p in self.feat_paths],
                                                   self.feat_len, self.feat_dim)
            except Exception:
                if self._backend_pref == "native":
                    raise
                self._native_ok = False
                self.backend = "numpy"
        return self._native

    def __len__(self) -> int:
        return len(self.feat_paths)

    @property
    def vocab_size(self) -> int:
        return len(self.word2ix)

    def _load_feat(self, i: int) -> np.ndarray:
        if self._cache is not None:
            feat = self._cache[i]
        else:
            feat = np.load(str(self.feat_paths[i])).astype(np.float32)
        # 'free'-mode extraction gives ragged lengths: truncate or zero-pad
        # rows to the probed feat_len (the C++ loader does the same, so both
        # backends give the same bytes).
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
                include_feats: bool = True,
                feats_alloc: Optional[Callable[[], np.ndarray]] = None,
                feat_rows: Optional[Tuple[int, int]] = None) -> Iterator[Batch]:
        """Yield fixed-shape batches, deterministic given (seed, epoch).
        ``include_feats=False`` reads no features (Batch.feats is None), for
        consumers that gather from a feature bank by ``Batch.rows``; label
        sampling is the same either way. ``feats_alloc()``, when given,
        returns the writeable C-order float32 [n, feat_len, feat_dim] array
        each batch's features are written into (a fresh one per batch).
        ``feat_rows`` (lo, hi): read the features of batch rows lo..hi-1
        only (a data rank's rows), so ``Batch.feats`` is [hi - lo, ...]; the
        other fields stay those of the whole batch."""
        if shuffle is None:
            shuffle = self.mode == "train"
        n = len(self.feat_paths)
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(n) if shuffle else np.arange(n)
        if drop_last:
            order = order[:(n // batch_size) * batch_size]
        B = batch_size
        lo, hi = (0, B) if feat_rows is None else feat_rows
        feat_shape = (hi - lo, self.feat_len, self.feat_dim)
        # The rows whose features are read: each batch's lo..hi-1.
        read = order if feat_rows is None else np.concatenate(
            [order[s + lo:s + hi] for s in range(0, len(order), B)] + [order[:0]])

        native_iter = None
        if include_feats and len(read) and self._ensure_native() is not None:
            native_iter = self._native.iter_batches(read, hi - lo, alloc=feats_alloc)

        try:
            for start in range(0, len(order), B):
                idx = order[start:start + B]
                n_read = len(idx[lo:hi])
                labels = np.zeros((B, self.max_len), np.int32)
                mask = np.zeros((B, self.max_len), np.float32)
                valid = np.zeros((B,), np.float32)
                rows = np.zeros((B,), np.int32)
                ids = [""] * B
                if native_iter is not None and n_read:
                    feats = next(native_iter)   # read ahead on the pool's threads
                elif not include_feats:
                    feats = None
                elif feats_alloc is None:
                    feats = np.zeros(feat_shape, np.float32)
                else:
                    feats = feats_alloc()
                    feats[n_read:] = 0.0
                for row, i in enumerate(idx):
                    vid = self.feat_paths[i].stem
                    caps = self.captions[vid]
                    cap = caps[rng.integers(len(caps))]
                    labels[row], mask[row] = self._encode_caption(cap)
                    if include_feats and native_iter is None and lo <= row < hi:
                        feats[row - lo] = self._load_feat(i)
                    valid[row] = 1.0
                    rows[row] = i
                    ids[row] = vid
                yield Batch(feats, labels, mask, valid, tuple(ids), rows)
        finally:
            # Abandoned mid-epoch (a consumer's break or exception) or done:
            # close now. The loader's epoch generations keep a later epoch
            # safe either way.
            if native_iter is not None:
                native_iter.close()

    def steps_per_epoch(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self.feat_paths)
        return n // batch_size if drop_last else -(-n // batch_size)


def read_ahead(items: Iterator, depth: int) -> Iterator:
    """Yield ``items``, produced on a thread of its own up to ``depth`` items
    ahead of the consumer (``depth`` < 1: in the caller's thread, none
    ahead). Host work of the next batches (file reads, copies into pinned
    memory; the C++ loader and numpy release the GIL) then runs while the
    caller's thread launches the current step. An exception in the thread
    is raised in the consumer; a consumer that stops early stops the thread,
    and ``items`` is closed on it."""
    if depth < 1:
        yield from items
        return
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def run():
        try:
            for item in items:
                if not put((item, None)):
                    return
            put((end, None))
        except Exception as e:         # raised again in the consumer
            put((end, e))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=run, name="read_ahead", daemon=True)
    thread.start()
    try:
        while True:
            item, error = q.get()
            if item is end:
                if error is not None:
                    raise error
                return
            yield item
    finally:
        stop.set()
        thread.join()


def prefetch_to_device(batches: Iterator[Batch], put_fn, depth: int = 2):
    """Device-side input buffering: ``put_fn(batch)`` starts a batch's copy
    to the device (asynchronously, e.g. on a copy stream of its own), and
    ``depth`` such copies are kept in flight, so batch t+1's transfer runs
    under batch t's step instead of before it (``depth=1``: none ahead).
    Yields ``(host_batch, put_fn(host_batch))``; the host batch keeps ids
    and valid for bookkeeping without a device-to-host read."""
    from collections import deque
    q = deque()
    for batch in batches:
        q.append((batch, put_fn(batch)))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


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
