"""Corpus preparation: MSVD CSV / MSR-VTT JSON -> captions.json + gts.json.

Counterpart of ``s2vt_tpu/data/corpus.py``, with the same artifact schema:

  captions.json: {word2ix, ix2word, captions: {video_id: [[ix,...],...]},
                  splits: {train, valid, test}}
  gts.json:      {gts: {video_id: [{image_id, cap_id, caption, tokenized}]}}

``build_vocab`` keeps the reference's contract: <pad>=0, <unk>=1, then
frequency-ordered indices from 2. The train/valid/test shuffle of
``parse_csv`` is seedable (``np.random.default_rng(seed).shuffle`` over the
clips in order of first appearance).

``parse_csv`` reads the CSV with the standard ``csv`` module, not pandas, and
writes the same bytes as the JAX package, whose pandas ``read_csv`` +
``dropna`` decide which rows count and how clip ids print. These pandas
rules are reproduced:

 - a field that is empty, or reads exactly as one of pandas' default NA
   strings (``NA``, ``N/A``, ``None``, ``null``, ``nan``, ... : ``_NA``),
   quoted or not, is missing; a row with a missing field in ANY column
   (``WorkerID`` and ``AnnotationTime`` too), or with fewer fields than the
   header, is dropped; a row with more fields raises;
 - a column whose present fields are all integers (optional sign and
   surrounding blanks) is an integer column: ``007`` prints ``7``; if it
   also has a missing field anywhere, or a field that is a decimal or
   exponent number, it is a float column, and every value prints as a
   Python float (``ab_1.0_5``, not ``ab_1_5``); any other column keeps its
   strings as written;
 - descriptions keep their surrounding spaces; quoted fields may hold
   commas and newlines; blank lines are skipped; a UTF-8 byte-order mark is
   dropped.

pandas' other inferences (``True`` / ``False`` as booleans, thousands
separators, integers past int64) are not reproduced.
"""

from __future__ import annotations

import csv
import json
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Punctuation stripped by the reference tokenizer (prepare_captions.py:57).
_PUNCT_RE = re.compile(r"[~\\/().!,;?:]")

PAD, UNK, SOS, EOS = "<pad>", "<unk>", "<sos>", "<eos>"


def tokenize_caption(sentence: str) -> List[str]:
    """lowercase -> strip punctuation -> whitespace split -> wrap <sos>/<eos>."""
    cleaned = _PUNCT_RE.sub(" ", sentence.lower())
    return [SOS] + cleaned.split() + [EOS]


def build_vocab(counter: Counter, min_feq: int = 1) -> Tuple[Dict[str, int], Dict[int, str]]:
    """<pad>=0, <unk>=1, then Counter.most_common order from index 2."""
    word2ix: Dict[str, int] = {PAD: 0, UNK: 1}
    ix = 2
    for word, feq in counter.most_common():
        if feq < min_feq:
            continue
        word2ix[word] = ix
        ix += 1
    ix2word = {v: k for k, v in word2ix.items()}
    return word2ix, ix2word


class _CorpusAccumulator:
    """Collects (video_id, sentence) pairs and materializes the artifacts."""

    def __init__(self):
        self.counter: Counter = Counter()
        self.entries: List[Tuple[str, List[str]]] = []  # (video_id, tokens)
        self.gts: Dict[str, list] = {}

    def add(self, video_id: str, sentence: str) -> None:
        tokens = tokenize_caption(sentence)
        self.counter.update(tokens)
        self.entries.append((video_id, tokens))
        bucket = self.gts.setdefault(video_id, [])
        bucket.append({
            "image_id": video_id,
            "cap_id": len(bucket),
            "caption": sentence,
            # gts 'tokenized' is the pre-split cleaned string (prepare_captions.py:56-58)
            "tokenized": _PUNCT_RE.sub(" ", sentence.lower()),
        })

    def materialize(self, min_feq: int = 1):
        word2ix, ix2word = build_vocab(self.counter, min_feq)
        unk = word2ix[UNK]
        captions: Dict[str, List[List[int]]] = {}
        for vid, tokens in self.entries:
            captions.setdefault(vid, []).append([word2ix.get(w, unk) for w in tokens])
        return word2ix, ix2word, captions


def _save_artifacts(captions_file: str, gts_file: str, word2ix, ix2word,
                    captions, splits, gts) -> None:
    with open(captions_file, "w", encoding="utf-8") as f:
        json.dump({"word2ix": word2ix, "ix2word": ix2word,
                   "captions": captions, "splits": splits}, f)
    with open(gts_file, "w", encoding="utf-8") as f:
        json.dump({"gts": gts}, f)


# pandas' default NA strings (pandas/_libs/parsers.pyx STR_NA_VALUES).
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})
_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT_RE = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*$")


def _column_printer(values: Sequence[Optional[str]]):
    """How pandas' type inference prints one column's fields (None = missing)."""
    present = [v for v in values if v is not None]
    if present and all(_INT_RE.match(v) for v in present):
        if len(present) == len(values):
            return lambda v: str(int(v))
        return lambda v: str(float(int(v)))
    if present and all(_FLOAT_RE.match(v) for v in present):
        return lambda v: str(float(v))
    return lambda v: v


def _read_csv_rows(csv_file: str) -> List[Dict[str, str]]:
    """The CSV's complete rows as {column: printed value}, after the pandas
    rules of the module docstring."""
    with open(csv_file, encoding="utf-8-sig", newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    cols: List[List[Optional[str]]] = [[] for _ in header]
    for n, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{csv_file}: row {n + 2} has {len(r)} fields, the header "
                             f"{len(header)}")
        for j, col in enumerate(cols):
            v = r[j] if j < len(r) else ""
            col.append(None if v in _NA else v)
    printers = [_column_printer(col) for col in cols]
    out = []
    for i in range(len(body)):
        fields = [col[i] for col in cols]
        if all(v is not None for v in fields):
            out.append({name: p(v) for name, p, v in zip(header, printers, fields)})
    return out


def parse_csv(csv_file: str, captions_file: str, gts_file: str,
              clean_only: bool = False, min_feq: int = 1,
              split_sizes: Tuple[int, int] = (1400, 450),
              seed: Optional[int] = None) -> dict:
    """MSVD video_corpus.csv -> artifacts (reference parse_csv semantics:
    English-only rows, optional Source=='clean' filter, video id
    '{VideoID}_{Start}_{End}', random 1400/450/rest split)."""
    acc = _CorpusAccumulator()
    for row in _read_csv_rows(csv_file):
        if row["Language"] != "English" or (clean_only and row["Source"] != "clean"):
            continue
        acc.add(f"{row['VideoID']}_{row['Start']}_{row['End']}", row["Description"])

    word2ix, ix2word, captions = acc.materialize(min_feq)

    names = list(captions.keys())
    rng = np.random.default_rng(seed) if seed is not None else np.random
    rng.shuffle(names)
    n_train, n_valid = split_sizes
    splits = {"train": names[:n_train],
              "valid": names[n_train:n_train + n_valid],
              "test": names[n_train + n_valid:]}

    _save_artifacts(captions_file, gts_file, word2ix, ix2word, captions, splits, acc.gts)
    return {"word2ix": word2ix, "ix2word": ix2word, "captions": captions,
            "splits": splits, "gts": acc.gts}


def parse_msr_vtt(train_source_file: str, test_source_file: str,
                  captions_file: str, gts_file: str, min_feq: int = 1) -> dict:
    """MSR-VTT train_val/test JSON -> artifacts. Splits come from the
    dataset's own 'split' field ('validate' -> valid), matching
    prepare_captions.py:118-197."""
    with open(train_source_file, encoding="utf-8") as f:
        data = json.load(f)
    videos = list(data["videos"])
    with open(test_source_file, encoding="utf-8") as f:
        videos += json.load(f)["videos"]

    acc = _CorpusAccumulator()
    for item in data["sentences"]:
        acc.add(item["video_id"], item["caption"])
    word2ix, ix2word, captions = acc.materialize(min_feq)

    splits = {"train": [], "valid": [], "test": []}
    for video in videos:
        key = {"train": "train", "validate": "valid"}.get(video["split"], "test")
        splits[key].append(video["video_id"])

    _save_artifacts(captions_file, gts_file, word2ix, ix2word, captions, splits, acc.gts)
    return {"word2ix": word2ix, "ix2word": ix2word, "captions": captions,
            "splits": splits, "gts": acc.gts}


def load_captions(captions_file: str) -> dict:
    with open(captions_file, encoding="utf-8") as f:
        return json.load(f)


def special_token_indices(word2ix: Dict[str, int]) -> Dict[str, int]:
    """The actual indices of the special tokens (the reference hardcodes
    sos=3 / eos=4; its own vocab assigns them by frequency)."""
    return {"pad_ix": word2ix.get(PAD, 0), "unk_ix": word2ix.get(UNK, 1),
            "sos_ix": word2ix.get(SOS, 3), "eos_ix": word2ix.get(EOS, 4)}


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
