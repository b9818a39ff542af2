"""Corpus helpers the dataset needs: tokenizer, vocab, captions.json reader.

Counterpart of the matching functions of ``s2vt_tpu/data/corpus.py``, with
the same artifact schema:

  captions.json: {word2ix, ix2word, captions: {video_id: [[ix,...],...]},
                  splits: {train, valid, test}}

``build_vocab`` keeps the reference's contract: <pad>=0, <unk>=1, then
frequency-ordered indices from 2. CSV / MSR-VTT parsing is not ported yet.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, List, Tuple

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


def load_captions(captions_file: str) -> dict:
    with open(captions_file, encoding="utf-8") as f:
        return json.load(f)


def special_token_indices(word2ix: Dict[str, int]) -> Dict[str, int]:
    """The actual indices of the special tokens (the reference hardcodes
    sos=3 / eos=4; its own vocab assigns them by frequency)."""
    return {"pad_ix": word2ix.get(PAD, 0), "unk_ix": word2ix.get(UNK, 1),
            "sos_ix": word2ix.get(SOS, 3), "eos_ix": word2ix.get(EOS, 4)}
