"""Corpus BLEU-1..4, numerically compatible with the coco-caption toolkit.

Counterpart of ``s2vt_tpu/metrics/bleu.py``, with the scoring semantics of
coco-caption's ``BleuScorer``:

 - clipped n-gram counts against per-ngram max reference counts,
 - 'closest' effective reference length when >1 image, 'average' for 1,
 - cumulative geometric-mean precision with the toolkit's tiny/small
   smoothing constants (tiny=1e-15 in the numerator, small=1e-9 in the
   denominator), so zero-match corners return the same values,
 - brevity penalty exp(1 - 1/ratio) applied when ratio < 1, with
   ratio = (testlen + tiny) / (reflen + small),
 - per-image scores use each image's own counts and brevity penalty.

Interface as the toolkit's ``Bleu(4).compute_score(gts, res)``: gts/res are
{image_id: [sentence, ...]} of pre-tokenized strings.
"""


from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngram_counts(words: List[str], n: int) -> Counter:
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[list, list]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        n = self.n
        option = "average" if len(ids) == 1 else "closest"

        total_correct = [0] * n
        total_guess = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_image: List[List[float]] = [[] for _ in range(n)]

        for img in ids:
            hyp_words = res[img][0].split()
            testlen = len(hyp_words)
            hyp_counts = _ngram_counts(hyp_words, n)

            ref_words = [r.split() for r in gts[img]]
            reflens = [len(w) for w in ref_words]
            max_ref: Counter = Counter()
            for w in ref_words:
                for ng, c in _ngram_counts(w, n).items():
                    max_ref[ng] = max(max_ref[ng], c)

            correct = [0] * n
            for ng, c in hyp_counts.items():
                correct[len(ng) - 1] += min(c, max_ref.get(ng, 0))
            guess = [max(0, testlen - k) for k in range(n)]

            if option == "closest":
                reflen = _closest_reflen(reflens, testlen)
            else:
                reflen = float(sum(reflens)) / len(reflens)

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_correct[k] += correct[k]
                total_guess[k] += guess[k]

            ratio = (testlen + _TINY) / (reflen + _SMALL)
            bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
            prod = 1.0
            for k in range(n):
                prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                per_image[k].append((prod ** (1.0 / (k + 1))) * bp)

        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
        corpus: List[float] = []
        prod = 1.0
        for k in range(n):
            prod *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            corpus.append((prod ** (1.0 / (k + 1))) * bp)

        return corpus, per_image
