"""ROUGE-L, numerically compatible with the coco-caption toolkit.

Counterpart of ``s2vt_tpu/metrics/rouge.py``: per image, the max
LCS-precision and the max LCS-recall over references, taken independently,
then F = (1+b^2)PR / (R + b^2 P) with beta=1.2; the corpus score is the mean
over images. The LCS dynamic program keeps one rolling numpy row.
"""


from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def lcs_length(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    if len(b) > len(a):
        a, b = b, a
    # index b tokens for fast comparison
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for x in a:
        cur = prev.copy()
        match = np.asarray([x == y for y in b])
        for j in range(1, len(b) + 1):
            if match[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return int(prev[-1])


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) > 0
        hyp = candidate[0].split(" ")
        precs, recs = [], []
        for ref in refs:
            r = ref.split(" ")
            lcs = lcs_length(r, hyp)
            precs.append(lcs / float(len(hyp)))
            recs.append(lcs / float(len(r)))
        p, r = max(precs), max(recs)
        if p != 0 and r != 0:
            return ((1 + self.beta ** 2) * p * r) / float(r + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        scores = np.asarray([self.calc_score(res[i], gts[i]) for i in ids])
        return float(scores.mean()), scores
