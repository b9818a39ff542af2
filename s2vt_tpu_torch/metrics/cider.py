"""CIDEr, numerically compatible with the coco-caption toolkit.

Counterpart of ``s2vt_tpu/metrics/cider.py``, with the semantics of
coco-caption's ``CiderScorer``:
 - corpus document frequency of each n-gram (n=1..4) over reference sets,
 - tf-idf vectors with idf = log(#images) - log(max(1, df)),
 - clipped cosine similarity per n (min(hyp, ref) * ref / norms),
 - gaussian length penalty exp(-(len_h - len_r)^2 / (2*sigma^2)), sigma=6,
 - mean over n, averaged over references, scaled by 10.

A toolkit quirk is kept for parity: the 'length' of the penalty is the
bigram total count (its counts2vec adds to the length at n-gram order 2),
not the unigram sentence length.
"""


from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngram_counts(words: List[str], n: int = 4) -> Counter:
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def _vectorize(self, counts: Counter, df: Dict, log_ref_len: float):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in counts.items():
            idf = log_ref_len - math.log(max(1.0, df.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * idf
            norm[k] += vec[k][ngram] ** 2
            if k == 1:  # toolkit quirk: bigram total drives the length penalty
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = np.zeros(self.n)
        for k in range(self.n):
            for ngram in vh[k]:
                val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())

        ref_counts = {i: [_ngram_counts(r.split(), self.n) for r in gts[i]]
                      for i in ids}
        df: Dict[tuple, float] = defaultdict(float)
        for i in ids:
            seen = set()
            for counts in ref_counts[i]:
                seen.update(counts.keys())
            for ngram in seen:
                df[ngram] += 1.0

        log_ref_len = math.log(float(len(ids)))
        scores = []
        for i in ids:
            hyp_counts = _ngram_counts(res[i][0].split(), self.n)
            vh, nh, lh = self._vectorize(hyp_counts, df, log_ref_len)
            total = np.zeros(self.n)
            for rc in ref_counts[i]:
                vr, nr, lr = self._vectorize(rc, df, log_ref_len)
                total += self._sim(vh, vr, nh, nr, lh, lr)
            scores.append(float(np.mean(total)) / len(ref_counts[i]) * 10.0)
        arr = np.asarray(scores)
        return float(arr.mean()), arr


class CiderD:
    """CIDEr-D with a pluggable document-frequency mode (coco-caption's
    Python-2 ``pyciderevalcap/ciderD``):

     - df_mode='corpus': document frequencies from the evaluation gts
       (identical to Cider above, which already implements CIDEr-D's count
       clipping and gaussian length penalty),
     - df_mode=<dict>: precomputed corpus document frequencies (ciderD loads
       a pickled df, e.g. from MS-COCO train), with ``ref_len`` =
       log(#documents) of that corpus.
    """

    def __init__(self, n: int = 4, sigma: float = 6.0, df_mode="corpus",
                 ref_len: float = None):
        self.inner = Cider(n=n, sigma=sigma)
        self.df_mode = df_mode
        self.ref_len = ref_len

    def method(self) -> str:
        return "CIDEr-D"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        if isinstance(self.df_mode, str) and self.df_mode == "corpus":
            return self.inner.compute_score(gts, res)
        # precomputed-df path
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        df = self.df_mode
        if self.ref_len is None:
            # The idf scale must come from the corpus the df dict was built
            # on (ciderD pickles ref_len alongside df); silently
            # substituting log(#eval ids) skews every score.
            raise ValueError(
                "CiderD with a precomputed df dict requires ref_len "
                "(log of the df corpus's document count)")
        log_ref_len = self.ref_len
        inner = self.inner
        scores = []
        for i in ids:
            hyp_counts = _ngram_counts(res[i][0].split(), inner.n)
            vh, nh, lh = inner._vectorize(hyp_counts, df, log_ref_len)
            total = np.zeros(inner.n)
            refs = [_ngram_counts(r.split(), inner.n) for r in gts[i]]
            for rc in refs:
                vr, nr, lr = inner._vectorize(rc, df, log_ref_len)
                total += inner._sim(vh, vr, nh, nr, lh, lr)
            scores.append(float(np.mean(total)) / len(refs) * 10.0)
        arr = np.asarray(scores)
        return float(arr.mean()), arr
