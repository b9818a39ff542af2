"""METEOR scoring: the jar's stdio protocol, and a pure-Python METEOR 1.5.

Counterpart of ``s2vt_tpu/metrics/meteor.py``. coco-caption drives the
METEOR 1.5 jar over a persistent stdio protocol (per segment a 'SCORE |||
ref1 ||| ... ||| hyp' line, then one 'EVAL' line):

 - backend='jar': that subprocess contract, for machines with java and
   meteor-1.5.jar (pass ``jar_path``).
 - backend='lite' (the fallback): METEOR 1.5 (Denkowski & Lavie 2014) in
   Python, with the English rank-task parameters (alpha=0.85, beta=0.2,
   gamma=0.6, delta=0.75; stage weights exact=1.0, stem=0.6, synonym=0.8,
   paraphrase=0.6):
     * matcher stages: exact, Porter stem (``metrics/porter.py``, nltk's
       stemmer without nltk), WordNet synonymy (the first stage that matches
       a word pair marks it, as in the jar's matcher), and the paraphrase
       stage: multi-word span matches from a table in paraphrase-en.gz's
       line format (``phrase ||| paraphrase``, gz or plain text; pass
       ``paraphrase_path``),
     * the jar's chunk-minimizing beam-search aligner: partial alignments
       over hypothesis positions ranked by (word coverage desc, chunks asc,
       total start distance asc), beam width 40. Matches are spans
       (hyp_start, hyp_len, ref_start, ref_len, stage),
     * the delta function-word discount: matched/total word counts weight
       content words by delta and function words by 1-delta. The jar reads
       its function.words list (words of relative corpus frequency > 1e-3);
       pass ``function_words`` (e.g. from ``derive_function_words``, the
       same rule) to supply it; the default is the English closed class.
   The synonym stage reads nltk's WordNet corpus when nltk and its data are
   installed (an optional lookup, as in the JAX package), and a synset table
   given as ``synonyms``; without either it matches nothing.

Corpus aggregation follows the jar's EVAL: per segment the best reference
(by segment score) contributes its match statistics to a corpus
accumulator, and the score is computed from the aggregate statistics, not
by averaging segment scores.
"""


from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# METEOR 1.5 'en' rank-task defaults.
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75                       # content-word weight (function = 1-delta)
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)   # exact, stem, synonym, paraphrase
BEAM_WIDTH = 40                    # the jar Aligner's default beam
MAX_PHRASE = 6                     # longest span the paraphrase stage tries

# English function words: approximates meteor-1.5/data/function.words (the
# jar derives it as words with relative corpus frequency > 1e-3 — i.e. the
# closed class plus high-frequency auxiliaries/pronouns). The jar's exact
# list is a data blob; this is the standard closed-class inventory. Supply
# Meteor(function_words=derive_function_words(corpus)) to use the jar's
# frequency rule on a real corpus instead.
FUNCTION_WORDS = frozenset("""
a an the
am is are was were be been being
do does did done doing
have has had having
will would shall should can could may might must ought
i you he she it we they me him her us them
my your his its our their mine yours hers ours theirs
this that these those there here
who whom whose which what when where why how
of in to for with on at by from up down about into over after under
between out against during without before around among through
and or but if while because as until although though so nor yet than
not no nor n't 's 'll 're 've 'd 'm
""".split())


def derive_function_words(lines: Iterable[str],
                          threshold: float = 1e-3) -> frozenset:
    """The jar's function.words derivation rule: every word whose RELATIVE
    corpus frequency exceeds ``threshold`` (1e-3 in meteor-1.5's shipped
    list). Feed it a large tokenized corpus (one sentence per line, already
    lowercased/tokenized the way your captions are)."""
    from collections import Counter
    counts: Counter = Counter()
    total = 0
    for line in lines:
        toks = line.split()
        counts.update(toks)
        total += len(toks)
    if total == 0:
        return frozenset()
    return frozenset(w for w, c in counts.items() if c / total > threshold)


class ParaphraseTable:
    """meteor-1.5 paraphrase-en.gz-format phrase table.

    Line format: ``phrase ||| paraphrase`` (both sides lowercase token
    strings). Lines with a leading numeric weight field
    (``w ||| phrase ||| paraphrase``, some PPDB exports) are accepted and
    the weight ignored — the jar's matcher is weightless too. Lookups are
    symmetric: a pair present in either direction matches both ways.
    """

    def __init__(self, path: str):
        import gzip
        self._table: Dict[Tuple[str, ...], set] = {}
        self.max_len = 1
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = [p.strip() for p in line.rstrip("\n").split("|||")]
                if len(parts) >= 3 and _is_number(parts[0]):
                    parts = parts[1:3]
                if len(parts) < 2 or not parts[0] or not parts[1]:
                    continue
                a = tuple(parts[0].split())
                b = tuple(parts[1].split())
                if not a or not b:
                    continue
                self._table.setdefault(a, set()).add(b)
                self._table.setdefault(b, set()).add(a)
                self.max_len = max(self.max_len, len(a), len(b))
        self.max_len = min(self.max_len, MAX_PHRASE)

    def __len__(self) -> int:
        return len(self._table)

    def paraphrases(self, phrase: Tuple[str, ...]) -> set:
        return self._table.get(phrase, ())

    def contains(self, a: Tuple[str, ...], b: Tuple[str, ...]) -> bool:
        return b in self._table.get(a, ())


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _porter():
    from s2vt_tpu_torch.metrics.porter import PorterStemmer
    return PorterStemmer()


def _wordnet_synsets():
    try:
        from nltk.corpus import wordnet as wn
        wn.synsets("dog")  # trigger corpus lookup
        return wn
    except Exception:
        return None


# A match is a span pair: (hyp_start, hyp_len, ref_start, ref_len, stage).
Match = Tuple[int, int, int, int, int]


def load_synsets(source) -> Dict[str, frozenset]:
    """Build a word -> {synset ids} map from ``source``: an iterable of
    synsets (each an iterable of mutually-synonymous words, or one
    space-separated line), a path (str / os.PathLike), or an open file
    object, the latter two holding one space-separated synset per line
    ('#' comments and blank lines skipped). This is WordNet's own
    shape — two words are synonymous iff they share a synset — so the
    table drives the same matcher logic as the nltk corpus and substitutes
    for it when the corpus data is absent from the environment."""
    import os
    if hasattr(source, "read"):        # open file object -> its content
        text = source.read()
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        source = text.splitlines()
    elif isinstance(source, (str, bytes, os.PathLike)):  # path -> content
        import pathlib
        source = pathlib.Path(os.fsdecode(source)).read_text(
            encoding="utf-8").splitlines()
    # source is now an iterable of synsets; a str element is one
    # space-separated file line (a bare word iterates character-wise,
    # so lines must be split here, never passed through)
    parsed = []
    for synset in source:
        if isinstance(synset, str):
            if not synset.strip() or synset.lstrip().startswith("#"):
                continue
            synset = synset.split()
        parsed.append(synset)
    table: Dict[str, set] = {}
    for i, synset in enumerate(parsed):
        for w in synset:
            table.setdefault(w.lower(), set()).add(i)
    return {w: frozenset(s) for w, s in table.items()}


class _Aligner:
    """Meteor 1.5-style aligner (beam search, chunk-minimizing).

    Unigram stages (exact / stem / synonym) emit 1x1 span matches; the
    paraphrase stage emits multi-word span matches from the table. The
    beam search selects a non-overlapping subset by the jar's resolution
    order: max word coverage, then min chunks, then min total distance
    between matched span starts.
    """

    def __init__(self, beam: int = BEAM_WIDTH,
                 paraphrases: Optional[ParaphraseTable] = None,
                 synonyms=None):
        self.stemmer = _porter()
        self.wn = _wordnet_synsets()
        self.syn_table: Dict[str, frozenset] = (
            load_synsets(synonyms) if synonyms is not None else {})
        self._syn_members: Dict[int, set] = {}
        for word, ids in self.syn_table.items():
            for i in ids:
                self._syn_members.setdefault(i, set()).add(word)
        self.beam = beam
        self.paraphrases = paraphrases
        self._stem_cache: Dict[str, str] = {}
        self._syn_cache: Dict[str, frozenset] = {}

    def _stem(self, w: str) -> str:
        s = self._stem_cache.get(w)
        if s is None:
            s = self.stemmer.stem(w)
            self._stem_cache[w] = s
        return s

    def _synonyms(self, w: str) -> frozenset:
        syns = self._syn_cache.get(w)
        if syns is None:
            acc = {w}
            if self.wn is not None:
                for ss in self.wn.synsets(w):
                    for lemma in ss.lemmas():
                        acc.add(lemma.name().lower())
            for i in self.syn_table.get(w, ()):
                acc.update(self._syn_members[i])
            syns = frozenset(acc)
            self._syn_cache[w] = syns
        return syns

    def match_stage(self, hw: str, rw: str) -> int:
        """First unigram matcher stage (0 exact, 1 stem, 2 synonym) that
        matches the pair, or -1 — the jar marks each pair with its earliest
        stage."""
        if hw == rw:
            return 0
        if self._stem(hw) == self._stem(rw):
            return 1
        if ((self.wn is not None or self.syn_table)
                and rw in self._synonyms(hw)):
            return 2
        return -1

    def _candidates(self, hyp: List[str], ref: List[str]) -> List[List[Match]]:
        """All candidate matches, bucketed by hyp start position."""
        n, m = len(hyp), len(ref)
        cands: List[List[Match]] = [[] for _ in range(n)]
        unigram = [[-1] * m for _ in range(n)]
        for i in range(n):
            for j in range(m):
                stage = self.match_stage(hyp[i], ref[j])
                unigram[i][j] = stage
                if stage >= 0:
                    cands[i].append((i, 1, j, 1, stage))
        tab = self.paraphrases
        if tab is not None and len(tab):
            pmax = tab.max_len
            for i in range(n):
                for li in range(1, min(pmax, n - i) + 1):
                    hp = tuple(hyp[i:i + li])
                    syn = tab.paraphrases(hp)
                    if not syn:
                        continue
                    for j in range(m):
                        for lj in range(1, min(pmax, m - j) + 1):
                            if tuple(ref[j:j + lj]) not in syn:
                                continue
                            # earliest-stage marking: a 1x1 pair already
                            # matched by exact/stem/synonym keeps that stage
                            if li == 1 and lj == 1 and unigram[i][j] >= 0:
                                continue
                            cands[i].append((i, li, j, lj, 3))
        return cands

    def align(self, hyp: List[str], ref: List[str]) -> List[Match]:
        """Best non-overlapping match set [(i, li, j, lj, stage)], sorted by
        hyp position. Beam search over hypothesis positions: at each state
        the next hyp word is either skipped or consumed by a candidate
        match whose ref span is still free."""
        n, m = len(hyp), len(ref)
        if n == 0 or m == 0:
            return []
        cands = self._candidates(hyp, ref)

        # state: (used_ref_mask, hyp_end, ref_end, cover, chunks, dist, pairs)
        # hyp_end/ref_end: exclusive end of the last match (for contiguity);
        # cover: words covered in hyp + ref (the jar's coverage objective).
        key = lambda s: (-s[3], s[4], s[5])
        beams: Dict[int, list] = {0: [(0, -1, -1, 0, 0, 0, ())]}
        for i in range(n):
            states = beams.pop(i, [])
            if not states:
                continue
            states.sort(key=key)
            states = states[:self.beam]
            # skipping hyp word i moves the state to i+1 unchanged
            beams.setdefault(i + 1, []).extend(states)
            for used, he, re_, cov, ch, ds, pairs in states:
                for (_, li, j, lj, stage) in cands[i]:
                    span_bits = ((1 << lj) - 1) << j
                    if used & span_bits:
                        continue
                    contiguous = (i == he and j == re_)
                    beams.setdefault(i + li, []).append(
                        (used | span_bits, i + li, j + lj,
                         cov + li + lj,
                         ch + (0 if contiguous else 1),
                         ds + abs(i - j),
                         pairs + ((i, li, j, lj, stage),)))
        final = beams.get(n, [])
        if not final:
            return []
        final.sort(key=key)
        return list(final[0][6])

    @staticmethod
    def count_chunks(matches: List[Match]) -> int:
        """Contiguous-in-both-sides runs of the alignment (METEOR chunks).
        ``matches`` must be sorted by hyp index (align() returns them so);
        a multi-word span is one chunk continuation like the jar's."""
        if not matches:
            return 0
        chunks = 1
        for (i0, li0, j0, lj0, _), (i1, _, j1, _, _) in zip(matches,
                                                            matches[1:]):
            if not (i1 == i0 + li0 and j1 == j0 + lj0):
                chunks += 1
        return chunks


def _word_weight(w: str, function_words: frozenset = FUNCTION_WORDS) -> float:
    return (1.0 - DELTA) if w in function_words else DELTA


class _Stats:
    """Sufficient statistics of one segment (or a corpus accumulation)."""

    __slots__ = ("weighted_h", "weighted_r", "wlen_h", "wlen_r",
                 "matches_h", "matches_r", "chunks")

    def __init__(self, weighted_h=0.0, weighted_r=0.0, wlen_h=0.0,
                 wlen_r=0.0, matches_h=0, matches_r=0, chunks=0):
        self.weighted_h = weighted_h
        self.weighted_r = weighted_r
        self.wlen_h = wlen_h
        self.wlen_r = wlen_r
        self.matches_h = matches_h   # hyp words covered by matches
        self.matches_r = matches_r   # ref words covered by matches
        self.chunks = chunks

    def add(self, other: "_Stats") -> None:
        self.weighted_h += other.weighted_h
        self.weighted_r += other.weighted_r
        self.wlen_h += other.wlen_h
        self.wlen_r += other.wlen_r
        self.matches_h += other.matches_h
        self.matches_r += other.matches_r
        self.chunks += other.chunks

    def score(self) -> float:
        avg_matches = 0.5 * (self.matches_h + self.matches_r)
        if self.wlen_h == 0.0 or self.wlen_r == 0.0 or avg_matches == 0:
            return 0.0
        p = self.weighted_h / self.wlen_h
        r = self.weighted_r / self.wlen_r
        if p == 0.0 or r == 0.0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        # METEOR 1.5 fragmentation penalty: Pen = gamma * frag^beta, with
        # frag = chunks / avg matched words (hyp/ref averaged — they differ
        # only when a paraphrase match covers unequal span lengths).
        frag = self.chunks / avg_matches
        pen = GAMMA * (frag ** BETA)
        return (1.0 - pen) * fmean


class Meteor:
    def __init__(self, backend: str = "auto", jar_path: Optional[str] = None,
                 paraphrase_path: Optional[str] = None,
                 function_words: Optional[Iterable[str]] = None,
                 synonyms=None):
        """``synonyms``: an iterable of synsets or a path to a one-synset-
        per-line file (see ``load_synsets``) — substitutes for the nltk
        WordNet corpus when that data is absent (the matcher logic is
        shared either way)."""
        self.jar_path = jar_path
        self.function_words = (frozenset(function_words)
                               if function_words is not None
                               else FUNCTION_WORDS)
        if backend == "auto":
            backend = "jar" if self._jar_available() else "lite"
        self.backend = backend
        if backend == "lite":
            table = (ParaphraseTable(paraphrase_path)
                     if paraphrase_path else None)
            self.aligner = _Aligner(paraphrases=table, synonyms=synonyms)
        elif backend == "jar":
            self._start_jar()

    def method(self) -> str:
        return "METEOR"

    # ------------------------------------------------------------------
    # lite backend
    # ------------------------------------------------------------------

    def _weight(self, w: str) -> float:
        return (1.0 - DELTA) if w in self.function_words else DELTA

    def _segment_stats(self, hyp: str, refs: List[str]) -> _Stats:
        hyp_w = hyp.split()
        wlen_h = sum(self._weight(w) for w in hyp_w)
        sw = STAGE_WEIGHTS
        best: Optional[_Stats] = None
        for ref in refs:
            ref_w = ref.split()
            matches = self.aligner.align(hyp_w, ref_w)
            st = _Stats(
                weighted_h=sum(sw[s] * self._weight(w)
                               for i, li, _, _, s in matches
                               for w in hyp_w[i:i + li]),
                weighted_r=sum(sw[s] * self._weight(w)
                               for _, _, j, lj, s in matches
                               for w in ref_w[j:j + lj]),
                wlen_h=wlen_h,
                wlen_r=sum(self._weight(w) for w in ref_w),
                matches_h=sum(li for _, li, _, _, _ in matches),
                matches_r=sum(lj for _, _, _, lj, _ in matches),
                chunks=self.aligner.count_chunks(matches))
            if best is None or st.score() > best.score():
                best = st
        return best if best is not None else _Stats()

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        if self.backend == "jar":
            return self._compute_score_jar(gts, res, ids)
        total = _Stats()
        scores = []
        for i in ids:
            assert len(res[i]) == 1
            st = self._segment_stats(res[i][0], gts[i])
            scores.append(st.score())
            total.add(st)
        return total.score(), scores

    # ------------------------------------------------------------------
    # jar backend (the coco-caption stdio protocol)
    # ------------------------------------------------------------------

    def _jar_available(self) -> bool:
        import shutil
        return (self.jar_path is not None and shutil.which("java") is not None)

    def _start_jar(self):
        import subprocess
        import threading
        self._lock = threading.Lock()
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", self.jar_path, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    def _compute_score_jar(self, gts, res, ids):
        with self._lock:
            eval_parts = ["EVAL"]
            for i in ids:
                hyp = res[i][0].replace("|||", "").replace("  ", " ")
                line = " ||| ".join(("SCORE", " ||| ".join(gts[i]), hyp))
                self._proc.stdin.write((line + "\n").encode())
                self._proc.stdin.flush()
                eval_parts.append(self._proc.stdout.readline().decode().strip())
            self._proc.stdin.write((" ||| ".join(eval_parts) + "\n").encode())
            self._proc.stdin.flush()
            scores = [float(self._proc.stdout.readline().decode().strip())
                      for _ in ids]
            corpus = float(self._proc.stdout.readline().decode().strip())
        return corpus, scores
