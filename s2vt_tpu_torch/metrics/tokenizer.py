"""PTB tokenization for metric scoring, with no java and no nltk.

Counterpart of ``s2vt_tpu/metrics/tokenizer.py``. The coco-caption scorer
runs the Stanford CoreNLP PTBTokenizer jar with ``-preserveLines
-lowerCase`` and strips a fixed punctuation list; this module reproduces it
on the host:

 - ``"auto"`` (the default) and ``"nltk"``: the Penn Treebank rule chain
   (Robert MacIntyre's tokenizer.sed) as nltk's ``TreebankWordTokenizer``
   applies it with ``convert_parentheses=True``, kept here as a copy of its
   rules, so the tokens are the same whether or not nltk is installed; the
   JAX package's ``"nltk"`` backend gives the same tokens,
 - ``"native"``: the same rule chain in C++
   (``s2vt_tpu_torch/native/s2vt_tokenize.cpp``, built by
   ``utils/native_build.py`` on first use, loaded through ctypes),
 - ``"regex"``: the JAX package's smaller fallback rule set, on request,
 - ``"stanford"``: the jar itself through a subprocess (needs java and
   ``jar_path``).

Every backend but the jar shares the jar's unicode normalisation and its
sentence-final abbreviation convention. Interface as the coco-caption
wrapper: ``tokenize({image_id: [{'caption': str}, ...]}) -> {image_id:
[str, ...]}``.
"""

from __future__ import annotations

import re
from typing import Dict, List

# Tokens removed after tokenization (the coco-caption wrapper's list).
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(PUNCTUATIONS)

# Stanford's ptb3Escaping normalizes unicode punctuation before the rule
# chain; the Treebank rules do not (they leave '“oh' glued and 'don’t'
# unsplit). This pre-pass, shared by every java-free backend, reproduces it:
# directed double quotes -> '"' (the rule chain then emits `` or '' by
# position), left single quote -> `, right single quote -> ASCII
# apostrophe (so contractions split), en/em dash -> --, ellipsis -> ... .
_UNICODE_NORMALIZE = [
    ("“", '"'), ("”", '"'), ("„", '"'), ("«", '"'), ("»", '"'),
    ("‘", " ` "), ("‚", " ` "),
    ("’", "'"),
    ("–", " -- "), ("—", " -- "),
    ("…", " ... "),
]

# Sentence-final abbreviations: the Penn Treebank convention (which the
# Stanford lexer follows) keeps the abbreviation's own period and emits a
# separate final period ("u.s." "."); the rule chain strips the period into
# the final token ("u.s" "."). Repaired in a post-pass: letter-dot acronyms
# by pattern, common title and company abbreviations by list.
_ACRONYM = re.compile(r"^(?:[a-z]\.)+[a-z]$")
_ABBREVIATIONS = frozenset(
    "dr mr mrs ms prof etc jr sr vs inc ltd co corp st mt dept univ "
    "approx capt gen lt sgt col maj rev hon pres gov sen rep".split())

# The Treebank rule chain, in order (nltk/tokenize/treebank.py's
# TreebankWordTokenizer, with its MacIntyre contractions).
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),   # the final period
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_CONVERT_PARENTHESES = [
    (re.compile(r"\("), "-LRB-"), (re.compile(r"\)"), "-RRB-"),
    (re.compile(r"\["), "-LSB-"), (re.compile(r"\]"), "-RSB-"),
    (re.compile(r"\{"), "-LCB-"), (re.compile(r"\}"), "-RCB-"),
]
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b", r"(?i)\b(d)(?#X)('ye)\b", r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b", r"(?i)\b(got)(?#X)(ta)\b", r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b", r"(?i)\b(wan)(?#X)(na)(?=\s)",
    r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


def treebank_tokenize(text: str) -> List[str]:
    """The Treebank rule chain with brackets converted to -LRB-/-RRB-/...:
    what ``TreebankWordTokenizer().tokenize(text, convert_parentheses=True)``
    returns."""
    for regexp, substitution in _STARTING_QUOTES + _PUNCTUATION + [_PARENS_BRACKETS]:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _CONVERT_PARENTHESES + [_DOUBLE_DASHES]:
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def _regex_ptb_tokenize(text: str) -> List[str]:
    """The JAX package's minimal PTB-style fallback (``backend="regex"``)."""
    text = re.sub(r"([?!.,;:@#$%&])", r" \1 ", text)
    text = re.sub(r"\(", " -LRB- ", text)
    text = re.sub(r"\)", " -RRB- ", text)
    text = re.sub(r"([^' ])('s|'m|'d|'ll|'re|'ve|n't)\b", r"\1 \2", text)
    return text.split()


def _restore_final_abbreviation(toks: List[str]) -> List[str]:
    """'u.s' '.' -> 'u.s.' '.': the abbreviation keeps its period beside the
    separate final period (see _ABBREVIATIONS above)."""
    if len(toks) >= 2 and toks[-1] == ".":
        prev = toks[-2]
        if _ACRONYM.match(prev) or prev in _ABBREVIATIONS:
            toks = toks[:-2] + [prev + ".", "."]
    return toks


class _NativePTB:
    """ctypes wrapper over native/s2vt_tokenize.cpp (built on first use)."""

    def __init__(self):
        import ctypes

        from s2vt_tpu_torch.utils.native_build import build_native

        lib = ctypes.CDLL(str(build_native("s2vt_tokenize")))
        lib.s2vt_ptb_tokenize.restype = ctypes.c_long
        lib.s2vt_ptb_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long]
        self._ctypes = ctypes
        self._fn = lib.s2vt_ptb_tokenize

    def tokenize(self, line: str) -> List[str]:
        data = line.encode("utf-8")
        cap = 4 * len(data) + 256
        while True:
            buf = self._ctypes.create_string_buffer(cap)
            needed = self._fn(data, buf, cap)
            if needed + 1 <= cap:
                return buf.value.decode("utf-8").split()
            cap = needed + 1


_LINE_BACKENDS = {"nltk": treebank_tokenize, "regex": _regex_ptb_tokenize}


class PTBTokenizer:
    def __init__(self, backend: str = "auto", jar_path: str = None):
        self.jar_path = jar_path
        if backend == "auto":
            backend = "nltk"
        if backend == "native":
            self._tok = _NativePTB().tokenize
        elif backend in _LINE_BACKENDS:
            self._tok = _LINE_BACKENDS[backend]
        elif backend != "stanford":
            raise ValueError(f"unknown PTBTokenizer backend {backend!r}")
        self.backend = backend

    def _tokenize_line(self, line: str) -> List[str]:
        line = line.replace("\n", " ").lower()
        for src, dst in _UNICODE_NORMALIZE:
            if src in line:
                line = line.replace(src, dst)
        return _restore_final_abbreviation(self._tok(line))

    def tokenize(self, captions_for_image: Dict) -> Dict[str, List[str]]:
        if self.backend == "stanford":
            return self._tokenize_stanford(captions_for_image)
        out: Dict[str, List[str]] = {}
        for img_id, caps in captions_for_image.items():
            out[img_id] = []
            for cap in caps:
                text = cap["caption"] if isinstance(cap, dict) else cap
                words = [w for w in self._tokenize_line(text) if w not in _PUNCT_SET]
                out[img_id].append(" ".join(words))
        return out

    def _tokenize_stanford(self, captions_for_image: Dict) -> Dict[str, List[str]]:
        """The coco-caption contract: one sentence per line through the jar
        with -preserveLines -lowerCase (needs java and the jar)."""
        import subprocess
        ids, lines = [], []
        for img_id, caps in captions_for_image.items():
            for cap in caps:
                text = cap["caption"] if isinstance(cap, dict) else cap
                ids.append(img_id)
                lines.append(text.replace("\n", " "))
        proc = subprocess.run(
            ["java", "-cp", self.jar_path, "edu.stanford.nlp.process.PTBTokenizer",
             "-preserveLines", "-lowerCase"],
            input="\n".join(lines).encode(), capture_output=True, check=True)
        out: Dict[str, List[str]] = {}
        for img_id, line in zip(ids, proc.stdout.decode().split("\n")):
            words = [w for w in line.rstrip().split(" ") if w not in _PUNCT_SET]
            out.setdefault(img_id, []).append(" ".join(words))
        return out
