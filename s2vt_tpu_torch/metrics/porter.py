"""The Porter stemmer of METEOR's stem stage, with no nltk.

The algorithm is M. F. Porter, "An algorithm for suffix stripping",
Program 14.3 (1980): 130-137, with the deviations of nltk's
``nltk/stem/porter.py`` in its default ``NLTK_EXTENSIONS`` mode (nltk is
Apache-2.0): the irregular-forms table, words of one or two letters left
as they are, ``-ies``/``-ied`` on four-letter words, the ``*o`` rule for
two-letter stems, step 1c's consonant rule, the ``alli`` pre-pass of step 2
and its ``bli``, ``fulli`` and ``logi`` rules. ``PorterStemmer().stem(w)``
returns exactly what ``nltk.stem.PorterStemmer().stem(w)`` does;
tests/test_torch_metrics.py holds the two equal on many words.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

_VOWELS = frozenset("aeiou")

# nltk's table of irregular forms: word -> stem.
_IRREGULAR = {form: stem for stem, forms in {
    "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"], "tie": ["tying"],
    "news": ["news"], "inning": ["innings", "inning"], "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"], "howe": ["howe"], "proceed": ["proceed"],
    "exceed": ["exceed"], "succeed": ["succeed"]}.items() for form in forms}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a 'y' after a consonant
    (a run of 'y's alternates)."""
    if word[i] in _VOWELS:
        return False
    if word[i] != "y":
        return True
    negate = False
    while i > 0 and word[i] == "y":
        negate = not negate
        i -= 1
    return (word[i] not in _VOWELS) != negate


def _measure(stem: str) -> int:
    """m of [C](VC){m}[V]: the number of vowel-to-consonant turns."""
    cv = "".join("c" if _is_consonant(stem, i) else "v" for i in range(len(stem)))
    return cv.count("vc")


def _positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _measure_gt_1(stem: str) -> bool:
    return _measure(stem) > 1


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1)


def _ends_cvc(word: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or y;
    or (nltk's extension) it is a vowel and a consonant alone."""
    n = len(word)
    return (n >= 3 and _is_consonant(word, n - 3) and not _is_consonant(word, n - 2)
            and _is_consonant(word, n - 1) and word[-1] not in "wxy") or (
        n == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1))


def _apply_rules(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix ends the word decides: its condition on
    the stem holds, and the suffix is replaced, or the word stays as it is.
    The suffix "*d" stands for a double consonant."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
        elif word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
        else:
            continue
        return stem + replacement if condition is None or condition(stem) else word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return word[:-3] + "ie"
    return _apply_rules(word, [("sses", "ss", None), ("ies", "i", None),
                               ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _contains_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    return _apply_rules(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1], lambda _: stem[-1] not in "lsz"),
        ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s))])


def _step1c(word: str) -> str:
    return _apply_rules(word, [("y", "i", lambda s: len(s) > 1 and _is_consonant(s, len(s) - 1))])


_STEP2 = [(suffix, repl, _positive_measure) for suffix, repl in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"))]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive_measure(word[:-4]):
        return _step2(word[:-4] + "al")
    # logi -> log keeps the 'l' with the stem, so that geo-, theo- work.
    return _apply_rules(word, _STEP2 + [("logi", "log", lambda _: _positive_measure(word[:-3]))])


_STEP3 = [(suffix, repl, _positive_measure) for suffix, repl in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""))]

_STEP4 = [(suffix, "", _measure_gt_1) for suffix in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")] + [
    ("ion", "", lambda s: _measure(s) > 1 and s[-1] in "st")] + [
    (suffix, "", _measure_gt_1) for suffix in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")]


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rules(word, [("ll", "l", lambda _: _measure(word[:-1]) > 1)])


class PorterStemmer:
    """``stem(word)``: nltk's ``PorterStemmer().stem(word)``."""

    def stem(self, word: str) -> str:
        stem = word.lower()
        if stem in _IRREGULAR:
            return _IRREGULAR[stem]
        if len(word) <= 2:
            return stem
        for step in (_step1a, _step1b, _step1c, _step2,
                     lambda w: _apply_rules(w, _STEP3), lambda w: _apply_rules(w, _STEP4),
                     _step5a, _step5b):
            stem = step(stem)
        return stem
