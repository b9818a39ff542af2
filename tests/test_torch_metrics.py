"""The port's metric layer (``s2vt_tpu_torch/metrics``) against s2vt_tpu's, on
the CPU: BLEU-1..4, ROUGE-L, CIDEr, CIDEr-D and METEOR equal to 1e-12 at
corpus level and per image on the same gts and predictions; the Porter
stemmer equal to nltk's; the PTB tokens equal to the JAX package's ``nltk``
backend whether or not nltk can be imported; the native tokenizer equal to
the Python rule chain."""

import gzip
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest

from s2vt_tpu_torch import metrics as pmetrics
from s2vt_tpu_torch.metrics import CiderD, Meteor, PTBTokenizer, meteor
from s2vt_tpu_torch.metrics.porter import PorterStemmer

pytest.importorskip("flax", reason="the JAX reference package needs flax")

from s2vt_tpu import metrics as jmetrics  # noqa: E402
from s2vt_tpu.metrics import meteor as jmeteor  # noqa: E402
from s2vt_tpu.metrics.tokenizer import PTBTokenizer as JPTBTokenizer  # noqa: E402

import test_meteor_aligner as aligner_cases  # noqa: E402
import test_metrics as metric_cases  # noqa: E402
import test_metrics_vs_reference as reference_cases  # noqa: E402
import test_native_tokenizer as native_cases  # noqa: E402
import test_tokenizer_golden as golden_cases  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-12
SYNSETS = str(pathlib.Path(__file__).parent / "data" / "synsets_small.txt")

# Words of the metric fixtures, the synset fixture and a caption domain: the
# random corpora draw from these, so every matcher stage fires.
_WORDS = ("a the cat dog man woman is runs jumps sits plays playing played guitar ball red "
          "blue small big large little on in with and hound canine kid child street road "
          "quick fast slice cut slicing cooking cooks talk speaks zorp blick frob wug").split()
PARAPHRASES = ["zorp ||| blick", "large canine ||| big dog", "zorp glim ||| blick",
               "0.87 ||| frob ||| wug", "the ||| the", "a man ||| a guy", "cut ||| slice up"]


def _corpus(seed, n_imgs=12, max_refs=4, max_len=12):
    """Random {image: [refs]}, {image: [hyp]} drawn from a seed."""
    rng = np.random.default_rng(seed)
    gts, res = {}, {}
    for i in range(n_imgs):
        key = f"img{i}"
        gts[key] = [" ".join(rng.choice(_WORDS, rng.integers(2, max_len)))
                    for _ in range(rng.integers(1, max_refs + 1))]
        res[key] = [" ".join(rng.choice(_WORDS, rng.integers(1, max_len)))]
    return gts, res


FIXED = {
    "perfect": (metric_cases.GTS, metric_cases.RES_PERFECT),
    "partial": (metric_cases.GTS, metric_cases.RES_PARTIAL),
    "single": ({"x": ["a cat sits on the mat", "the cat is sitting"]},
               {"x": ["a cat sits on a mat"]}),
    "aligner": ({f"c{i}": [ref] for i, (_, ref) in enumerate(aligner_cases.CASES)},
                {f"c{i}": [hyp] for i, (hyp, _) in enumerate(aligner_cases.CASES)}),
    "synonyms": ({"x": ["a big dog"], "y": ["a large hound"], "z": ["the kid runs on the road"]},
                 {"x": ["a large dog"], "y": ["a big dog"], "z": ["a child runs in the street"]}),
    "paraphrase": ({"a": ["the blick ran"], "b": ["a big dog runs"], "c": ["a blick"],
                    "d": ["a guy cut it"]},
                   {"a": ["the zorp ran"], "b": ["a large canine runs"], "c": ["a zorp glim"],
                    "d": ["a man slice up it"]}),
}
CASES = {**FIXED, **{f"random{s}": _corpus(s) for s in range(6)},
         **{f"reference{s}": reference_cases._corpus(s) for s in range(6)}}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric", ["Bleu", "Rouge", "Cider", "CiderD"])
def test_ngram_metrics_match_jax(case, metric):
    gts, res = CASES[case]
    make = {"Bleu": lambda m: m.Bleu(4), "Rouge": lambda m: m.Rouge(),
            "Cider": lambda m: m.Cider(), "CiderD": lambda m: m.CiderD()}[metric]
    got, got_per = make(pmetrics).compute_score(gts, res)
    want, want_per = make(jmetrics).compute_score(gts, res)
    _close(got, want)
    _close(got_per, want_per)


def test_cider_d_with_precomputed_df_matches_jax():
    gts, res = _corpus(7)
    df = {}
    for refs in _corpus(8, n_imgs=30)[0].values():
        seen = set()
        for r in refs:
            w = r.split()
            seen.update(tuple(w[i:i + k]) for k in range(1, 5) for i in range(len(w) - k + 1))
        for ng in seen:
            df[ng] = df.get(ng, 0.0) + 1.0
    got = CiderD(df_mode=df, ref_len=np.log(30.0)).compute_score(gts, res)
    want = jmetrics.CiderD(df_mode=df, ref_len=np.log(30.0)).compute_score(gts, res)
    _close(got[0], want[0])
    _close(got[1], want[1])
    with pytest.raises(ValueError, match="ref_len"):
        CiderD(df_mode=df).compute_score(gts, res)


@pytest.fixture(scope="module")
def paraphrase_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("para") / "paraphrase-en.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(PARAPHRASES + ["", "malformed-line-no-separator"]) + "\n")
    return str(path)


def _meteor_kw(variant, paraphrase_path):
    derived = sorted(meteor.derive_function_words(
        [s for g, _ in CASES.values() for refs in g.values() for s in refs], threshold=0.02))
    return {"plain": {}, "synonyms": {"synonyms": SYNSETS},
            "paraphrase": {"paraphrase_path": paraphrase_path},
            "function_words": {"function_words": derived},
            "all": {"synonyms": SYNSETS, "paraphrase_path": paraphrase_path,
                    "function_words": derived}}[variant]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("variant", ["plain", "synonyms", "paraphrase", "function_words", "all"])
def test_meteor_matches_jax(case, variant, paraphrase_path):
    gts, res = CASES[case]
    kw = _meteor_kw(variant, paraphrase_path)
    got, got_per = Meteor(backend="lite", **kw).compute_score(gts, res)
    want, want_per = jmeteor.Meteor(backend="lite", **kw).compute_score(gts, res)
    _close(got, want)
    _close(got_per, want_per)


@pytest.mark.parametrize("hyp,ref", aligner_cases.CASES + [
    ("a large canine runs", "a big dog runs"), ("the zorp glim", "the blick"),
    ("a man plays", "a guy playing")], ids=lambda s: s)
def test_aligner_matches_jax(hyp, ref, paraphrase_path):
    kw = dict(paraphrases=meteor.ParaphraseTable(paraphrase_path), synonyms=SYNSETS)
    ours = meteor._Aligner(**kw)
    theirs = jmeteor._Aligner(paraphrases=jmeteor.ParaphraseTable(paraphrase_path),
                              synonyms=SYNSETS)
    h, r = hyp.split(), ref.split()
    assert ours.align(h, r) == theirs.align(h, r)
    assert [[ours.match_stage(a, b) for b in r] for a in h] == \
        [[theirs.match_stage(a, b) for b in r] for a in h]
    assert ours.count_chunks(ours.align(h, r)) == theirs.count_chunks(theirs.align(h, r))


def test_meteor_helpers_match_jax(tmp_path, paraphrase_path):
    assert meteor.load_synsets(SYNSETS) == jmeteor.load_synsets(SYNSETS)
    ours, theirs = meteor.ParaphraseTable(paraphrase_path), jmeteor.ParaphraseTable(paraphrase_path)
    assert ours._table == theirs._table and ours.max_len == theirs.max_len
    corpus = ["the cat sat on the mat"] * 500 + ["a rare ocelot appeared"]
    assert meteor.derive_function_words(corpus) == jmeteor.derive_function_words(corpus)
    assert meteor.FUNCTION_WORDS == jmeteor.FUNCTION_WORDS
    assert (meteor.ALPHA, meteor.BETA, meteor.GAMMA, meteor.DELTA, meteor.STAGE_WEIGHTS,
            meteor.BEAM_WIDTH, meteor.MAX_PHRASE) == \
        (jmeteor.ALPHA, jmeteor.BETA, jmeteor.GAMMA, jmeteor.DELTA, jmeteor.STAGE_WEIGHTS,
         jmeteor.BEAM_WIDTH, jmeteor.MAX_PHRASE)


# ----------------------------------------------------------------------
# Porter stemmer
# ----------------------------------------------------------------------

_SUFFIXES = ("ing ed ational tional ies ied ness ful ize ization ation ator alism iveness "
             "fulness ousness aliti iviti biliti fulli logi alli bli entli eli ousli icate "
             "ative alize iciti ical al ance ence er ic able ible ant ement ment ent ion ou "
             "ism ate iti ous ive y s sses ss eed ll e ly yy").split()


def _stem_words():
    """Every word of the learnable corpus (its templates at a small shape),
    the metric fixtures and the random corpora, plus seeded English-shaped
    words with the usual suffixes."""
    from s2vt_tpu_torch.data.learnable import TEMPLATES
    words = {w for t in TEMPLATES for w in t.replace("{", " ").replace("}", " ").split()}
    words |= {f"{p}{i}" for p in ("subj", "verb", "obj") for i in range(20)}
    for gts, res in CASES.values():
        for sents in list(gts.values()) + list(res.values()):
            words.update(w for s in sents for w in s.split())
    words |= {w for raw, toks in golden_cases.GOLDEN for w in toks}
    words |= set(("sky skies dying lying tying news innings outing cannings howe proceed "
                  "exceed succeed caresses ponies ties caress cats feed agreed plastered bled "
                  "motoring sing conflated troubled sized hopping tanned falling hissing fizzed "
                  "failing filing happy sky enjoy relational conditional rational valenci "
                  "hesitanci digitizer conformabli radicalli differentli vileli analogousli "
                  "vietnamization predication operator feudalism decisiveness hopefulness "
                  "callousness formaliti sensitiviti sensibiliti triplicate formative "
                  "formalize electriciti electrical hopeful goodness revival allowance "
                  "inference airliner gyroscopic adjustable defensible irritant replacement "
                  "adjustment dependent adoption homologou communism activate angulariti "
                  "homologous effective bowdlerize probate rate cease controll roll geology "
                  "flies dies spied died y by yyyy syzygy toy a I Running").split())
    rng = random.Random(17)
    letters = "bcdfghjklmnpqrstvwxzaeiouy"
    for _ in range(3000):
        stem = "".join(rng.choice(letters) for _ in range(rng.randint(1, 7)))
        words.add(stem + rng.choice(_SUFFIXES) + (rng.choice(_SUFFIXES) if rng.random() < 0.3
                                                  else ""))
    return sorted(words)


def test_porter_stems_equal_nltk():
    nltk_stem = pytest.importorskip("nltk.stem")
    theirs, ours = nltk_stem.PorterStemmer(), PorterStemmer()
    words = _stem_words()
    assert len(words) > 3000
    diff = [(w, ours.stem(w), theirs.stem(w)) for w in words if ours.stem(w) != theirs.stem(w)]
    assert diff == []


def test_meteor_stems_with_the_ports_stemmer():
    al = meteor._Aligner()
    assert isinstance(al.stemmer, PorterStemmer)
    assert al.match_stage("playing", "plays") == 1 and al.match_stage("dog", "cat") == -1


# ----------------------------------------------------------------------
# PTB tokenizer
# ----------------------------------------------------------------------

def _captions(seed, n=300):
    """Punctuated random captions."""
    rng = random.Random(seed)
    words = list(_WORDS) + ["man's", "don't", "it's", "we'll", "they're", "isn't", "cannot",
                            "gonna", "wanna", "cat,", "runs.", "fast!", "really?", "(yes)",
                            "[no]", "{maybe}", "3.88", "3,000", "3:30", "$5", "50%", "a-b",
                            "--", "...", '"hi"', "''", "``", "'tis", "x;", "y:", "&", "@",
                            "“oh", "no,”", "don’t", "‘quoted’", "–", "—", "…", "«a»",
                            "u.s.", "dr.", "Mr.", "A", "Dog", "\n"]
    return [" ".join(rng.choice(words) for _ in range(rng.randint(1, 14))) for _ in range(n)]


TOKEN_CASES = ([raw for raw, _ in golden_cases.GOLDEN] + golden_cases.EMPTYISH
               + native_cases.CASES + _captions(3))


@pytest.fixture(scope="module")
def jax_nltk():
    pytest.importorskip("nltk")
    return JPTBTokenizer(backend="nltk")


def test_auto_tokens_equal_jax_nltk_backend(jax_nltk):
    tok = PTBTokenizer()
    assert tok.backend == "nltk"
    for raw in TOKEN_CASES:
        assert tok._tokenize_line(raw) == jax_nltk._tokenize_line(raw), raw
    caps = {f"v{i}": [{"caption": raw}, raw] for i, raw in enumerate(TOKEN_CASES)}
    assert tok.tokenize(caps) == jax_nltk.tokenize(caps)


@pytest.mark.parametrize("raw,jar_tokens", golden_cases.GOLDEN,
                         ids=[c[0][:24] for c in golden_cases.GOLDEN])
def test_tokens_equal_recorded_jar_tokens(raw, jar_tokens):
    assert PTBTokenizer()._tokenize_line(raw) == jar_tokens


def test_regex_backend_equals_jax_regex_backend():
    ours, theirs = PTBTokenizer(backend="regex"), JPTBTokenizer(backend="regex")
    for raw in TOKEN_CASES:
        assert ours._tokenize_line(raw) == theirs._tokenize_line(raw), raw
    with pytest.raises(ValueError, match="backend"):
        PTBTokenizer(backend="nope")


_NO_NLTK = """
import sys
sys.modules['nltk'] = None
from s2vt_tpu_torch.evaluation.scorer import score_predictions
from s2vt_tpu_torch.metrics import PTBTokenizer, meteor
assert meteor._wordnet_synsets() is None and meteor._Aligner().match_stage('plays', 'playing') == 1
import json
cases = json.loads(sys.stdin.read())
print(json.dumps([PTBTokenizer()._tokenize_line(c) for c in cases]))
"""


def test_tokens_do_not_depend_on_nltk():
    """With nltk blocked the port tokenizes and stems as before."""
    import json
    proc = subprocess.run([sys.executable, "-c", _NO_NLTK], cwd=ROOT, capture_output=True,
                          text=True, input=json.dumps(TOKEN_CASES), timeout=120)
    assert proc.returncode == 0, proc.stderr
    tok = PTBTokenizer()
    assert json.loads(proc.stdout) == [tok._tokenize_line(c) for c in TOKEN_CASES]


@pytest.fixture(scope="module")
def native():
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    return PTBTokenizer(backend="native")


def test_native_tokens_equal_auto(native):
    tok = PTBTokenizer()
    for raw in TOKEN_CASES + _captions(4) + [" ".join(["(don't)"] * 500)]:
        assert native._tokenize_line(raw) == tok._tokenize_line(raw), raw
    assert native.tokenize({"v1": [{"caption": "A man (quickly) can't stop."}]}) == \
        {"v1": ["a man quickly ca n't stop"]}


def test_native_build_is_atomic_and_cached(native):
    """The library is renamed into place from a temporary file, named by
    the source's hash, and not rebuilt when it exists."""
    from s2vt_tpu_torch.utils import native_build
    path = native_build.library_path("s2vt_tokenize")
    assert path.exists() and path.parent == native_build.BUILD_DIR
    mtime = path.stat().st_mtime_ns
    assert native_build.build_native("s2vt_tokenize") == path
    assert path.stat().st_mtime_ns == mtime
    assert not list(path.parent.glob(f"{path.name.split('.')[0]}*.tmp"))


def test_native_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    from s2vt_tpu_torch.utils import native_build
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/broken.cpp"):
        native_build.build_native("broken")
    assert list((tmp_path / "out").iterdir()) == []
