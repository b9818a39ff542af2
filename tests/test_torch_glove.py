"""The port's GloVe warm start against s2vt_tpu's, on the CPU.

``load_glove_embeddings`` is bit-equal to JAX's, cache JSON included; a port
Trainer with ``Opt.glove_path`` starts with the JAX Trainer's embedding rows;
a padded vocabulary's extra rows keep their init; a width mismatch raises.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.data.glove import load_glove_embeddings, warm_start_embedding
from s2vt_tpu_torch.models import S2VT

from test_torch_training import L, small_opt

jglove = pytest.importorskip("s2vt_tpu.data.glove")


def _write_glove(path, words, dim, seed=0):
    """A GloVe text file: one line per word, ``dim`` values of 5 decimals."""
    rng = np.random.default_rng(seed)
    vecs = {}
    with open(path, "w", encoding="utf-8") as f:
        for w in words:
            v = rng.normal(size=dim)
            vecs[w] = v
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    return vecs


@pytest.mark.parametrize("seed", [0, 3])
def test_table_and_cache_equal_jax(tmp_path, seed):
    dim = 6
    word2ix = {"<pad>": 0, "<unk>": 1, "dog": 2, "cat": 3, "zzz": 4, "café": 5}
    tables = {}
    for name, load in (("port", load_glove_embeddings), ("jax", jglove.load_glove_embeddings)):
        d = tmp_path / name
        d.mkdir()
        vecs = _write_glove(d / "glove.txt", ["dog", "bird", "cat", "café"], dim)
        tables[name] = load(str(d / "glove.txt"), word2ix, dim, seed=seed)
        # the second load reads the cache next to the file
        np.testing.assert_array_equal(load(str(d / "glove.txt"), word2ix, dim, seed=seed),
                                      tables[name])
    assert tables["port"].dtype == tables["jax"].dtype == np.float32
    np.testing.assert_array_equal(tables["port"], tables["jax"])
    assert (tmp_path / "port" / "word2embed.json").read_bytes() == \
        (tmp_path / "jax" / "word2embed.json").read_bytes()
    assert set(json.loads((tmp_path / "port" / "word2embed.json").read_text())) == \
        {"dog", "cat", "café"}
    np.testing.assert_allclose(tables["port"][2], vecs["dog"], atol=1e-5)
    bound = np.sqrt(6.0 / (len(word2ix) + dim))
    assert np.abs(tables["port"][4]).max() <= bound + 1e-6    # 'zzz' keeps its init


def test_padded_vocab_rows_keep_their_init(tmp_path):
    _write_glove(tmp_path / "glove.txt", ["w1", "w3"], 16)
    model = S2VT(vocab_size=12, feat_dim=8, length=L, dim_hid=16, dim_embed=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    before = model.embedding.weight.detach().clone()
    word2ix = {"<pad>": 0, "<unk>": 1, "w1": 2, "w2": 3, "w3": 4}
    table = warm_start_embedding(model, str(tmp_path / "glove.txt"), word2ix, seed=2)
    after = model.embedding.weight.detach()
    np.testing.assert_array_equal(after[:5].numpy(), table)
    np.testing.assert_array_equal(after[5:].numpy(), before[5:].numpy())
    np.testing.assert_array_equal(
        table, jglove.load_glove_embeddings(str(tmp_path / "glove.txt"), word2ix, 16, seed=2))


def test_dimension_mismatch_raises(tmp_path):
    _write_glove(tmp_path / "glove.txt", ["dog"], 5)
    with pytest.raises(ValueError, match="GloVe dim 5 != dim_embed 6"):
        load_glove_embeddings(str(tmp_path / "glove.txt"), {"<pad>": 0, "dog": 1}, 6)


def test_trainer_warm_start_equals_the_jax_trainers(tmp_path):
    """The embedding rows a port Trainer starts with equal the JAX Trainer's
    params["embedding"]["weight"][:V] (the vocabulary padded to 32 rows;
    the rest keep their init), for GloVe words inside and outside it."""
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.training import Trainer
    jax = importlib.import_module("jax")
    jconfig = importlib.import_module("s2vt_tpu.config")
    jtraining = importlib.import_module("s2vt_tpu.training")
    jparallel = importlib.import_module("s2vt_tpu.parallel")
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_videos=32, vocab_extra=20,
                                   feat_len=L, feat_dim=16, seed=5)
    words = ["w0", "w3", "w7", "outside", "w19", "<eos>"]
    glove = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        glove[name] = _write_glove(tmp_path / name / "glove.txt", words, 128, seed=9)
    opt = small_opt(corpus, tmp_path / "port", glove_path=str(tmp_path / "port" / "glove.txt"))
    tr = Trainer(opt, device="cpu", writer=None)
    jopt = jconfig.Opt(**json.loads(opt.replace(
        glove_path=str(tmp_path / "jax" / "glove.txt")).to_json()))
    jtr = jtraining.Trainer(jopt.replace(mesh_shape=(1, 1)), mesh=jparallel.make_mesh((1, 1)),
                            writer=None)
    V = tr.train_ds.vocab_size
    want = np.asarray(jax.device_get(jtr.params["embedding"]["weight"]))[:V]
    got = tr.model.embedding.weight.detach().numpy()
    assert tr.vocab_size == 32 > V
    np.testing.assert_array_equal(got[:V], want)
    ix = tr.train_ds.word2ix
    for w in ("w0", "w3", "<eos>"):
        np.testing.assert_array_equal(
            got[ix[w]], np.array([float(f"{x:.5f}") for x in glove["port"][w]], np.float32))
