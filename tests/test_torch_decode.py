"""The port's decode harness, checkpoint loader and weight bridge against
s2vt_tpu, on a synthetic corpus and a checkpoint written by the JAX side."""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

from s2vt_tpu.config import Opt as JOpt
from s2vt_tpu.data.dataset import VideoDataset as JDataset
from s2vt_tpu.data.dataset import make_synthetic_corpus as j_make_corpus
from s2vt_tpu.evaluation.decode import CaptionDecoder as JDecoder
from s2vt_tpu.serving.export import _flatten_params
from s2vt_tpu.training.loop import build_model as j_build_model
from s2vt_tpu.utils.torch_import import params_from_torch_state_dict
from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
from s2vt_tpu_torch.evaluation import decode
from s2vt_tpu_torch.models import AttBaseline, S2VT
from s2vt_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from s2vt_tpu_torch.utils import weights

from test_torch_s2vt import make_params

L, FD, H = 6, 16, 24


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    meta = j_make_corpus(str(root), n_videos=23, feat_len=L, feat_dim=FD, seed=3)
    return root, meta


@pytest.fixture(scope="module")
def checkpoint(corpus, tmp_path_factory):
    """A checkpoint directory as the JAX package writes it: its opt.json and
    the //-keyed params.npz of a serving artifact."""
    root, meta = corpus
    opt = JOpt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
               train_length=L, dim_hidden=H, dim_embed=H, feat_dim=FD, seed=5)
    params = make_params(21, vocab=meta["vocab_size"], feat=FD, hid=H, emb=H)
    ckpt = tmp_path_factory.mktemp("ckpt")
    (ckpt / "opt.json").write_text(opt.to_json())
    np.savez(ckpt / "params.npz", **_flatten_params(params))
    return ckpt, opt, params


def test_synthetic_corpus_is_identical_to_jax(corpus, tmp_path):
    root, meta = corpus
    got = make_synthetic_corpus(str(tmp_path), n_videos=23, feat_len=L, feat_dim=FD, seed=3)
    assert {k: v for k, v in got.items() if "file" not in k and "path" not in k} == \
        {k: v for k, v in meta.items() if "file" not in k and "path" not in k}
    for name in ("captions.json", "gts.json"):
        assert json.loads((tmp_path / name).read_text()) == json.loads((root / name).read_text())
    for f in sorted(os.listdir(root / "feats")):
        np.testing.assert_array_equal(np.load(tmp_path / "feats" / f), np.load(root / "feats" / f))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_batches_match_jax(corpus, mode):
    _, meta = corpus
    args = (meta["captions_file"], meta["feat_path"])
    jds, tds = JDataset(*args, max_len=L, mode=mode, seed=2, backend="numpy"), \
        VideoDataset(*args, max_len=L, mode=mode, seed=2)
    assert tds.specials == jds.specials and tds.ix2word == jds.ix2word
    for jb, tb in zip(jds.batches(5, epoch=1), tds.batches(5, epoch=1)):
        for name in ("feats", "labels", "mask", "valid", "ids", "rows"):
            np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))


def test_model_from_checkpoint_loads_jax_files(corpus, checkpoint):
    _, meta = corpus
    ckpt, jopt, params = checkpoint
    opt, model = decode.model_from_checkpoint(str(ckpt), meta["vocab_size"], device="cpu")
    assert opt == Opt(**json.loads(jopt.to_json()))
    assert isinstance(model, S2VT) and model.valid_vocab == meta["vocab_size"]
    got = weights.params_to_jax(model)
    for key, val in weights.flatten_params(params).items():
        np.testing.assert_array_equal(weights.flatten_params(got)[key], val)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_eval_matches_jax_decoder(corpus, checkpoint, use_pallas):
    """Sentences equal JAX's CaptionDecoder on the same weights, including
    the padded last batch (23 clips, batch 10 -> 3 batches per split)."""
    _, meta = corpus
    ckpt, jopt, params = checkpoint
    if use_pallas:
        jopt = jopt.replace(use_pallas=True)
        (ckpt / "opt.json").write_text(jopt.to_json())
    try:
        for mode in ("train", "test"):
            jds = JDataset(meta["captions_file"], meta["feat_path"], max_len=L, mode=mode,
                           seed=jopt.seed, backend="numpy")
            jmodel = j_build_model(jopt, jds.vocab_size, valid_vocab=jds.vocab_size)
            want = JDecoder(jmodel, params, jds).greedy(batch_size=10)
            got = decode.greedy_eval(str(ckpt), batch_size=10, mode=mode, device="cpu")
            assert got == want and len(got) == len(jds)
    finally:
        (ckpt / "opt.json").write_text(jopt.replace(use_pallas=False).to_json())


def test_ids_to_sentence():
    ix2word = {5: "a", 6: "b", 3: "<sos>"}
    assert decode.ids_to_sentence([5, 0, 6, 4, 5], ix2word, eos_ix=4) == "a b"
    assert decode.ids_to_sentence([3, 5, 9], ix2word, eos_ix=4, sos_ix=3) == "a <unk>"


def test_weight_bridge_round_trip_is_exact(tmp_path):
    params = make_params(7, vocab=11, feat=5, hid=6, emb=4)
    model = S2VT(vocab_size=11, feat_dim=5, length=3, dim_hid=6, dim_embed=4)
    model.load_state_dict(weights.params_from_jax(params))
    back = weights.params_to_jax(model)
    flat, flat_back = weights.flatten_params(params), weights.flatten_params(back)
    assert flat.keys() == flat_back.keys()
    for key in flat:
        assert flat_back[key].dtype == flat[key].dtype
        np.testing.assert_array_equal(flat_back[key], flat[key])
    save_checkpoint(str(tmp_path / "ck"), back, Opt().to_json())
    loaded = weights.flatten_params(load_checkpoint(str(tmp_path / "ck")))
    for key in flat:
        np.testing.assert_array_equal(loaded[key], flat[key])
    with np.load(tmp_path / "ck" / "params.npz") as z:
        assert sorted(z.files) == sorted(_flatten_params(params))


def test_reference_state_dict_rename_matches_jax_import():
    torch.manual_seed(0)
    mods = {"vid_rnn": torch.nn.LSTM(6, 6, batch_first=True),
            "word_rnn": torch.nn.LSTM(10, 6, batch_first=True),
            "feat_linear": torch.nn.Linear(5, 6), "out_linear": torch.nn.Linear(6, 11),
            "embedding": torch.nn.Embedding(11, 4)}
    sd = {f"{n}.{k}": v for n, m in mods.items() for k, v in m.state_dict().items()}
    got = weights.params_from_reference_state_dict(sd)
    want = weights.flatten_params(
        {k: {kk: np.asarray(vv) if not isinstance(vv, dict) else
             {a: np.asarray(b) for a, b in vv.items()} for kk, vv in v.items()}
         for k, v in params_from_torch_state_dict(sd).items()})
    assert sorted(k.replace(".", "//") for k in got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k.replace(".", "//")])
    S2VT(vocab_size=11, feat_dim=5, length=3, dim_hid=6, dim_embed=4).load_state_dict(got)
    with pytest.raises(KeyError):
        weights.params_from_reference_state_dict({"vid_rnn.mystery": torch.zeros(1)})


def test_entry_points_without_card_raise(checkpoint, corpus, monkeypatch):
    """device=None means the card: with none present every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, meta = corpus
    ckpt, _, _ = checkpoint
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.greedy_eval(str(ckpt))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.model_from_checkpoint(str(ckpt), meta["vocab_size"])
    ds = VideoDataset(meta["captions_file"], meta["feat_path"], max_len=L, mode="test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.CaptionDecoder(S2VT(ds.vocab_size, FD, L, H, H), ds)
    assert decode.greedy_eval(str(ckpt), device="cpu")


def test_build_model_dispatch():
    from s2vt_tpu_torch.training.loop import build_model
    m = build_model(Opt(compute_dtype="bfloat16", use_pallas=True, dim_hidden=8, dim_embed=8,
                        feat_dim=4, train_length=3), 9)
    assert m.compute_dtype == torch.bfloat16 and m.use_pallas and m.valid_vocab is None
    att = build_model(Opt(model="att_baseline", use_pallas=True, dim_hidden=8, dim_embed=6,
                          feat_dim=4, train_length=3), 9, valid_vocab=7)
    assert isinstance(att, AttBaseline) and att.use_pallas and att.att_mode == "softmax"
    assert (att.dim_hid, att.dim_embed, att.dim_feat, att.length, att.valid_vocab) == (
        8, 6, 4, 3, 7)
    with pytest.raises(ValueError):
        build_model(Opt(model="nope"), 9)
