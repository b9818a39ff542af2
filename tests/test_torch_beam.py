"""The port's beam search against s2vt_tpu/models/beam.py and the JAX S2VT.

The search is held to JAX's exactly: on the same step function, tokens and
lengths equal and scores within 1e-5 (float32 log-softmax in two frameworks,
the same operations); on the same S2VT weights, tokens and lengths equal on
the scan route and on the kernel route (the port's plain sequence op against
JAX's Pallas kernel in interpret mode, at B=8, H=128 so that both engage);
``beam_eval`` gives JAX's sentences. Every number is float32.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax
import jax.numpy as jnp

from s2vt_tpu.config import Opt as JOpt
from s2vt_tpu.data.dataset import VideoDataset as JDataset
from s2vt_tpu.data.dataset import make_synthetic_corpus as j_make_corpus
from s2vt_tpu.evaluation.decode import CaptionDecoder as JDecoder
from s2vt_tpu.models import S2VT as JS2VT
from s2vt_tpu.models import beam as jbeam
from s2vt_tpu.serving.export import _flatten_params
from s2vt_tpu.training.loop import build_model as j_build_model
from s2vt_tpu_torch.data.dataset import VideoDataset
from s2vt_tpu_torch.evaluation import decode
from s2vt_tpu_torch.models import S2VT as TS2VT
from s2vt_tpu_torch.models import beam as tbeam
from s2vt_tpu_torch.ops import fused_rnn
from s2vt_tpu_torch.utils.weights import params_from_jax

from test_torch_s2vt import KW, B, L, F, V, make_params, port_model

SCORE_MODES = ["cumulative", "reference"]


def _step_fns(seed, vocab, hid, eos_boost=0.0, eos_ix=4):
    """One random 'language model' (tests/test_beam_oracle.py) written in
    both frameworks from the same numpy weights: state [N, hid]; the next
    token's log-probs depend on the state and the last word."""
    rng = np.random.default_rng(seed)
    w = (0.8 * rng.normal(size=(hid, hid))).astype(np.float32)
    e = (0.8 * rng.normal(size=(vocab, hid))).astype(np.float32)
    o = rng.normal(size=(hid, vocab)).astype(np.float32)
    boost = np.where(np.arange(vocab) == eos_ix, eos_boost, 0.0).astype(np.float32)

    def jstep(state, words):
        new = jnp.tanh(state @ w + jnp.asarray(e)[words])
        return new, jax.nn.log_softmax(jax.nn.log_softmax(new @ o, axis=-1) + boost, axis=-1)

    tw, te, to, tb = map(torch.from_numpy, (w, e, o, boost))

    def tstep(state, words):
        new = torch.tanh(state @ tw + te[words])
        return new, torch.log_softmax(torch.log_softmax(new @ to, dim=-1) + tb, dim=-1)

    return jstep, tstep


def _assert_same_result(got: tbeam.BeamResult, want):
    assert got.tokens.dtype == got.lengths.dtype == torch.int32
    assert got.scores.dtype == torch.float32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eos_boost", [0.0, 2.5])
@pytest.mark.parametrize("score_mode", SCORE_MODES)
def test_beam_search_matches_jax(seed, eos_boost, score_mode):
    """Width 3 over 13 words, depth 10; with the <eos>-biased model, beams
    finish, freeze and stop the search early (tokens past the stop keep
    <sos> in both)."""
    vocab, hid, n = 13, 6, 4
    jstep, tstep = _step_fns(seed, vocab, hid, eos_boost)
    init = np.random.default_rng(seed + 50).normal(size=(n, hid)).astype(np.float32)
    kw = dict(sos_ix=3, eos_ix=4, vocab_size=vocab, beam_width=3, max_depth=10,
              score_mode=score_mode)
    want = jbeam.beam_search(jstep, jnp.asarray(init), **kw)
    got = tbeam.beam_search(tstep, torch.from_numpy(init), **kw)
    _assert_same_result(got, want)
    if eos_boost:
        assert (got.lengths[:, 0] < 11).all() and (got.tokens[..., -1] == 3).any()


@pytest.mark.parametrize("width, expand_k", [(4, 2), (9, 20)])
def test_beam_search_matches_jax_masked_and_wide(width, expand_k):
    """expand_k below the width masks each node's expansion; a width above 8
    takes the sorted top-k instead of the argmax passes."""
    vocab, hid = 17, 5
    jstep, tstep = _step_fns(7, vocab, hid, eos_boost=1.0)
    init = np.random.default_rng(8).normal(size=(3, hid)).astype(np.float32)
    kw = dict(sos_ix=3, eos_ix=4, vocab_size=vocab, beam_width=width, max_depth=7,
              expand_k=expand_k)
    _assert_same_result(tbeam.beam_search(tstep, torch.from_numpy(init), **kw),
                        jbeam.beam_search(jstep, jnp.asarray(init), **kw))


@pytest.mark.parametrize("seed", range(4))
def test_topk_small_equals_lax_topk(seed):
    """Values and indices of lax.top_k, ties broken toward the lower index,
    for the argmax passes (k <= 8) and the stable sort (k > 8)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 37)).astype(np.float32)
    x[:, 10] = x[:, 3]
    x[:, 20] = x[:, 3]
    x[0, :] = 1.0                    # a fully tied row
    x[1, ::2] = -1e30                # NEG_INF ties, as dead beam slots
    for k in (1, 3, 8, 9, 20):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tbeam._topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        if k <= 8:
            small_v, small_i = tbeam._topk_small(torch.from_numpy(x), k)
            np.testing.assert_array_equal(small_i.numpy(), np.asarray(want_i))


def test_state_tiling_and_gathering_match_jax():
    rng = np.random.default_rng(9)
    states = ([rng.normal(size=(2, 3)).astype(np.float32)],
              rng.integers(0, 9, size=(2, 4)).astype(np.int32))
    parent = np.array([[2, 0, 0], [1, 2, 1]])
    want = jbeam._gather_states(jbeam._tile_states(jax.tree_util.tree_map(
        jnp.asarray, states), 3), jnp.asarray(parent))
    got = tbeam._gather_states(tbeam._tile_states(jax.tree_util.tree_map(
        torch.from_numpy, states), 3), torch.from_numpy(parent))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def s2vt_data():
    rng = np.random.default_rng(12)
    return make_params(13), rng.normal(size=(B, L, F)).astype(np.float32)


def _jax_beam(model, params, feats, **kw):
    return model.apply({"params": params}, jnp.asarray(feats), mode="beam_search", **kw)


@pytest.mark.parametrize("score_mode", SCORE_MODES)
@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_s2vt_beam_matches_jax(s2vt_data, route, score_mode, monkeypatch):
    """S2VT.beam on the same weights: tokens and lengths equal, scores within
    1e-5. On the kernel route the encode runs the sequence op once per RNN."""
    params, feats = s2vt_data
    kernel = route == "kernel"
    kw = dict(beam_width=3, max_beam_depth=8, beam_score_mode=score_mode)
    want = _jax_beam(JS2VT(use_pallas=kernel, **KW), params, feats, **kw)
    calls = []
    plain = fused_rnn.lstm_seq_fwd
    monkeypatch.setattr(fused_rnn, "lstm_seq_fwd", lambda *a: calls.append(1) or plain(*a))
    got = port_model(params, use_pallas=kernel)(torch.from_numpy(feats), mode="beam_search",
                                                **kw)
    assert len(calls) == (2 if kernel else 0)
    assert tuple(got.tokens.shape) == (B, 3, 9) and (got.tokens[:, :, 0] == 3).all()
    _assert_same_result(got, want)


def test_s2vt_beam_stops_early_like_jax(s2vt_data):
    """<eos> likely: every beam finishes before the depth limit, on both
    sides at the same round."""
    params, feats = s2vt_data
    bias = np.where(np.arange(V) == 4, 4.0, 0.0).astype(np.float32)
    params = {**params, "out_linear": {**params["out_linear"],
                                       "bias": params["out_linear"]["bias"] + bias}}
    kw = dict(beam_width=3, max_beam_depth=12)
    want = _jax_beam(JS2VT(**KW), params, feats, **kw)
    got = port_model(params)(torch.from_numpy(feats), mode="beam_search", **kw)
    _assert_same_result(got, want)
    assert (got.tokens[..., -1] == 3).all()


@pytest.mark.parametrize("config", ["lstm_two_layers_kernel", "gru_scan"])
def test_s2vt_beam_other_cells_match_jax(config):
    """A 2-layer LSTM S2VT on the kernel route (each layer through the
    sequence op) and a GRU S2VT on the scan route."""
    gru = config == "gru_scan"
    kw = dict(KW, num_layers=1 if gru else 2, rnn_type="gru" if gru else "lstm",
              use_pallas=not gru)
    feats = np.random.default_rng(14).normal(size=(B, L, F)).astype(np.float32)
    jm = JS2VT(**kw)
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(15), jnp.asarray(feats), mode="test")["params"])
    want = _jax_beam(jm, params, feats, beam_width=3, max_beam_depth=6)
    tm = TS2VT(**kw)
    tm.load_state_dict(params_from_jax(params))
    got = tm.eval()(torch.from_numpy(feats), mode="beam_search", beam_width=3,
                    max_beam_depth=6)
    _assert_same_result(got, want)


@pytest.fixture(scope="module")
def beam_checkpoint(tmp_path_factory):
    """A corpus and a checkpoint directory as the JAX package writes them."""
    root = tmp_path_factory.mktemp("corpus")
    meta = j_make_corpus(str(root), n_videos=23, feat_len=6, feat_dim=16, seed=4)
    opt = JOpt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
               train_length=6, dim_hidden=24, dim_embed=24, feat_dim=16, seed=5)
    params = make_params(22, vocab=meta["vocab_size"], feat=16, hid=24, emb=24)
    ckpt = tmp_path_factory.mktemp("ckpt")
    (ckpt / "opt.json").write_text(opt.to_json())
    np.savez(ckpt / "params.npz", **_flatten_params(params))
    return str(ckpt), meta, opt, params


@pytest.mark.parametrize("score_mode", SCORE_MODES)
def test_beam_eval_matches_jax_decoder(beam_checkpoint, score_mode):
    """Identical sentences to JAX's CaptionDecoder.beam over both splits,
    including the padded last batch (23 clips, batch 10)."""
    ckpt, meta, opt, params = beam_checkpoint
    for mode in ("train", "test"):
        jds = JDataset(meta["captions_file"], meta["feat_path"], max_len=6, mode=mode,
                       seed=opt.seed, backend="numpy")
        jmodel = j_build_model(opt, jds.vocab_size, valid_vocab=jds.vocab_size)
        want = JDecoder(jmodel, params, jds, beam_width=3, max_beam_depth=7,
                        beam_score_mode=score_mode).beam(batch_size=10)
        got = decode.beam_eval(ckpt, batch_size=10, beam_width=3, max_beam_depth=7, mode=mode,
                               beam_score_mode=score_mode, device="cpu")
        assert got == want and len(got) == len(jds)


def test_beam_entry_points_without_card_raise(beam_checkpoint, monkeypatch):
    """device=None means the card: without one, beam_eval and the decoder
    raise instead of running on the CPU."""
    ckpt, meta, _, _ = beam_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.beam_eval(ckpt)
    ds = VideoDataset(meta["captions_file"], meta["feat_path"], max_len=6, mode="test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.CaptionDecoder(TS2VT(ds.vocab_size, 16, 6, 24, 24), ds, beam_width=2)
    preds = decode.CaptionDecoder(TS2VT(ds.vocab_size, 16, 6, 24, 24), ds, device="cpu",
                                  beam_width=2, max_beam_depth=4).beam(batch_size=10)
    assert len(preds) == len(ds)
