"""The port's attention baseline against s2vt_tpu's, on the same numpy weights.

Sizes B=8, H=E=128, F=16, L=6, V=32, so that the JAX encoder's Pallas route
engages (``pallas_shapes_ok``; interpret mode on the CPU) when ``use_pallas``
is on. The JAX model decodes with its scan; the port's no-gradient
teacher-forced pass takes the attention-decoder op (its plain version on the
CPU) with ``use_pallas`` in softmax mode, and the per-step loop otherwise.
Tolerances are the JAX package's own: teacher-forced logits 5e-5
(tests/test_attention_parity.py:103), greedy tokens exact (:117), beam
tokens and lengths exact with scores within 1e-5 (tests/test_torch_beam.py),
gradients 2e-3 + 2e-3*|g| (tests/test_pallas_s2vt.py:122), Trainer losses
rtol 1e-4 (tests/test_torch_training.py). Every number is float32.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax
import jax.numpy as jnp

from s2vt_tpu import parallel as jparallel
from s2vt_tpu import training as jtraining
from s2vt_tpu.config import Opt as JOpt
from s2vt_tpu.models import AttBaseline as JAtt
from s2vt_tpu.utils.torch_import import params_from_torch_state_dict
from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
from s2vt_tpu_torch.evaluation import decode
from s2vt_tpu_torch.models import AttBaseline as TAtt
from s2vt_tpu_torch.ops import fused_att_decode
from s2vt_tpu_torch.ops.layers import TorchEmbedding, TorchLinear
from s2vt_tpu_torch.training import Trainer, batch_loss
from s2vt_tpu_torch.utils.weights import (flatten_params, params_from_jax,
                                          params_from_reference_state_dict, params_to_jax)

from test_torch_beam import _assert_same_result
from test_torch_training import small_opt

B, L, F, H, V = 8, 6, 16, 128, 32
E = H
KW = dict(vocab_size=V, dim_feat=F, length=L, dim_hid=H, dim_embed=E, sos_ix=3, eos_ix=4)
ATT_MODES = ["softmax", "reference_sum"]


def make_att_params(seed, vocab=V, feat=F, hid=H, emb=E):
    """A JAX-layout AttBaseline parameter tree drawn with numpy (torch-style
    init; embedding row 0, the padding row, zero)."""
    rng = np.random.default_rng(seed)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def lstm(in_size):
        k = 1.0 / np.sqrt(hid)
        return {"w_ih": u(k, 4 * hid, in_size), "w_hh": u(k, 4 * hid, hid),
                "b_ih": u(k, 4 * hid), "b_hh": u(k, 4 * hid)}

    def linear(out, inp, bias=True):
        k = 1.0 / np.sqrt(inp)
        return {"weight": u(k, out, inp), **({"bias": u(k, out)} if bias else {})}

    table = rng.normal(size=(vocab, emb)).astype(np.float32)
    table[0] = 0.0
    return {"encoder": {"l0": lstm(hid), "l0_reverse": lstm(hid)},
            "decoder": {"l0": lstm(2 * hid + emb)},
            "feat_linear": linear(hid, feat), "embedding": {"weight": table},
            "out_linear": linear(vocab, hid), "att_enc": linear(hid, 2 * hid),
            "att_prev_hid": linear(hid, hid), "att_apply": linear(1, hid, bias=False)}


def port_model(params, **kw):
    m = TAtt(**{**KW, **kw})
    m.load_state_dict(params_from_jax(params))
    return m.eval()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    feats = rng.normal(size=(B, L, F)).astype(np.float32)
    targets = rng.integers(0, V, size=(B, L - 1)).astype(np.int32)
    targets[:, -2:] = 0                              # padding positions
    return make_att_params(20), feats, targets


def _jax_apply(params, feats, targets=None, **kw):
    mode = kw.pop("mode", "train")
    model = JAtt(**{**KW, **{k: v for k, v in kw.items() if k in ("att_mode", "use_pallas")}})
    extra = {k: v for k, v in kw.items() if k not in ("att_mode", "use_pallas")}
    args = (jnp.asarray(feats),) + (() if targets is None else (jnp.asarray(targets),))
    return model.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, *args,
                       mode=mode, **extra)


def test_param_tree_matches_jax(data):
    params, feats, targets = data
    tree = jax.eval_shape(lambda: JAtt(**KW).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(targets), mode="train",
        deterministic=True))["params"]
    want = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32), tree)).items()}
    assert {k: v.shape for k, v in flatten_params(params).items()} == want
    got = {k.replace(".", "//"): tuple(v.shape) for k, v in TAtt(**KW).state_dict().items()}
    assert got == want and "att_apply//bias" not in got


def test_weight_round_trip_is_exact(data):
    params = data[0]
    back = flatten_params(params_to_jax(port_model(params)))
    flat = flatten_params(params)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])


def test_reference_state_dict_loads_strictly():
    """A reference-style Att_Baseline state_dict (nn.LSTM / nn.Linear /
    nn.Embedding keys such as ``encoder.weight_ih_l0_reverse`` and
    ``att_apply.weight``) loads with strict=True and equals JAX's import."""
    torch.manual_seed(0)
    h, e, f, v = 6, 5, 4, 11
    mods = {"encoder": torch.nn.LSTM(h, h, batch_first=True, bidirectional=True),
            "decoder": torch.nn.LSTM(2 * h + e, h, batch_first=True),
            "feat_linear": torch.nn.Linear(f, h), "embedding": torch.nn.Embedding(v, e, 0),
            "out_linear": torch.nn.Linear(h, v), "att_enc": torch.nn.Linear(2 * h, h),
            "att_prev_hid": torch.nn.Linear(h, h), "att_apply": torch.nn.Linear(h, 1, bias=False)}
    sd = {f"{n}.{k}": t for n, m in mods.items() for k, t in m.state_dict().items()}
    assert "encoder.weight_ih_l0_reverse" in sd and "att_apply.weight" in sd
    got = params_from_reference_state_dict(sd)
    model = TAtt(v, f, 3, h, e)
    model.load_state_dict(got, strict=True)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, params_from_torch_state_dict(sd)))
    assert sorted(k.replace(".", "//") for k in got) == sorted(want)
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k.replace(".", "//")])


def test_padding_row_is_zero_and_gets_no_gradient():
    emb = TorchEmbedding(7, 3, padding_idx=0)
    emb.reset_parameters(torch.Generator().manual_seed(1))
    assert (emb.weight[0] == 0).all() and (emb.weight[1:] != 0).all()
    emb(torch.tensor([[0, 2, 0], [3, 0, 1]])).square().sum().backward()
    assert (emb.weight.grad[0] == 0).all() and (emb.weight.grad[2] != 0).all()
    lin = TorchLinear(1, 4, use_bias=False)
    assert lin.bias is None and list(lin.state_dict()) == ["weight"]


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("att_mode", ATT_MODES)
def test_teacher_forced_logits_match_jax(data, att_mode, use_pallas, grad, monkeypatch):
    """Within 5e-5 of JAX's scan on both routes: with a gradient the
    per-step loop; under no_grad with use_pallas in softmax mode the
    attention-decoder op, once."""
    params, feats, targets = data
    want = _jax_apply(params, feats, targets, att_mode=att_mode, use_pallas=use_pallas,
                      deterministic=True)
    calls = []
    plain = fused_att_decode.att_decode_fwd
    monkeypatch.setattr(fused_att_decode, "att_decode_fwd",
                        lambda *a: calls.append(1) or plain(*a))
    model = port_model(params, att_mode=att_mode, use_pallas=use_pallas)
    with torch.set_grad_enabled(grad):
        got = model(torch.from_numpy(feats), torch.from_numpy(targets).long(), mode="train",
                    deterministic=True)
    assert got.requires_grad == grad and tuple(got.shape) == (B, L - 1, V)
    assert len(calls) == int(use_pallas and att_mode == "softmax" and not grad)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("att_mode", ATT_MODES)
def test_greedy_tokens_match_jax(data, att_mode, use_pallas):
    params, feats, _ = data
    want = np.asarray(_jax_apply(params, feats, mode="test", att_mode=att_mode,
                                 use_pallas=use_pallas))
    got = port_model(params, att_mode=att_mode, use_pallas=use_pallas)(
        torch.from_numpy(feats), mode="test")
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("att_mode, score_mode", [("softmax", "cumulative"),
                                                  ("softmax", "reference"),
                                                  ("reference_sum", "cumulative")])
def test_beam_matches_jax(data, att_mode, score_mode):
    params, feats, _ = data
    kw = dict(beam_width=3, max_beam_depth=7, beam_score_mode=score_mode)
    want = _jax_apply(params, feats, mode="beam_search", att_mode=att_mode, use_pallas=True,
                      **kw)
    got = port_model(params, att_mode=att_mode, use_pallas=True)(
        torch.from_numpy(feats), mode="beam_search", **kw)
    assert tuple(got.tokens.shape) == (B, 3, 8) and (got.tokens[:, :, 0] == 3).all()
    _assert_same_result(got, want)


def test_beam_width1_reproduces_greedy_prefixes(data):
    """Beam width 1 follows the greedy argmax (tests/test_attention_parity.py:120)."""
    model = port_model(data[0])
    feats = torch.from_numpy(data[1])
    greedy = model.greedy(feats).numpy()
    res = model.beam(feats, beam_width=1, max_depth=L)
    toks, lens = res.tokens[:, 0, 1:].numpy(), res.lengths[:, 0].numpy()
    for b in range(B):
        n = min(lens[b] - 1, L)
        np.testing.assert_array_equal(toks[b, :n], greedy[b, :n])


def test_forward_rejects_unknown_modes(data):
    with pytest.raises(ValueError, match="att_mode"):
        TAtt(**KW, att_mode="dot")
    with pytest.raises(ValueError, match="unknown mode"):
        port_model(data[0])(torch.from_numpy(data[1]), mode="beam")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("att_mode", ATT_MODES)
def test_masked_loss_gradients_match_jax(data, att_mode, use_pallas):
    """Gradients of the masked loss in every parameter against jax.grad
    within 2e-3 + 2e-3*|g|; with use_pallas the encoder's backward runs the
    sequence op's backward (the Pallas kernels on the JAX side). The
    padding row of the embedding gets none on either side."""
    params, feats, targets = data
    rng = np.random.default_rng(22)
    labels = np.concatenate([np.full((B, 1), 3, np.int32), targets], axis=1)
    mask = (np.arange(L)[None, :] < rng.integers(3, L + 1, size=(B, 1))).astype(np.float32)
    valid = np.ones(B, np.float32)

    def jloss(p):
        logits = _jax_apply(p, feats, targets, att_mode=att_mode, use_pallas=use_pallas,
                            deterministic=True)
        return jtraining.loop.batch_loss(logits, *map(jnp.asarray, (labels, mask, valid)))

    want = flatten_params(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    model = port_model(params, att_mode=att_mode, use_pallas=use_pallas)
    logits = model(torch.from_numpy(feats), torch.from_numpy(targets).long(), mode="train",
                   deterministic=True)
    batch_loss(logits, *map(torch.from_numpy, (labels.astype(np.int64), mask, valid))).backward()
    # Under reference_sum the attention weights reach no output: torch leaves
    # their .grad unset where JAX gives zeros.
    got = {k.replace(".", "//"): (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, rtol=2e-3, err_msg=k)
    assert (got["embedding//weight"][0] == 0).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """32 clips: 16 train (two batches of 8), 8 valid, 8 test."""
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(str(root), n_videos=32, vocab_extra=20, feat_len=L,
                                 feat_dim=F, seed=5)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_follows_jax_trainer(corpus, tmp_path, use_pallas, masked):
    """Two epochs of model='att_baseline' from the JAX Trainer's initial
    weights: per-epoch train and valid losses and the lr history within rtol
    1e-4. With use_pallas the validation pass runs the attention-decoder op
    (the JAX model its scan) and the encoder the sequence op."""
    kw = dict(model="att_baseline", use_pallas=use_pallas, masked_loss=masked,
              async_checkpoint=False)
    jopt = JOpt(**json.loads(small_opt(corpus, tmp_path / "jax", **kw).to_json()))
    jtr = jtraining.Trainer(jopt.replace(mesh_shape=(1, 1)), mesh=jparallel.make_mesh((1, 1)),
                            writer=None)
    init = jax.device_get(jtr.params)
    want = jtr.fit(epochs=2)

    tr = Trainer(small_opt(corpus, tmp_path / "port", **kw), device="cpu")
    assert isinstance(tr.model, TAtt) and tr.model.use_pallas == use_pallas
    tr.model.load_state_dict(params_from_jax(init))
    got = tr.fit(epochs=2)
    for key in ("train_loss", "valid_loss", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got["train_loss"][-1] < got["train_loss"][0]


def test_cli_trains_and_checkpoint_decodes_on_cpu(corpus, tmp_path, capsys):
    """cli.train --model att_baseline --device cpu writes a final checkpoint;
    greedy_eval and beam_eval decode it (attention rows are L wide)."""
    from s2vt_tpu_torch.cli.train import main
    cfg = tmp_path / "opt.json"
    cfg.write_text(small_opt(corpus, tmp_path, dim_hidden=16, dim_embed=16).to_json())
    tr = main(["--config", str(cfg), "--device", "cpu", "--model", "att_baseline",
               "--EPOCHS", "2", "--use_pallas", "true", "--lr", "0.01"])
    assert isinstance(tr.model, TAtt) and tr.opt.model == "att_baseline"
    assert "finished after 2 epochs" in capsys.readouterr().out
    final = os.path.join(tr.opt.save_path, tr.opt.start_time + "final")
    _, model = decode.model_from_checkpoint(final, tr.train_ds.vocab_size, device="cpu")
    assert isinstance(model, TAtt) and model.use_pallas
    n_test = len(tr.train_ds.splits["test"])
    for preds in (decode.greedy_eval(final, batch_size=B, device="cpu"),
                  decode.beam_eval(final, batch_size=B, beam_width=2, max_beam_depth=5,
                                   device="cpu")):
        assert len(preds) == n_test and all(isinstance(s, str) for s in preds.values())
