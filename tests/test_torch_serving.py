"""The port's serving artifacts (serving/export.py, cli/export_serving.py):
an exported program replays the model's own decode, and JAX's artifact's.

Sizes are small (V=32, F=12, L=8, H=E=16, B=4) and beam depth 5, so that
each export traces in seconds. Tokens must be equal exactly: the program
runs the same operations as the model on the same device (the CPU in these tests,
with the plain versions of the kernels the model was built with). The JAX
artifact (tests/test_serving_export.py's) is replayed on the same weights
and features; its tokens must equal the port's too. ``quantize_feats`` must
be bit-equal to JAX's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax
import jax.numpy as jnp

from s2vt_tpu.models import S2VT as JS2VT
from s2vt_tpu.serving import ServingCaptioner as JServing
from s2vt_tpu.serving import export_captioner as jexport
from s2vt_tpu.serving import quantize_feats as jquantize
from s2vt_tpu_torch.models import AttBaseline, S2VT
from s2vt_tpu_torch.serving import ServingCaptioner, export_captioner, quantize_feats
from s2vt_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, F, L, H, E, B = 32, 12, 8, 16, 16, 4
SPECIALS = {"pad_ix": 0, "unk_ix": 1, "sos_ix": 3, "eos_ix": 4}
IX2WORD = {i: f"w{i}" for i in range(V)}
KW = dict(vocab_size=V, feat_dim=F, length=L, dim_hid=H, dim_embed=E, sos_ix=3, eos_ix=4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX params and features (tests/test_serving_export.py's), the port
    model on the same weights with use_pallas, and an artifact root."""
    jmodel = JS2VT(**KW)
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, L, F)), np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(feats), mode="test")["params"]
    model = S2VT(**KW, use_pallas=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, model.eval(), feats, tmp_path_factory.mktemp("artifacts")


@pytest.fixture(scope="module")
def greedy_dir(setup):
    _, _, model, _, root = setup
    return export_captioner(model, IX2WORD, SPECIALS, B, root / "greedy", mode="greedy")


def test_greedy_round_trip_equals_model_and_jax_artifact(setup, greedy_dir):
    jmodel, params, model, feats, root = setup
    srv = ServingCaptioner(greedy_dir)
    got = srv.decode_tokens(feats)
    np.testing.assert_array_equal(got, model.greedy(torch.from_numpy(feats)).numpy())
    jart = JServing(jexport(jmodel, params, IX2WORD, SPECIALS, B, root / "jax_greedy",
                            mode="greedy"))
    np.testing.assert_array_equal(got, jart.decode_tokens(feats))
    assert srv.caption(feats) == jart.caption(feats)
    manifest = json.loads((greedy_dir / "manifest.json").read_text())
    assert {"mode", "batch_size", "length", "feat_dim", "feats_dtype", "ix2word", "specials",
            "beam", "torch_version", "device"} <= set(manifest)
    assert (manifest["mode"], manifest["batch_size"], manifest["device"]) == ("greedy", B, "cpu")


def test_beam_round_trip_equals_model_and_jax_artifact(setup):
    """The exported beam runs all its rounds (no host sync); its best beam's
    tokens equal S2VT.beam's, which stops once every beam has finished, and
    the JAX artifact's."""
    jmodel, params, model, feats, root = setup
    out = export_captioner(model, IX2WORD, SPECIALS, B, root / "beam", mode="beam",
                           beam_width=3, max_beam_depth=5)
    got = ServingCaptioner(out).decode_tokens(feats)
    want = model.beam(torch.from_numpy(feats), 3, 5).tokens[:, 0].numpy()
    np.testing.assert_array_equal(got, want)
    jart = JServing(jexport(jmodel, params, IX2WORD, SPECIALS, B, root / "jax_beam",
                            mode="beam", beam_width=3, max_beam_depth=5))
    np.testing.assert_array_equal(got, jart.decode_tokens(feats))


@pytest.mark.parametrize("depth", [2, 12])
def test_fixed_step_beam_equals_the_stopping_search(setup, depth, monkeypatch):
    """beam_search's fixed-round loop, what the export holds, gives the same
    tokens, lengths and scores as the loop that stops when every beam has
    finished, whether it stops early (depth 12) or not (depth 2)."""
    _, _, model, feats, _ = setup
    x = torch.from_numpy(feats)
    a = model.beam(x, 3, depth)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    b = model.beam(x, 3, depth)
    for got, want in zip(b, a):
        assert torch.equal(got, want)


def test_dynamic_batch_and_ragged_padding(setup, greedy_dir):
    _, _, model, feats, root = setup
    srv = ServingCaptioner(greedy_dir)
    full = srv.caption(feats)
    assert srv.caption(feats[:3]) == full[:3]          # zero-padded to B = 4
    with pytest.raises(ValueError, match="exceeds exported size"):
        srv.caption(np.concatenate([feats, feats]))
    poly = ServingCaptioner(export_captioner(model, IX2WORD, SPECIALS, None, root / "poly"))
    assert poly.batch_size is None
    for n in (1, 3, 7):
        x = np.concatenate([feats, feats])[:n]
        np.testing.assert_array_equal(poly.decode_tokens(x),
                                      model.greedy(torch.from_numpy(x)).numpy())


def test_bf16_and_int8_feature_artifacts(setup):
    jmodel, params, model, feats, root = setup
    bf = ServingCaptioner(export_captioner(model, IX2WORD, SPECIALS, B, root / "bf16",
                                           feats_dtype="bfloat16"))
    x16 = torch.from_numpy(feats).to(torch.bfloat16).float()
    np.testing.assert_array_equal(bf.decode_tokens(feats), model.greedy(x16).numpy())
    q8 = ServingCaptioner(export_captioner(model, IX2WORD, SPECIALS, B, root / "int8",
                                           feats_dtype="int8"))
    assert q8.manifest["quant"] == {"strategy": "per_clip_absmax", "levels": 127}
    q, scale = quantize_feats(feats)
    deq = torch.from_numpy(q).float() * torch.from_numpy(scale)[:, None, None]
    np.testing.assert_array_equal(q8.decode_tokens(feats), model.greedy(deq).numpy())
    with pytest.raises(TypeError, match="float array"):
        q8.decode_tokens(q)
    jq8 = JServing(jexport(jmodel, params, IX2WORD, SPECIALS, B, root / "jax_int8",
                           feats_dtype=jnp.int8))
    np.testing.assert_array_equal(q8.decode_tokens(feats), jq8.decode_tokens(feats))


def test_quantize_feats_is_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, 9)).astype(np.float32) * rng.uniform(0.1, 10, (5, 1, 1))
    x[2] = 0.0                                     # an all-zero clip: scale 1
    x[3, 0, 0] = 127 * 3.3                         # absmax / scale just around 127
    for a, b in zip(quantize_feats(x), jquantize(x)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_attention_baseline_artifact(setup):
    _, _, _, feats, root = setup
    model = AttBaseline(V, F, L, H, E, use_pallas=True).eval()
    model.reset_parameters(torch.Generator().manual_seed(5))
    srv = ServingCaptioner(export_captioner(model, IX2WORD, SPECIALS, B, root / "att"))
    np.testing.assert_array_equal(srv.decode_tokens(feats),
                                  model.greedy(torch.from_numpy(feats)).numpy())


def test_timed_decode_returns_the_tokens_and_its_phases(setup, greedy_dir):
    _, _, _, feats, _ = setup
    srv = ServingCaptioner(greedy_dir)
    toks, timings = srv.decode_tokens_timed(feats)
    np.testing.assert_array_equal(toks, srv.decode_tokens(feats))
    assert set(timings) == {"h2d_ms", "exec_ms", "d2h_ms", "device_ms"}
    assert all(v >= 0.0 for v in timings.values())
    assert timings["device_ms"] == pytest.approx(timings["exec_ms"] + timings["d2h_ms"])


def test_artifact_replays_without_the_model_code(greedy_dir, setup):
    """A fresh process loads the artifact and captions with no module of
    s2vt_tpu_torch.models (or JAX) imported."""
    feats = setup[3]
    np.save(greedy_dir / "feats.npy", feats)
    probe = (
        "import sys, numpy as np\n"
        "sys.modules['jax'] = None\n"
        "from s2vt_tpu_torch.serving import ServingCaptioner\n"
        f"srv = ServingCaptioner({str(greedy_dir)!r})\n"
        f"print(srv.caption(np.load({str(greedy_dir / 'feats.npy')!r})))\n"
        "print(sorted(m for m in sys.modules if m.startswith('s2vt_tpu_torch.models')))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    sents, models = proc.stdout.strip().splitlines()
    assert models == "[]"
    assert eval(sents) == ServingCaptioner(greedy_dir).caption(feats)


def test_export_cli_flags(tmp_path):
    """cli/export_serving on a checkpoint: --batch poly, --beam with its
    width and depth, --feats_dtype, --device; the manifest records them."""
    from s2vt_tpu_torch.cli import export_serving
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.training import build_model, save_checkpoint
    from s2vt_tpu_torch.utils.weights import params_to_jax
    meta = make_synthetic_corpus(str(tmp_path), n_videos=8, feat_len=6, feat_dim=8, seed=2)
    opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"], train_length=6,
              dim_hidden=16, dim_embed=16, feat_dim=8, use_pallas=True)
    model = build_model(opt, meta["vocab_size"])
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), params_to_jax(model), opt.to_json())
    out = export_serving.main(["--model_path", ckpt, "--out", str(tmp_path / "a"), "--batch",
                               "poly", "--beam", "--beam_width", "2", "--max_beam_depth", "2",
                               "--feats_dtype", "bfloat16", "--device", "cpu"])
    man = json.loads((out / "manifest.json").read_text())
    assert (man["mode"], man["batch_size"], man["feats_dtype"], man["device"]) == \
        ("beam", None, "bfloat16", "cpu")
    assert man["beam"] == {"width": 2, "max_depth": 2, "score_mode": "cumulative"}
    assert ServingCaptioner(out).decode_tokens(np.zeros((3, 6, 8), np.float32)).shape == (3, 3)
    with pytest.raises(SystemExit):
        export_serving.main(["--model_path", ckpt, "--out", str(tmp_path / "b"),
                             "--feats_dtype", "float64", "--device", "cpu"])
