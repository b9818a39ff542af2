"""The port's extraction front end against s2vt_tpu's: frame sampling and
preprocessing (extract/preprocess.py), the backbones (extract/backbones.py)
on carried weights, and the checkpoint loader (extract/torch_weights.py).

Tolerances:
 - sampling indices exactly;
 - preprocessing 1e-4 after normalization: JAX's own resize rounds to ~9e-6
   against a float64 resize before the division by std (~0.22); the port's
   weight matrices equal JAX's within 6e-8 and its resize a float64 one
   within 1e-6;
 - backbones in float32 5e-5 relative to the largest feature, at the
   smallest input that is still the real network (VGG16's trunk at 32 x 32,
   ResNet's and InceptionV4's blocks at a few pixels), in bf16 2e-2
   relative; the whole networks at 224 / 299 (``slow``) 2e-3, as
   tests/test_backbones.py holds JAX to its torch oracle.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference package needs flax")

import jax
import jax.numpy as jnp

from s2vt_tpu.extract import backbones as jbk
from s2vt_tpu.extract import preprocess as jpp
from s2vt_tpu.extract.torch_weights import params_from_torch_backbone as jax_from_torch
from s2vt_tpu_torch.extract import backbones as tbk
from s2vt_tpu_torch.extract import preprocess as tpp
from s2vt_tpu_torch.extract import torch_weights
from s2vt_tpu_torch.ops import fused_conv
from s2vt_tpu_torch.utils.weights import backbone_params_from_jax


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_bn_stats(tree, seed=0):
    """Non-trivial BN running statistics (and BN affine) in a JAX tree, so
    that the comparisons exercise the statistics math."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and {"scale", "mean", "var"} <= set(node):
            n = node["mean"].shape[0]
            return {**node, "mean": (rng.normal(size=n) * 0.1).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": (rng.normal(size=n) * 0.1).astype(np.float32)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(_np_tree(tree))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# sampling and preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(123, 80), (5, 80), (80, 80), (1, 4)])
def test_sampling_indices_equal_jax(n, k):
    np.testing.assert_array_equal(tpp.fix_sample_indices(n, k), jpp.fix_sample_indices(n, k))
    np.testing.assert_array_equal(tpp.free_sample_indices(n, 10), jpp.free_sample_indices(n, 10))


@pytest.mark.parametrize("shape", [(2, 300, 400, 3), (2, 400, 300, 3)], ids=["land", "portrait"])
@pytest.mark.parametrize("size,mean,std", [(224, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD),
                                           (299, tpp.INCEPTION_MEAN, tpp.INCEPTION_STD)],
                         ids=["224", "299"])
def test_preprocess_matches_jax(shape, size, mean, std):
    frames = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jpp.preprocess_frames(jnp.asarray(frames), jnp.asarray(mean),
                                            jnp.asarray(std), input_size=size))
    got = tpp.preprocess_frames(torch.from_numpy(frames), mean, std, size).numpy()
    assert got.shape == want.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resize_weights_are_jaxs_and_the_resize_is_exact():
    from jax._src.image import scale as jscale
    for n_in, n_out in ((300, 256), (400, 341), (400, 292), (300, 341)):
        want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                                    jscale._fill_triangle_kernel, True)).T
        np.testing.assert_allclose(tpp.resize_weights(n_in, n_out), want, atol=6e-8, rtol=0)
    frames = np.random.default_rng(1).integers(0, 256, (1, 300, 400, 3), dtype=np.uint8)
    got = tpp.preprocess_frames(torch.from_numpy(frames), (0.0,) * 3, (1.0,) * 3, 224).numpy()
    wh = tpp.resize_weights(300, 256)[16:240].astype(np.float64)
    ww = tpp.resize_weights(400, 341)[58:282].astype(np.float64)
    exact = np.einsum("nhwc,oh,pw->nopc", frames / 255.0, wh, ww, optimize=True)
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# backbones on carried weights
# ---------------------------------------------------------------------------


def _vgg_pair(batch_norm, compute_bf16=False, use_pallas=False, size=32):
    """JAX and port VGG16 on the same weights at a small input: the JAX tree
    is initialized at ``size``, so linear0 reads the 512 * (size/32)^2
    values the trunk leaves; the port's linear0 is resized to match."""
    cdt = jnp.bfloat16 if compute_bf16 else None
    jmodel = jbk.VGG16(batch_norm=batch_norm, compute_dtype=cdt)
    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = _with_bn_stats(params) if batch_norm else _np_tree(params)
    port = tbk.VGG16(batch_norm, torch.bfloat16 if compute_bf16 else None, use_pallas)
    port.linear0 = tbk.Linear(512 * (size // 32) ** 2, 4096, port.compute_dtype)
    port.load_state_dict(backbone_params_from_jax(params, port))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)), np.float32)
    return port.eval(), x, want


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["vgg16", "vgg16_bn"])
def test_vgg16_matches_jax(batch_norm, use_pallas, monkeypatch):
    """All 13 conv blocks, the pools and both linears: F.conv2d, or (kernel
    route) the fused conv op's plain version once per block."""
    port, x, want = _vgg_pair(batch_norm, use_pallas=use_pallas)
    calls = []
    plain = fused_conv.conv3x3_bn_relu
    monkeypatch.setattr(fused_conv, "conv3x3_bn_relu", lambda *a: calls.append(1) or plain(*a))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4096)
    assert _rel_err(got, want) <= 5e-5
    assert len(calls) == (13 if use_pallas else 0)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_vgg16_bn_bf16_matches_jax(use_pallas):
    port, x, want = _vgg_pair(True, compute_bf16=True, use_pallas=use_pallas)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= 2e-2


def test_bf16_block_output_rounding_changes_no_feature(monkeypatch):
    """The kernel stores each conv block's output in bf16 where JAX keeps
    float32. In bf16 mode that changes nothing: the next conv rounds its
    input to bf16 anyway, and ReLU and max-pool commute with a monotone
    rounding. Shown bit for bit: the kernel route with the kernel replaced
    by the plain route's own conv (so the sums are the same) and a bf16
    output gives the plain route's features exactly."""
    port, x, _ = _vgg_pair(False, compute_bf16=True, use_pallas=True)
    plain = tbk.VGG16(False, torch.bfloat16, False)
    plain.linear0 = port.linear0
    plain.load_state_dict(port.state_dict())

    def conv_then_round(x, w, scale, shift, bf16):
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).to(torch.bfloat16).float(),
                                       w.permute(3, 2, 0, 1).to(torch.bfloat16).float(),
                                       padding=1)
        y = torch.relu(y * scale[None, :, None, None] + shift[None, :, None, None])
        return y.permute(0, 2, 3, 1).to(torch.bfloat16)

    monkeypatch.setattr(fused_conv, "conv3x3_bn_relu", conv_then_round)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        want = plain(torch.from_numpy(x))
    assert torch.equal(got, want)


def _block_pair(jmodule, tmodule, x_shape, seed):
    x = np.random.default_rng(seed).normal(size=x_shape).astype(np.float32)
    params = _with_bn_stats(jmodule.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"],
                            seed)
    tmodule.load_state_dict(backbone_params_from_jax(params, tmodule))
    want = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodule.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got.numpy(), want


@pytest.mark.parametrize("name", ["bottleneck", "mixed4a", "inception_c"])
def test_resnet_and_inception_blocks_match_jax(name):
    """Building blocks of ResNet152 and InceptionV4 at a few pixels: BN eps
    1e-5 and 1e-3, strided and downsampling convs, asymmetric kernels,
    count_include_pad=False pooling, branch concatenation."""
    blocks = {
        "bottleneck": (jbk.Bottleneck(8, 2, True), tbk.Bottleneck(16, 8, 2, True), (2, 7, 7, 16)),
        "mixed4a": (jbk.Mixed4a(), tbk.Mixed4a(), (1, 9, 9, 160)),
        "inception_c": (jbk.InceptionC(), tbk.InceptionC(), (1, 3, 3, 1536)),
    }
    jmod, tmod, shape = blocks[name]
    got, want = _block_pair(jmod, tmod, shape, 4)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 5e-5


def test_tiny_backbone_matches_jax():
    jmodel, params, spec = jbk.build_backbone("tiny")
    port, tspec = tbk.build_backbone("tiny")
    assert (tspec["input_size"], tspec["feat_dim"]) == (spec["input_size"], spec["feat_dim"])
    port.load_state_dict(backbone_params_from_jax(_np_tree(params), port))
    x = np.random.default_rng(5).normal(size=(3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, atol=1e-6)


def test_registry_sizes_and_widths_are_jaxs():
    for name, (_, size, feat, mean, std) in jbk.BACKBONE_SPECS.items():
        assert tbk.BACKBONE_SPECS[name][1:] == (size, feat, tuple(mean), tuple(std))
    with pytest.raises(ValueError, match="unknown backbone"):
        tbk.build_backbone("alexnet")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["vgg16", "vgg16_bn", "resnet152", "inception_v4"])
def test_whole_backbone_matches_jax(name):
    jmodel, params, spec = jbk.build_backbone(name)
    params = _with_bn_stats(params)
    port, _ = tbk.build_backbone(name, use_pallas=name.startswith("vgg"))
    port.load_state_dict(backbone_params_from_jax(params, port))
    size = spec["input_size"]
    x = np.random.default_rng(6).normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, spec["feat_dim"])
    np.testing.assert_allclose(got, want, atol=2e-3)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_loader_drops_the_head_and_counters(tmp_path):
    """A pretrainedmodels state_dict loads by name: last_linear / fc /
    classifier and num_batches_tracked dropped, everything else kept; the
    JAX converter reads the same file into the same weights."""
    port, _ = tbk.build_backbone("vgg16_bn")
    sd = dict(port.state_dict())
    sd["last_linear.weight"] = torch.zeros(10, 4096)
    sd["last_linear.bias"] = torch.zeros(10)
    sd["_features.1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "vgg.pth")
    loaded = torch_weights.load_torch_checkpoint(str(tmp_path / "vgg.pth"))
    assert set(loaded) == set(port.state_dict())
    torch_weights.check_state_dict(port, loaded, "vgg16_bn")
    jtree = jax_from_torch(sd)
    back = backbone_params_from_jax(_np_tree(jtree), port)
    assert all(torch.equal(back[k], loaded[k]) for k in loaded)
    with pytest.raises(KeyError, match="unrecognized backbone checkpoint key"):
        torch_weights.params_from_torch_backbone({"conv1.weight_orig": torch.zeros(1)})


def test_check_state_dict_errors():
    port, _ = tbk.build_backbone("tiny")
    sd = dict(port.state_dict())
    with pytest.raises(ValueError, match=r"missing=\['conv.bias'\]"):
        torch_weights.check_state_dict(port, {"conv.weight": sd["conv.weight"]}, "tiny")
    with pytest.raises(ValueError, match=r"extra=\['conv2.weight'\]"):
        torch_weights.check_state_dict(port, {**sd, "conv2.weight": sd["conv.weight"]}, "tiny")
    with pytest.raises(ValueError, match="shape mismatch at conv.bias"):
        torch_weights.check_state_dict(port, {**sd, "conv.bias": torch.zeros(9)}, "tiny")


def test_extractor_loads_weights_and_refuses_a_mismatch(tmp_path):
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    port, _ = tbk.build_backbone("tiny", seed=9)
    torch.save(port.state_dict(), tmp_path / "tiny.pth")
    ex = FeatureExtractor("tiny", weights=str(tmp_path / "tiny.pth"), device="cpu")
    assert torch.equal(ex.model.conv.weight, port.conv.weight)
    torch.save({"conv.weight": port.conv.weight}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="does not match backbone 'tiny'"):
        FeatureExtractor("tiny", weights=str(tmp_path / "bad.pth"), device="cpu")
