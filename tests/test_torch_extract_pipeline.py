"""The port's extraction pipeline (extract/pipeline.py, cli/extract.py) on
frame directories, mirroring tests/test_extract_pipeline.py (without its
mesh test: extraction over a device mesh is not ported and raises), with the
``tiny`` backbone on the CPU. Features of the port's FeatureExtractor equal
JAX's on carried weights within 1e-4 (the preprocessing's tolerance,
tests/test_torch_extract.py); batched and per-clip forwards within 1e-6.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from s2vt_tpu_torch.extract.pipeline import FeatureExtractor, extract
from s2vt_tpu_torch.extract.video import load_clip, read_frame_dir


def _make_frame_dirs(root, n_clips=2, n_frames=12, size=(30, 40), seed=0):
    rng = np.random.default_rng(seed)
    for c in range(n_clips):
        d = root / f"clip{c:02d}"
        d.mkdir(parents=True)
        for f in range(n_frames):
            arr = rng.integers(0, 255, (*size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{f:06d}.jpg")
    return root


def test_read_frame_dir_sorted(tmp_path):
    _make_frame_dirs(tmp_path, n_clips=1, n_frames=5)
    frames = read_frame_dir(tmp_path / "clip00")
    assert frames.shape == (5, 30, 40, 3) and frames.dtype == np.uint8
    assert np.array_equal(load_clip(str(tmp_path / "clip00")), frames)


def test_extract_fix_mode(tmp_path):
    src = _make_frame_dirs(tmp_path / "videos")
    out = tmp_path / "feats"
    assert extract(str(src), str(out), model="tiny", mode="fix", frames_num=6,
                   device="cpu") == 2
    feats = np.load(out / "clip00.npy")
    assert feats.shape == (6, 8) and np.isfinite(feats).all()


def test_extract_free_mode_pads_to_bucket(tmp_path):
    src = _make_frame_dirs(tmp_path / "videos", n_frames=11)
    out = tmp_path / "feats"
    extract(str(src), str(out), model="tiny", mode="free", interval=3, device="cpu")
    # 11 frames, every 3rd -> indices 0, 3, 6, 9 -> 4 features (padding stripped)
    feats = np.load(out / "clip00.npy")
    assert feats.shape == (4, 8)
    ex = FeatureExtractor("tiny", device="cpu")
    frames = read_frame_dir(src / "clip00")[[0, 3, 6, 9]]
    np.testing.assert_allclose(feats, ex(frames), atol=1e-6)


def test_extractor_deterministic_and_matches_jax(tmp_path):
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax", reason="the JAX reference package needs flax")
    from s2vt_tpu.extract.pipeline import FeatureExtractor as JExtractor
    from s2vt_tpu_torch.utils.weights import backbone_params_from_jax
    src = _make_frame_dirs(tmp_path / "videos", n_clips=1)
    frames = read_frame_dir(src / "clip00")
    ex = FeatureExtractor("tiny", device="cpu")
    np.testing.assert_array_equal(ex(frames), ex(frames))
    jex = JExtractor("tiny")
    ex.model.load_state_dict(backbone_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jex.params), ex.model))
    np.testing.assert_allclose(ex(frames), jex(frames), atol=1e-4)


def test_clip_batching_matches_per_clip(tmp_path):
    """clip_batch groups clips into one forward; the features equal the
    per-clip path's, the partial last group included."""
    src = _make_frame_dirs(tmp_path / "videos", n_clips=5)
    out_b, out_1 = tmp_path / "feats_batched", tmp_path / "feats_serial"
    extract(str(src), str(out_b), model="tiny", mode="fix", frames_num=6, clip_batch=2,
            device="cpu")
    extract(str(src), str(out_1), model="tiny", mode="fix", frames_num=6, clip_batch=1,
            device="cpu")
    for c in range(5):
        np.testing.assert_allclose(np.load(out_b / f"clip{c:02d}.npy"),
                                   np.load(out_1 / f"clip{c:02d}.npy"), atol=1e-6)


def test_clip_batching_mixed_resolutions(tmp_path):
    """Clips of different raw frame sizes are forwarded one by one inside
    their group instead of failing to stack."""
    src = tmp_path / "videos"
    _make_frame_dirs(src, n_clips=1, n_frames=8)
    d = src / "clipBIG"
    d.mkdir()
    rng = np.random.default_rng(1)
    for f in range(8):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            d / f"{f:06d}.jpg")
    out = tmp_path / "feats"
    assert extract(str(src), str(out), model="tiny", mode="fix", frames_num=4, clip_batch=4,
                   device="cpu") == 2
    assert np.load(out / "clip00.npy").shape == (4, 8)
    assert np.load(out / "clipBIG.npy").shape == (4, 8)


def test_extract_overwrites(tmp_path):
    src = _make_frame_dirs(tmp_path / "videos")
    out = tmp_path / "feats"
    out.mkdir()
    (out / "stale.npy").write_bytes(b"x")
    extract(str(src), str(out), model="tiny", mode="fix", frames_num=4, device="cpu")
    assert not (out / "stale.npy").exists()


def test_extractor_refuses_a_mesh_a_bad_mode_and_a_missing_card(tmp_path):
    src = _make_frame_dirs(tmp_path, n_clips=1, n_frames=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        FeatureExtractor("tiny", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        FeatureExtractor("tiny", device="cpu").extract_clip(str(src / "clip00"), mode="every")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FeatureExtractor("tiny")


def test_extract_cli(tmp_path, capsys):
    from s2vt_tpu_torch.cli import extract as extract_cli
    src = _make_frame_dirs(tmp_path / "videos", n_clips=3)
    n = extract_cli.main(["--video_path", str(src), "--mode", "fix", "--feat_path",
                          str(tmp_path / "f"), "--model", "tiny", "--frames_num", "5",
                          "--clip_batch", "2", "--device", "cpu"])
    assert n == 3 and np.load(tmp_path / "f" / "clip02.npy").shape == (5, 8)
    assert "extracted features for 3 clips" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        extract_cli.main(["--video_path", str(src), "--mode", "sometimes"])
