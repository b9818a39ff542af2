"""End-to-end clip captioning of the port (cli/caption.py): frame directory
-> tiny backbone -> caption, from a checkpoint and from a serving artifact,
with the serve loop and the flag checks; mirrors tests/test_caption_cli.py
on the CPU. The artifact's sentences must equal the checkpoint's.
"""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from s2vt_tpu_torch.cli import caption, export_serving


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A checkpoint of random weights (feat_dim 8 = the tiny backbone's), its
    captions file, a greedy artifact of batch 2, and one clip of frames."""
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.training import build_model, save_checkpoint
    from s2vt_tpu_torch.utils.weights import params_to_jax
    root = tmp_path_factory.mktemp("caption")
    meta = make_synthetic_corpus(str(root), n_videos=8, feat_len=10, feat_dim=8, seed=2)
    opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"], train_length=10,
              dim_hidden=16, dim_embed=16, feat_dim=8, use_pallas=True, seed=0)
    model = build_model(opt, meta["vocab_size"])
    model.reset_parameters(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(root / "ckpt"), params_to_jax(model), opt.to_json())
    clip = root / "clipA"
    clip.mkdir()
    rng = np.random.default_rng(0)
    for f in range(12):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)).save(
            clip / f"{f:06d}.jpg")
    art = root / "artifact"
    export_serving.main(["--model_path", ckpt, "--out", str(art), "--batch", "2",
                         "--device", "cpu"])
    return ckpt, meta["captions_file"], art, clip, root


def test_checkpoint_and_artifact_caption_the_same(setup):
    ckpt, captions, art, clip, _ = setup
    out = caption.caption_clips(ckpt, [clip], captions, backbone="tiny", device="cpu")
    assert isinstance(out[str(clip)], str) and out[str(clip)]
    beam = caption.caption_clips(ckpt, [clip], captions, backbone="tiny", beam=True,
                                 device="cpu")
    assert isinstance(beam[str(clip)], str)
    by_artifact = caption.ClipCaptioner(backbone="tiny", artifact=str(art), device="cpu")
    assert by_artifact.caption([clip]) == out
    early = caption.ClipCaptioner(ckpt, captions, backbone="tiny", early_stop=True,
                                  device="cpu")
    assert early.caption([clip]) == out


def test_serve_loop(setup):
    """One request line -> one JSON line; a bad path is answered with an
    error object and the server goes on; a blank line ends the session."""
    ckpt, captions, art, clip, _ = setup
    captioner = caption.ClipCaptioner(ckpt, captions, backbone="tiny", device="cpu")
    one = captioner.caption([clip])
    stdin = io.StringIO(f"{clip}\n{clip} {clip}\n/no/such/clip\n\nnot read\n")
    stdout = io.StringIO()
    assert caption.serve(captioner, infile=stdin, outfile=stdout) == 3
    lines = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert lines[0] == one and len(lines[1]) == 1 and "error" in lines[2]


def test_main_prints_captions_and_checks_flags(setup, capsys, monkeypatch):
    ckpt, captions, art, clip, root = setup
    result = caption.main([str(clip), "--artifact", str(art), "--backbone", "tiny",
                           "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == result
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{clip}\n\n"))
    assert caption.main(["--serve", "--model_path", ckpt, "--caption_file", captions,
                         "--backbone", "tiny", "--device", "cpu"]) == 1
    assert "served 1 request(s)" in capsys.readouterr().out
    bad = [([str(clip)], "one of --model_path / --artifact"),
           ([str(clip), "--artifact", str(art), "--model_path", ckpt], "replaces --model_path"),
           ([str(clip), "--artifact", str(art), "--caption_file", captions], "vocabulary"),
           ([str(clip), "--artifact", str(art), "--early_stop"], "decode loop is baked"),
           ([str(clip), "--artifact", str(art), "--beam"], "--beam cannot apply"),
           ([str(clip), "--artifact", str(root / "none")], "cannot read artifact manifest"),
           (["--model_path", ckpt], "provide clip paths")]
    for argv, msg in bad:
        with pytest.raises(SystemExit):
            caption.main(argv + ["--device", "cpu"])
        assert msg in capsys.readouterr().err, argv
