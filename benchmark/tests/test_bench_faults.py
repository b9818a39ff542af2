"""A whole run of each cell at a tiny size on the CPU, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it does not."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import EXTRACT, tiny_files

SEED = 2 ** 31 + 11


def _run(workload):
    result, _ = run.run_cell(workload, SEED, 0.5, False, "cpu", t0=0.0,
                             files=tiny_files(workload))
    return result


@pytest.mark.parametrize("workload", ["lstm.train.b16", "gru.train.b16",
                                      "lstm.caption", "gru.caption", "vgg16.extract.n80"])
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _state_unchanged_step(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch_loss(monkeypatch):
    from s2vt_tpu_torch.training import loop
    whole = loop.batch_loss

    def half(logits, labels, mask, valid, **kw):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n], mask[:n], valid[:n], **kw)
    monkeypatch.setattr(loop, "batch_loss", half)


def _label_altered(monkeypatch):
    from s2vt_tpu_torch.data.dataset import VideoDataset
    encode = VideoDataset._encode_caption

    def altered(self, tokens):
        label, mask = encode(self, tokens)
        label[1] = (label[1] + 1) % self.vocab_size
        return label, mask
    monkeypatch.setattr(VideoDataset, "_encode_caption", altered)


def _token_altered(monkeypatch):
    from s2vt_tpu_torch.models import s2vt
    pick = s2vt.greedy_pick

    def altered(out_w, *args):
        inner = pick(out_w, *args)

        def step(h):
            ids = inner(h).clone()
            ids[0] = (ids[0] + 1) % out_w.shape[0]
            return ids
        return step
    monkeypatch.setattr(s2vt, "greedy_pick", altered)


def _decode_state_unchanged(monkeypatch):
    from s2vt_tpu_torch.models import s2vt
    step = s2vt.multilayer_step
    monkeypatch.setattr(s2vt, "multilayer_step",
                        lambda states, *a, **k: (list(states), step(states, *a, **k)[1]))


def _half_batch_decoded(monkeypatch):
    from s2vt_tpu_torch.models import s2vt
    greedy = s2vt.S2VT.greedy

    def half(self, feats, early_stop=False):
        n = feats.shape[0] // 2
        out = torch.full((feats.shape[0], self.length - 1), self.eos_ix, dtype=torch.int32)
        out[:n] = greedy(self, feats[:n])
        return out
    monkeypatch.setattr(s2vt.S2VT, "greedy", half)


def _bn_left_out(monkeypatch):
    from s2vt_tpu_torch.ops import fused_conv
    fold, calls = fused_conv.fold_bn, []

    def fold_missing_one(conv_bias, channels, bn=None, eps=1e-5, device=None):
        calls.append(1)
        if len(calls) % 13 == 7:          # the 7th block of every forward
            bn = None
        return fold(conv_bias, channels, bn, eps, device)
    monkeypatch.setattr(fused_conv, "fold_bn", fold_missing_one)


def _half_frames(monkeypatch):
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    features = FeatureExtractor._features

    def half(self, frames):
        n = frames.shape[0] // 2
        kept = features(self, frames[:n])
        return torch.cat([kept, kept.mean(dim=0, keepdim=True).expand(frames.shape[0] - n, -1)])
    monkeypatch.setattr(FeatureExtractor, "_features", half)


def _clips_rotated(monkeypatch):
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    call = FeatureExtractor.__call__

    def rotated(self, frames, valid_count=None):
        return np.roll(call(self, frames, valid_count), EXTRACT["frames_per_clip"], axis=0)
    monkeypatch.setattr(FeatureExtractor, "__call__", rotated)


def _feature_altered(monkeypatch):
    from s2vt_tpu_torch.extract import backbones
    forward = backbones.VGG16.forward

    def altered(self, x):
        out = forward(self, x).clone()
        out[0, out[0].argmax()] *= 1.01
        return out
    monkeypatch.setattr(backbones.VGG16, "forward", altered)


FAULTS = {"train": [_state_unchanged_step, _half_batch_loss, _label_altered],
          "caption": [_token_altered, _decode_state_unchanged, _half_batch_decoded],
          "extract": [_bn_left_out, _half_frames, _clips_rotated, _feature_altered]}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("lstm.train.b16", "gru.train.b16")
    for f in FAULTS["train"]] + [
    (w, f) for w in ("lstm.caption", "gru.caption")
    for f in FAULTS["caption"]] + [
    ("vgg16.extract.n80", f) for f in FAULTS["extract"]],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]
