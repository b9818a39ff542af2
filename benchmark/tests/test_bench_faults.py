"""A whole run of each cell at a tiny size on the CPU, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it does not."""

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_files

SEED = 2 ** 31 + 11


def _run(workload):
    result, _ = run.run_cell(workload, SEED, 0.5, False, "cpu", t0=0.0,
                             files=tiny_files(workload))
    return result


@pytest.mark.parametrize("workload", ["lstm.train.b16", "gru.train.b16",
                                      "lstm.caption", "gru.caption"])
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


FAULTS = {"train": [_state_unchanged_step, _half_batch_loss, _label_altered],
          "caption": [_token_altered, _decode_state_unchanged, _half_batch_decoded]}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("lstm.train.b16", "gru.train.b16")
    for f in FAULTS["train"]] + [
    (w, f) for w in ("lstm.caption", "gru.caption")
    for f in FAULTS["caption"]], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]
