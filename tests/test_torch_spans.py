"""The training loop's spans (``utils/profiling.py::annotate``), on the CPU.

With no profiler recording a span is the shared null context and the loop
makes no ``record_function``; under ``profiling.trace`` one ``train_epoch``
writes its feed, step and sync spans into the Chrome trace, nested as the
benchmark's readers assume, on the operators' clock.
"""

import json

import pytest
import torch

from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
from s2vt_tpu_torch.training import Trainer
from s2vt_tpu_torch.training import loop
from s2vt_tpu_torch.utils import profiling

from test_torch_training import F, L, small_opt

STEP_PARTS = ("s2vt.step.forward", "s2vt.step.loss", "s2vt.step.backward",
              "s2vt.step.optimizer")
FEED = ("s2vt.feed.batch", "s2vt.feed.send", "s2vt.feed.take")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus of tests/test_torch_training.py: 16 train clips, two steps
    of 8."""
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(str(root), n_videos=32, vocab_extra=20, feat_len=L,
                                 feat_dim=F, seed=5)


def _trainer(corpus, tmp_path, **kw) -> Trainer:
    return Trainer(small_opt(corpus, tmp_path, **kw), device="cpu", writer=None)


def _trace_events(log_dir) -> list:
    (path,) = log_dir.glob("*.pt.trace.json")
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _spans(events, *names) -> list:
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] in names]


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_annotate_is_the_shared_null_context_when_off(corpus, tmp_path, monkeypatch):
    assert profiling.annotate("s2vt.step") is profiling.NULL_SPAN
    assert profiling.annotate("s2vt.feed.send") is profiling.NULL_SPAN
    handed = []

    def spy(name):
        span = profiling.annotate(name)
        handed.append((name, span))
        return span

    def forbidden(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    tr = _trainer(corpus, tmp_path)
    monkeypatch.setattr(loop, "annotate", spy)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    tr.train_epoch(0)
    steps = tr.train_ds.steps_per_epoch(tr.opt.batch_size)
    assert sum(name == "s2vt.step" for name, _ in handed) == steps
    assert all(span is profiling.NULL_SPAN for _, span in handed)


@pytest.mark.parametrize("bank", ["on", "off"])
def test_one_traced_epoch_writes_nested_spans(corpus, tmp_path, bank):
    """The bank's feed and the streamed one (read ahead on a thread of its
    own): per step one ``s2vt.step`` holding its parts, one send and one
    take outside every step, and the epoch's one sync."""
    tr = _trainer(corpus, tmp_path, device_feature_bank=bank)
    steps = tr.train_ds.steps_per_epoch(tr.opt.batch_size)
    with profiling.trace(str(tmp_path / "prof")):
        tr.train_epoch(0)
    events = _trace_events(tmp_path / "prof")
    step_spans = _spans(events, "s2vt.step")
    assert len(step_spans) == steps
    assert len(_spans(events, "s2vt.epoch.sync")) == 1
    assert len(_spans(events, "s2vt.step.seed")) == steps
    assert len(_spans(events, "s2vt.feed.send")) == steps
    assert len(_spans(events, "s2vt.feed.take")) == steps
    assert len(_spans(events, "s2vt.feed.batch")) == steps + 1    # the last finds the end
    main = {e["tid"] for e in step_spans}
    assert len(main) == 1 and {e["tid"] for e in _spans(events, *FEED)} == main
    assert not _spans(events, "s2vt.step.allreduce")
    for name in STEP_PARTS:
        parts = _spans(events, name)
        assert len(parts) == steps, name
        assert all(sum(_inside(p, s) for s in step_spans) == 1 for p in parts), name
    for e in _spans(events, *FEED, "s2vt.step.seed", "s2vt.epoch.sync"):
        assert not any(_inside(e, s) for s in step_spans), e["name"]
    # the step's matrix products sit inside its forward or backward span:
    # the spans and the operators share one clock
    fwd_bwd = _spans(events, "s2vt.step.forward", "s2vt.step.backward")
    mms = [e for e in events if e["name"] == "aten::mm"
           and any(_inside(e, s) for s in step_spans)]
    assert mms and all(any(_inside(e, p) for p in fwd_bwd) for e in mms)
    assert {p["name"] for p in fwd_bwd if any(_inside(e, p) for e in mms)} == {
        "s2vt.step.forward", "s2vt.step.backward"}


def test_opt_profile_trace_holds_the_step_spans(corpus, tmp_path):
    tr = _trainer(corpus, tmp_path, profile=True)
    tr.fit(epochs=1)
    events = _trace_events(tmp_path / "runs" / "profile")
    assert len(_spans(events, "s2vt.step")) == tr.train_ds.steps_per_epoch(tr.opt.batch_size)


def test_feed_batch_spans_close_their_source():
    closed = []

    def source():
        try:
            yield from range(5)
        finally:
            closed.append(True)

    src = source()            # held here, so only an explicit close ends it
    fed = loop._spanned(src)
    assert next(fed) == 0 and not closed
    fed.close()
    assert closed == [True]
    assert list(loop._spanned(source())) == list(range(5)) and closed == [True, True]
