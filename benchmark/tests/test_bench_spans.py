"""The readers of the program's spans (``benchmark/spans.py``) on a
hand-made Chrome trace: two steps of feed and step spans under the
benchmark's epoch annotation, the epoch's sync, and the card's intervals."""

import pytest

from benchmark import harness
from benchmark.trace import SPAN, Span

READERS = ("feed_host_ms.train", "step_host_ms.train", "feed_idle.train", "step_idle.train")


def _events(prefix="s2vt."):
    X = lambda cat, name, ts, dur, tid=1: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "tid": tid}
    A = lambda name, lo, hi, tid=1: X("user_annotation", prefix + name, lo, hi - lo, tid)
    out = [X("user_annotation", SPAN, 0, 1000), X("user_annotation", "bench.train_epoch", 0, 1000)]
    for t0 in (0, 400):
        out += [A("feed.batch", t0, t0 + 10 + 10 * (t0 > 0)),
                A("feed.send", t0 + 10 + 10 * (t0 > 0), t0 + 30 + 10 * (t0 > 0)),
                A("feed.take", t0 + 40, t0 + 60),
                A("step.seed", t0 + 60, t0 + 70),
                A("step", t0 + 70, t0 + 400),
                A("step.forward", t0 + 70, t0 + 200),
                X("cpu_op", "aten::mm", t0 + 100, 50),
                A("step.loss", t0 + 200, t0 + 220),
                A("step.backward", t0 + 220, t0 + 330),
                A("step.optimizer", t0 + 330, t0 + 400)]
    out += [A("epoch.sync", 900, 990),
            A("feed.batch", 800, 900, tid=2),          # another thread: not the host's feed
            A("feed.send", 1100, 1200)]                # after the traced span
    out += [X("kernel", "k", lo, hi - lo, tid=7)
            for lo, hi in ((20, 50), (100, 380), (430, 450), (480, 780), (950, 1000))]
    return out


def _ctx(**kw):
    ctx = {"loop": "train", "device_type": "cuda", "span": Span(_events()), "span_units": 2}
    ctx.update(kw)
    return ctx


def test_exact_values():
    # feed, main thread: [0, 30] [40, 60] [400, 460] = 110 us over 2 steps;
    # step and its parts, seed included: [60, 400] [460, 800] = 680 us.
    # Busy 680 of 1000 us; idle [0, 20] [50, 100] [380, 430] [450, 480]
    # [780, 950] = 320 us, of which the feed holds 20 + 10 + 30 + 10 = 70
    # and the step 40 + 20 + 20 + 20 = 100
    got = {name: harness.read_metric(name, _ctx()) for name in READERS}
    assert got == pytest.approx({"feed_host_ms.train": 0.055, "step_host_ms.train": 0.34,
                                 "feed_idle.train": 100 * 70 / 320,
                                 "step_idle.train": 100 * 100 / 320})


@pytest.mark.parametrize("name", READERS)
def test_none_where_nothing_to_read(name):
    assert harness.read_metric(name, _ctx(span=Span(_events(prefix="other.")))) is None
    assert harness.read_metric(name, _ctx(device_type="cpu")) is None
    assert harness.read_metric(name, _ctx(span=None)) is None
    assert harness.read_metric(name, _ctx(loop="caption")) is None
