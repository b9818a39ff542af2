"""The ``graphed_steps.train`` reader on a hand-made Chrome trace: four
train steps on the main thread, of which the first runs eager, the second
captures its graph and the last two replay it; each step's parts sit in a
span of its mode, as the program writes them."""

import pytest

from benchmark import harness
from benchmark.trace import SPAN, Span

NAME = "graphed_steps.train"


def _events(parts=("step.eager", "step.capture", "step.replay", "step.replay")):
    X = lambda cat, name, ts, dur, tid=1: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "tid": tid}
    out = [X("user_annotation", SPAN, 0, 1000)]
    for k, part in enumerate(parts):
        t0 = 200 * k
        out += [X("user_annotation", "s2vt.step", t0 + 10, 150),
                X("user_annotation", "s2vt." + part, t0 + 20, 100),
                X("user_annotation", "s2vt.step.optimizer", t0 + 120, 30),
                X("kernel", "k", t0 + 30, 120, tid=7)]
    out += [X("user_annotation", "s2vt.step.replay", 900, 20, tid=2),     # another thread
            X("user_annotation", "s2vt.step", 1100, 50),                   # after the span
            X("user_annotation", "s2vt.step.replay", 1110, 20)]
    return out


def _ctx(**kw):
    ctx = {"loop": "train", "device_type": "cuda", "span": Span(_events()), "span_units": 4}
    ctx.update(kw)
    return ctx


def test_share_of_steps_that_replay():
    assert harness.read_metric(NAME, _ctx()) == pytest.approx(50.0)
    every = Span(_events(("step.replay",) * 3))
    assert harness.read_metric(NAME, _ctx(span=every)) == pytest.approx(100.0)
    first = Span(_events(("step.eager", "step.capture")))
    assert harness.read_metric(NAME, _ctx(span=first)) == pytest.approx(0.0)


def test_a_program_that_graphs_no_step_reads_zero():
    eager = Span(_events(("step.eager",) * 4))
    assert harness.read_metric(NAME, _ctx(span=eager)) == pytest.approx(0.0)


def test_none_where_nothing_to_read():
    unnamed = Span(_events(("step.forward",) * 4))          # steps name no mode
    assert harness.read_metric(NAME, _ctx(span=unnamed)) is None
    assert harness.read_metric(NAME, _ctx(device_type="cpu")) is None
    assert harness.read_metric(NAME, _ctx(span=None)) is None
    assert harness.read_metric(NAME, _ctx(loop="caption")) is None
