"""The train step's CUDA graph (``training/step_graph.py``).

On the CPU: the rule that decides eager, capture or replay, the key, the
launch counters' registry and bookkeeping, the dispatch of
``StepGraph.step`` (with the capture stood in for) and the spans naming
each step's mode, and a CPU Trainer, which never captures and makes a
dropout generator only where a dropout rate is above 0. On the card
(``cuda`` marker): graphed epochs against eager ones, bit for bit, for S2VT
with LSTM, GRU and two LSTM layers (float32 and bf16) and for the attention
baseline, and for a streamed, profiled fit with async saves; the launch
counters against the profiler's kernel records; a learning-rate change in
the next replayed step; a model that stays eager says why. Imports nothing
of JAX.
"""

import importlib

import pytest
import torch

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
from s2vt_tpu_torch.training import Trainer
from s2vt_tpu_torch.training import step_graph as sg

B, L, F, H, V = 16, 6, 16, 128, 32
KEY = (((B, L, F), torch.float32),)

# The kernels' device symbols, by counter.
SYMBOLS = {"fused_s2vt_fwd": ("s2vt_fused_fwd_kernel",),
           "fused_s2vt_bwd": ("s2vt_fused_bwd_kernel",),
           "lstm_seq_fwd": ("lstm_seq_fwd_kernel", "lstm_seq_fwd_stream_kernel"),
           "lstm_seq_bwd": ("lstm_seq_bwd_kernel", "lstm_seq_bwd_stream_products",
                            "lstm_seq_bwd_stream_cell"),
           "gru_seq_fwd": ("gru_seq_fwd_kernel", "gru_seq_fwd_stream_kernel"),
           "gru_seq_bwd": ("gru_seq_bwd_kernel", "gru_seq_bwd_stream_products",
                           "gru_seq_bwd_stream_cell")}

MODELS = {"lstm": {}, "gru": {"rnn_type": "gru"}, "lstm2": {"num_layers": 2},
          "att": {"model": "att_baseline"}, "lstm_bf16": {"compute_dtype": "bfloat16"},
          "lstm2_bf16": {"num_layers": 2, "compute_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """96 clips: 48 train (three batches of 16)."""
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(str(root), n_videos=96, vocab_extra=20, feat_len=L,
                                 feat_dim=F, seed=3)


def trainer(corpus, tmp_path, device, **kw) -> Trainer:
    """A Trainer at the test's size; the bank on unless ``kw`` says."""
    kw = {"device_feature_bank": "on", **kw}
    opt = Opt(caption_file=corpus["captions_file"], feats_path=corpus["feat_path"],
              train_length=L, dim_hidden=H, dim_embed=H, feat_dim=F, batch_size=B,
              vocab_pad_multiple=V, lr=1e-3, seed=0, use_pallas=True,
              save_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"), **kw)
    return Trainer(opt, device=device, writer=None)


def epochs_losses(tr: Trainer, epochs) -> list:
    """Each step's loss tensor over ``train_epoch`` of each epoch."""
    losses, step = [], tr.train_step

    def record(*args, **kw):
        losses.append(step(*args, **kw))
        return losses[-1]

    tr.train_step = record
    for epoch in epochs:
        tr.train_epoch(epoch)
    del tr.train_step
    return losses


# --- the rule, the key, the counters (CPU) ----------------------------------

@pytest.mark.parametrize("device, mesh, rates, warmed, captured, want", [
    ("cpu", False, (0.0, 0.0, 0.0), set(), {}, ("eager", "cpu")),
    ("cpu", True, (0.5, 0.0, 0.0), {KEY}, {KEY: 1}, ("eager", "cpu")),
    ("cuda", True, (0.0, 0.0, 0.0), {KEY}, {KEY: 1}, ("eager", "mesh")),
    ("cuda", False, (0.0, 0.2, 0.0), {KEY}, {KEY: 1}, ("eager", "dropout")),
    ("cuda", False, (0.0, 0.0, 0.0), set(), {}, ("eager", "warmup")),
    ("cuda", False, (0.0, 0.0, 0.0), {KEY}, {}, ("capture", None)),
    ("cuda", False, (0.0, 0.0, 0.0), {KEY}, {KEY: 1}, ("replay", None)),
    ("cuda", False, (0.0, 0.0, 0.0), {KEY}, {("other",): 1}, ("capture", None)),
    ("cuda", False, (0.0, 0.0, 0.0), {("other",)}, {("other",): 1}, ("eager", "warmup")),
])
def test_step_mode(device, mesh, rates, warmed, captured, want):
    reason = sg.eager_reason(device, mesh, rates)
    assert sg.step_mode(reason, KEY, warmed, captured) == want
    assert (reason is None) == (want[1] in (None, "warmup"))


def test_step_key_follows_shapes_dtypes_and_model():
    """The key is the inputs' shapes and dtypes; the model and its compute
    dtype are fixed for a StepGraph, and are no part of it."""
    x = (torch.zeros(B, L, F), torch.zeros(B, L, dtype=torch.long))
    keys = {sg.step_key(x),
            sg.step_key((torch.zeros(B - 1, L, F), x[1])),
            sg.step_key((x[0].to(torch.bfloat16), x[1])),
            sg.step_key((x[0], x[1].int())),
            sg.step_key(x[:1])}
    assert len(keys) == 5
    assert sg.step_key(x) == sg.step_key(tuple(t.clone() for t in x))
    assert sg.step_key(x[:1]) == KEY


def _counter(**routes):
    def fn():
        pass
    fn.launches, fn.route_launches = sum(routes.values()), dict(routes)
    return fn


def test_launches_of_a_capture_are_taken_back_and_added_per_replay():
    a, b, idle = _counter(mma=3, direct=0), _counter(direct=5), _counter(mma=7)
    counters = (a, b, idle)
    before = sg.read_launches(counters)
    for fn, route, n in ((a, "mma", 1), (b, "direct", 2)):     # what a capture counts
        fn.launches += n
        fn.route_launches[route] += n
    launched = sg.launches_since(counters, before)
    assert launched == [(a, 1, {"mma": 1}), (b, 2, {"direct": 2})]
    sg.add_launches(launched, -1)
    assert sg.read_launches(counters) == before
    sg.add_launches(launched, 1)
    sg.add_launches(launched, 1)
    assert (a.launches, a.route_launches) == (5, {"mma": 5, "direct": 0})
    assert (b.launches, b.route_launches) == (9, {"direct": 9})
    assert (idle.launches, idle.route_launches) == (7, {"mma": 7})


OPS = ("fused_att_decode", "fused_conv", "fused_decode", "fused_gru", "fused_rnn",
       "fused_s2vt")


def test_launch_counters_are_the_kernel_wrappers():
    from s2vt_tpu_torch.ops.launches import COUNTED
    for name in OPS:
        importlib.import_module(f"s2vt_tpu_torch.ops.{name}")
    names = [fn.__name__ for fn in COUNTED.values()]
    assert set(SYMBOLS) <= set(names) and len(names) == len(set(names)) == 9
    assert all(isinstance(fn.launches, int) and fn.route_launches for fn in COUNTED.values())


def test_a_counted_wrapper_registers_once_per_name(monkeypatch):
    from s2vt_tpu_torch.ops import launches
    monkeypatch.setattr(launches, "COUNTED", {})

    def make():
        def wrapper():
            pass
        return launches.counted(wrapper, "mma", "direct")

    first = make()
    assert (first.launches, first.route_launches) == (0, {"mma": 0, "direct": 0})
    second = make()                              # the same module and name, as on a reload
    assert list(launches.COUNTED.values()) == [second]


class _FakeCaptured:
    """Stands in for a capture on the CPU: records its replays."""

    def __init__(self, inputs, forward_backward, params):
        self.inputs = tuple(t.clone() for t in inputs)
        self.replays = 0

    def replay(self, inputs):
        self.replays += 1
        return torch.tensor(float(self.replays))


def test_step_dispatch_warms_up_captures_then_replays(monkeypatch):
    monkeypatch.setattr(sg, "_Captured", _FakeCaptured)
    calls = []

    def forward_backward(*args):
        calls.append(args)
        return torch.tensor(0.0)

    model = torch.nn.Linear(2, 2)
    graph = sg.StepGraph(model, torch.device("cuda"), False, forward_backward)
    x = (torch.zeros(B, L, F), torch.zeros(B, L, dtype=torch.long))
    y = (torch.zeros(B - 1, L, F), torch.zeros(B - 1, L, dtype=torch.long))
    for inputs in (x, x, x, x, y, y):
        graph.step(inputs)
    assert graph.stats == {"eager": 2, "captures": 2, "replays": 2,
                           "eager_reasons": {"warmup": 2}}
    assert [a[0].shape[0] for a in calls] == [B, B - 1]
    assert [c.replays for c in graph._graphs.values()] == [3, 1]
    graph.step(x)
    assert graph.stats["replays"] == 3 and graph._graphs[sg.step_key(x)].replays == 4


def test_each_step_runs_in_a_span_of_its_mode(monkeypatch):
    from torch.profiler import profile
    monkeypatch.setattr(sg, "_Captured", _FakeCaptured)

    def forward_backward(*args):
        with sg.annotate("s2vt.step.forward"):
            return torch.tensor(0.0)

    graph = sg.StepGraph(torch.nn.Linear(2, 2), torch.device("cuda"), False, forward_backward)
    with profile() as prof:
        for _ in range(4):
            graph.step((torch.zeros(B, L),))
    names = [e.name for e in prof.events() if e.name.startswith("s2vt.step.")]
    assert names == ["s2vt.step.eager", "s2vt.step.forward", "s2vt.step.capture",
                     "s2vt.step.replay", "s2vt.step.replay"]


def test_step_dispatch_with_dropout_stays_eager(monkeypatch):
    monkeypatch.setattr(sg, "_Captured", _FakeCaptured)
    model = torch.nn.Linear(2, 2)
    model.out_dropout = 0.5
    graph = sg.StepGraph(model, torch.device("cuda"), False, lambda *a: torch.tensor(0.0))
    for _ in range(3):
        graph.step((torch.zeros(2),))
    assert graph.stats == {"eager": 3, "captures": 0, "replays": 0,
                           "eager_reasons": {"dropout": 3}}


# --- the Trainer on the CPU ------------------------------------------------

def test_cpu_trainer_never_captures(corpus, tmp_path):
    tr = trainer(corpus, tmp_path, "cpu")
    losses = epochs_losses(tr, (0, 1))
    steps = 2 * tr.train_ds.steps_per_epoch(B)
    assert len(losses) == steps == 6
    assert tr.step_graph_stats == {"eager": steps, "captures": 0, "replays": 0,
                                   "eager_reasons": {"cpu": steps}}


@pytest.mark.parametrize("rate, draws", [(0.0, False), (0.3, True)])
def test_a_dropout_generator_is_made_only_where_a_step_draws(corpus, tmp_path, rate, draws):
    tr = trainer(corpus, tmp_path, "cpu", out_dropout=rate)
    assert tr._step_graph.draws_random == draws
    gens, step = [], tr.train_step

    def record(*args, generator=None):
        gens.append(generator)
        return step(*args, generator=generator)

    tr.train_step = record
    tr.train_epoch(0)
    assert len(gens) == tr.train_ds.steps_per_epoch(B)
    assert all(isinstance(g, torch.Generator) == draws for g in gens)
    assert draws or all(g is None for g in gens)


def test_train_step_returns_a_loss_of_its_own(corpus, tmp_path):
    tr = trainer(corpus, tmp_path, "cpu")
    losses = epochs_losses(tr, (0,))
    values = [float(x) for x in losses]
    assert len({id(x) for x in losses}) == len(losses)
    assert torch.stack(losses).tolist() == values and len(set(values)) == len(values)


# --- on the card -------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _state(tr: Trainer) -> dict:
    out = {}
    for name, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        out.update({name: p.detach().cpu(), name + ".m": st["exp_avg"].cpu(),
                    name + ".v": st["exp_avg_sq"].cpu()})
    return out


def _eager(monkeypatch):
    monkeypatch.setattr(sg, "step_mode", lambda *args: ("eager", "forced"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_graphed_epochs_equal_eager_ones_bit_for_bit(corpus, tmp_path, monkeypatch, name):
    _needs_card()
    graphed = trainer(corpus, tmp_path / "graph", "cuda", **MODELS[name])
    got = epochs_losses(graphed, (0, 1))
    steps = 2 * graphed.train_ds.steps_per_epoch(B)
    assert graphed.step_graph_stats == {"eager": 1, "captures": 1, "replays": steps - 2,
                                        "eager_reasons": {"warmup": 1}}
    assert len({x.data_ptr() for x in got}) == len(got)
    with monkeypatch.context() as m:
        _eager(m)
        eager = trainer(corpus, tmp_path / "eager", "cuda", **MODELS[name])
        want = epochs_losses(eager, (0, 1))
    assert eager.step_graph_stats["eager"] == steps
    assert torch.equal(torch.stack(got), torch.stack(want)), (got, want)
    a, b = _state(graphed), _state(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_launch_counters_match_the_profilers_records(corpus, tmp_path, name):
    _needs_card()
    from torch.profiler import ProfilerActivity, profile
    tr = trainer(corpus, tmp_path, "cuda", **MODELS[name])
    tr.train_epoch(0)
    counters = [fn for fn in sg.COUNTED.values() if fn.__name__ in SYMBOLS]
    before = [fn.launches for fn in counters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_epoch(1)
        torch.cuda.synchronize()
    assert tr.step_graph_stats["replays"] == 2 * tr.train_ds.steps_per_epoch(B) - 2
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counted = {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}
    kept = {op: sum(any(s in k for s in SYMBOLS[op]) for k in kernels) for op in counted}
    assert counted == kept and sum(counted.values()) > 0, (counted, kept)


@pytest.mark.cuda
def test_a_learning_rate_change_shows_in_the_next_replayed_step(corpus, tmp_path, monkeypatch):
    _needs_card()
    runs = {}
    for mode in ("graph", "eager"):
        with monkeypatch.context() as m:
            if mode == "eager":
                _eager(m)
            tr = trainer(corpus, tmp_path / mode, "cuda")
            tr.train_epoch(0)
            before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
            tr.plateau.patience = 0
            for valid_loss in (1.0, 2.0):       # one epoch without improvement
                lr = tr.plateau.step(valid_loss)
            assert lr == pytest.approx(1e-4)
            tr._set_lr(lr)
            replays = tr.step_graph_stats["replays"]
            batch = next(tr.train_ds.batches(B, epoch=1))
            tr.train_step(*tr._put(batch, "train"))
            runs[mode] = {k: p.detach() - before[k] for k, p in tr.model.named_parameters()}
            if mode == "graph":
                assert tr.step_graph_stats["replays"] == replays + 1
    for k, d in runs["graph"].items():
        assert torch.equal(d, runs["eager"][k]), k
    # Adam moves no weight by more than lr (1 - beta1) / sqrt(1 - beta2) = 3.16 lr:
    # at the old rate, 1e-3, the step would move them by up to ten times as much.
    biggest = max(float(d.abs().max()) for d in runs["graph"].values())
    assert 0 < biggest <= 3.17e-4


@pytest.mark.cuda
def test_streamed_profiled_fit_with_async_saves_equals_eager(corpus, tmp_path, monkeypatch):
    """Features streamed from pinned memory, read ahead on a thread of its
    own while the main thread captures, prefetch depth 2, epoch 0 profiled,
    async saves every epoch: the graphed fit equals the eager one bit for
    bit."""
    _needs_card()
    kw = dict(device_feature_bank="off", prefetch_depth=2, profile=True,
              async_checkpoint=True, save_freq=1)
    fits = {}
    for mode in ("graph", "eager"):
        with monkeypatch.context() as m:
            if mode == "eager":
                _eager(m)
            tr = trainer(corpus, tmp_path / mode, "cuda", **kw)
            assert not tr.use_feature_bank
            fits[mode] = (tr, tr.fit(epochs=3))
    graphed, got = fits["graph"]
    eager, want = fits["eager"]
    steps = 3 * graphed.train_ds.steps_per_epoch(B)
    assert graphed.step_graph_stats == {"eager": 1, "captures": 1, "replays": steps - 2,
                                        "eager_reasons": {"warmup": 1}}
    assert eager.step_graph_stats["eager"] == steps
    for key in ("train_loss", "valid_loss"):
        assert got[key] == want[key], key
    a, b = _state(graphed), _state(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert list((tmp_path / "graph" / "runs" / "profile").glob("*.pt.trace.json"))


@pytest.mark.cuda
def test_a_model_with_dropout_stays_eager_and_says_why(corpus, tmp_path):
    _needs_card()
    tr = trainer(corpus, tmp_path, "cuda", feat_dropout=0.5)
    epochs_losses(tr, (0, 1))
    steps = 2 * tr.train_ds.steps_per_epoch(B)
    assert tr.step_graph_stats == {"eager": steps, "captures": 0, "replays": 0,
                                   "eager_reasons": {"dropout": steps}}
