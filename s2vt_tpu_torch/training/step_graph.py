"""A train step's forward, loss and backward as one CUDA graph.

On the card a train step is ~100 kernel launches (the fused recurrent
kernels, cuBLAS, elementwise), and the backward's are issued one by one by
autograd's device thread; at B=16 the host takes about as long to launch
them as the card takes to run them. ``StepGraph`` captures the step's
forward, loss, ``zero_grad`` and backward into one ``torch.cuda.CUDAGraph``
and replays it, so the host queues the step's kernels with one launch.
AdamW stays eager, on the gradients the graph writes.

The rule is a function of what the code can observe:

 - ``eager_reason``, once per Trainer: on a CPU device, with a mesh (the
   data group's collectives stay eager) or with any dropout rate above 0
   (the step would draw random numbers) every step runs eager, its reason
   counted;
 - ``step_mode``, per step: otherwise steps are keyed by the inputs' shapes
   and dtypes (``step_key``). The first step of a key runs eager: the
   warm-up, which loads the kernels' libraries and makes AdamW's state. The
   second captures the step and replays it once; every later step of the
   key replays it.

A captured step reads static input buffers: each step's batch is copied
into them on the current stream. Each parameter's ``.grad`` is the tensor
the captured backward allocated in the graph's private pool: a replay
writes it whole, nothing adds to it, and the parameter is pointed back at
it where an eager step (another key) set it to None. Each replay returns a
fresh copy of the static loss.

The capture runs in CUDA's thread-local capture mode: the feed's read-ahead
thread allocates pinned host memory and the checkpoint writer copies
tensors while the main thread captures, and the global mode would fail the
capture for those calls of other threads.

The kernels' launch counters (``ops/launches.py``) count launches made from
Python; a capture launches nothing and a replay runs no Python. So what a
capture counted is taken back from the counters, and added to them on
every replay.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from s2vt_tpu_torch.ops.launches import COUNTED
from s2vt_tpu_torch.utils.profiling import annotate

DROPOUT_RATES = ("feat_dropout", "rnn_dropout", "out_dropout")


def read_launches(counters) -> list:
    return [(fn.launches, dict(fn.route_launches)) for fn in counters]


def launches_since(counters, before: list) -> list:
    """(counter, launches, {route: launches}) of each counter that moved
    since ``before`` (``read_launches``)."""
    out = []
    for fn, (n, routes) in zip(counters, before):
        moved = {r: k - routes.get(r, 0) for r, k in fn.route_launches.items()
                 if k != routes.get(r, 0)}
        if fn.launches != n or moved:
            out.append((fn, fn.launches - n, moved))
    return out


def add_launches(launched: list, times: int) -> None:
    """Add ``times`` x ``launched`` (``launches_since``) to the counters."""
    for fn, n, routes in launched:
        fn.launches += times * n
        for route, k in routes.items():
            fn.route_launches[route] += times * k


def eager_reason(device_type: str, has_mesh: bool,
                 dropout_rates: Sequence[float]) -> Optional[str]:
    """Why every train step of a Trainer runs eager, or None where its
    steps may be graphed."""
    if device_type != "cuda":
        return "cpu"
    if has_mesh:
        return "mesh"
    if any(rate > 0 for rate in dropout_rates):
        return "dropout"
    return None


def step_key(inputs: Sequence[torch.Tensor]) -> tuple:
    """What a captured step is specific to: each input's shape and dtype."""
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


def step_mode(reason: Optional[str], key, warmed, captured) -> Tuple[str, Optional[str]]:
    """How a train step runs: ("eager", reason), ("capture", None) or
    ("replay", None). ``reason`` is the Trainer's ``eager_reason``;
    ``warmed`` holds the keys that ran their eager warm-up, ``captured``
    those that have a graph."""
    if reason is not None:
        return "eager", reason
    if key in captured:
        return "replay", None
    if key not in warmed:
        return "eager", "warmup"
    return "capture", None


class _Captured:
    """One captured step: its graph, static inputs, loss and gradients, and
    the launches one replay makes."""

    def __init__(self, inputs, forward_backward: Callable, params: Sequence[torch.Tensor]):
        self.inputs = tuple(t.clone() for t in inputs)
        counters = tuple(COUNTED.values())
        before = read_launches(counters)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.loss = forward_backward(*self.inputs, None)
        self.launched = launches_since(counters, before)
        add_launches(self.launched, -1)           # the capture ran nothing
        self.params = tuple(params)
        self.grads = tuple(p.grad for p in self.params)

    def replay(self, inputs) -> torch.Tensor:
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        add_launches(self.launched, 1)
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        return self.loss.clone()


class StepGraph:
    """The graphs of one Trainer's train steps (see the module's docstring).
    ``forward_backward(feats, labels, mask, valid, generator)`` runs a
    step's forward, loss, ``zero_grad`` and backward eagerly and returns the
    detached loss; ``stats`` counts the steps: {"eager", "captures",
    "replays", "eager_reasons": {reason: steps}}. Each step runs inside a
    span of its mode: ``s2vt.step.eager``, ``.capture`` or ``.replay``."""

    def __init__(self, model, device: torch.device, has_mesh: bool,
                 forward_backward: Callable):
        self.model, self.forward_backward = model, forward_backward
        rates = tuple(float(getattr(model, n, 0.0)) for n in DROPOUT_RATES)
        self.draws_random = any(rate > 0 for rate in rates)
        self.reason = eager_reason(device.type, has_mesh, rates)
        self.stats: Dict = {"eager": 0, "captures": 0, "replays": 0, "eager_reasons": {}}
        self._warmed: set = set()
        self._graphs: Dict[tuple, _Captured] = {}

    def step(self, inputs: tuple, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step's forward, loss and backward, eager or from its graph;
        the loss, a tensor of this step's own."""
        key = step_key(inputs)
        mode, reason = step_mode(self.reason, key, self._warmed, self._graphs)
        if mode == "eager":
            with annotate("s2vt.step.eager"):
                self.stats["eager"] += 1
                reasons = self.stats["eager_reasons"]
                reasons[reason] = reasons.get(reason, 0) + 1
                if reason == "warmup":
                    self._warmed.add(key)
                return self.forward_backward(*inputs, generator)
        if mode == "capture":
            with annotate("s2vt.step.capture"):
                graph = self._graphs[key] = _Captured(inputs, self.forward_backward,
                                                      list(self.model.parameters()))
                self.stats["captures"] += 1
                return graph.replay(inputs)
        with annotate("s2vt.step.replay"):
            self.stats["replays"] += 1
            return self._graphs[key].replay(inputs)
