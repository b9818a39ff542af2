"""The two routes of the port's per-layer LSTM backward (ops/fused_rnn.py,
csrc/lstm_seq_bwd.cu).

``lstm_seq_bwd_route(H, B, compute_bf16, device)`` sends the bf16 widths and
batches that the "cluster" kernel serves (128 <= H <= 512, H % 128 == 0, B <=
256, with its clusters of 8 blocks co-resident and its shared memory within
the card's) to it and every other call, float32 included, to the "direct"
kernel; the card's properties come in as a ``CardProps`` of plain values
here. The cluster kernel splits dh = dgates @
W_hh over gate slices inside each cluster; ``test_gate_slices_cover_every_
unit_once`` runs that index arithmetic in numpy.

The ``cuda``-marked tests hold each route to the plain version on the card:
1e-4 in float32 and 1.5e-3 in bf16 (chip_smoke.py's SEQ_ATOL: every value is
stored float32, so only a flipped bf16 rounding of a product operand shows),
and check that each call launched once, on its route.
"""

import numpy as np
import pytest
import torch

from s2vt_tpu_torch.ops import fused_rnn
from s2vt_tpu_torch.ops.rnn import TorchRNN

H100 = fused_rnn.CardProps(132, 232448, 15)   # as an H100 SXM reports
ATOL = {False: 1e-4, True: 1.5e-3}


_BF16_ROUTES = [
    (512, 1, H100, "cluster"), (512, 16, H100, "cluster"), (512, 96, H100, "cluster"),
    (512, 200, H100, "cluster"), (512, 208, H100, "cluster"), (512, 209, H100, "direct"),
    (512, 256, H100, "direct"), (512, 257, H100, "direct"),
    (256, 16, H100, "cluster"), (256, 200, H100, "cluster"), (256, 256, H100, "direct"),
    (128, 8, H100, "cluster"), (384, 3, H100, "cluster"),
    (64, 3, H100, "direct"), (448, 16, H100, "direct"),
    (1000, 16, H100, "direct"), (1024, 16, H100, "direct"), (576, 16, H100, "direct"),
    (130, 5, H100, "direct"), (16, 4, H100, "direct"), (96, 16, H100, "direct"),
    # co-resident clusters of 8: H / 64 of them are needed
    (512, 16, fused_rnn.CardProps(132, 232448, 8), "cluster"),
    (512, 16, fused_rnn.CardProps(132, 232448, 7), "direct"),
    (512, 16, fused_rnn.CardProps(132, 232448, 0), "direct"),
    (256, 16, fused_rnn.CardProps(132, 232448, 4), "cluster"),
    (256, 16, fused_rnn.CardProps(132, 232448, 3), "direct"),
    # fewer SMs than blocks
    (512, 16, fused_rnn.CardProps(60, 232448, 15), "direct"),
    (512, 16, fused_rnn.CardProps(64, 232448, 15), "cluster"),
    # shared memory: B = 200 needs 222 KB, B = 96 138 KB
    (512, 200, fused_rnn.CardProps(132, 200 * 1024, 15), "direct"),
    (512, 96, fused_rnn.CardProps(132, 150 * 1024, 15), "cluster"),
    (512, 16, fused_rnn.CardProps(132, 100 * 1024, 15), "direct")]


def _route_id(*values):
    return "-".join(str(v) if not isinstance(v, fused_rnn.CardProps) else
                    f"sms{v.sms}-smem{v.smem_optin}-clusters{v.active_clusters}" for v in values)


@pytest.mark.parametrize("hidden,batch,props,bf16,want", [
    # the bf16 table (each case keeps the id it had before the route read the
    # mode), then float32 (always "direct", even where the cluster route serves)
    *(pytest.param(h, b, p, True, w, id=_route_id(h, b, p, w)) for h, b, p, w in _BF16_ROUTES),
    *(pytest.param(512, b, H100, bf16, w,
                   id=_route_id(512, b, H100, "bfloat16" if bf16 else "float32", w))
      for b in (16, 96) for bf16, w in ((False, "direct"), (True, "cluster"))),
    *(pytest.param(h, b, H100, False, "direct", id=_route_id(h, b, H100, "float32", "direct"))
      for h, b in ((512, 1), (512, 200), (256, 16), (128, 8), (1000, 16)))])
def test_route_by_width_batch_and_card(hidden, batch, props, bf16, want):
    assert fused_rnn.lstm_seq_bwd_route(hidden, batch, bf16, props) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cluster_smem_fits_every_checked_batch(bf16):
    """The batches chip_smoke.py checks fit an H100 block's opt-in shared
    memory; every block asks for at least 120 KB, so one block runs per
    SM."""
    sizes = [fused_rnn.cluster_smem_bytes(512, b, bf16) for b in (1, 16, 96, 200)]
    assert all(s <= 232448 for s in sizes) and min(sizes) == 120 * 1024
    assert sizes == sorted(sizes) and sizes[-1] > sizes[0]


@pytest.mark.parametrize("hidden,q", [(512, 8), (512, 4), (512, 16), (256, 8), (128, 8),
                                      (384, 8), (256, 4)])
def test_gate_slices_cover_every_unit_once(hidden, q):
    """The cluster route's decomposition of dh = dg @ W_hh: cluster p forms
    the columns J_p = {q' * H/Q + 8p + i} from the Q gate slices U_q (the
    4 gate rows of units [q * H/Q, (q + 1) * H/Q)), one per block; block
    (p, q) sums column 8q + i of every block's partial for its unit
    q * H/Q + 8p + i. Every unit is formed by exactly one block, and the sum
    is the product."""
    units = 8
    rng = np.random.default_rng(hidden + q)
    b = 3
    dg = rng.normal(size=(b, 4 * hidden))
    w = rng.normal(size=(4 * hidden, hidden))
    span, clusters = hidden // q, hidden // (units * q)
    dh = np.full((b, hidden), np.nan)
    for p in range(clusters):
        cols = [span * (n // units) + units * p + n % units for n in range(units * q)]
        partial = []
        for r in range(q):
            rows = [(k // span) * hidden + span * r + k % span for k in range(4 * span)]
            partial.append(dg[:, rows] @ w[np.ix_(rows, cols)])
        for r in range(q):
            for i in range(units):
                j = span * r + units * p + i
                assert np.isnan(dh[:, j]).all(), (p, r, i)
                dh[:, j] = sum(partial[s][:, units * r + i] for s in range(q))
    np.testing.assert_allclose(dh, dg @ w, rtol=1e-12, atol=1e-12)


def _cpu_inputs(seed, b=4, t=5, h=64):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    xp, h0, c0 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((t, b, 4 * h), (b, h), (b, h)))
    w = torch.from_numpy(rng.uniform(-k, k, (4 * h, h)).astype(np.float32))
    _, gates, cseq, _, _ = fused_rnn.lstm_seq_fwd_reference(xp, w, h0, c0, False)
    cprev = torch.cat([c0[None], cseq[:-1]])
    dout, dhT, dcT = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      for s in ((t, b, h), (b, h), (b, h)))
    return gates, cseq, cprev, w, dout, dhT, dcT


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(bf16):
    args = _cpu_inputs(1)
    before = (fused_rnn.lstm_seq_bwd.launches, dict(fused_rnn.lstm_seq_bwd.route_launches))
    got = fused_rnn.lstm_seq_bwd(*args, bf16)
    want = fused_rnn.lstm_seq_bwd_reference(*args, bf16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fused_rnn.lstm_seq_bwd.launches, fused_rnn.lstm_seq_bwd.route_launches) == before


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """A CUDA-typed tensor (a fake one here, with no card) in bf16 mode goes
    to the cluster route and the kernel's build, which raises without nvcc;
    the plain version is never called and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called = []
    monkeypatch.setattr(fused_rnn, "lstm_seq_bwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(fused_rnn, "card_props", lambda device: H100)
    routes = []
    plain_launch = fused_rnn.launch_bwd

    def launch(*a, **kw):
        routes.append(a[8])
        return plain_launch(*a, **kw)
    monkeypatch.setattr(fused_rnn, "launch_bwd", launch)
    before = fused_rnn.lstm_seq_bwd.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda") for a in _cpu_inputs(2, b=16, t=3, h=512)]
        with pytest.raises(RuntimeError):
            fused_rnn.lstm_seq_bwd(*args, True)
    assert called == [] and routes == ["cluster"]
    assert fused_rnn.lstm_seq_bwd.launches == before


def test_float32_cuda_tensor_takes_the_direct_route(monkeypatch):
    """Float32 goes to the direct route without asking the card for its
    clusters; the plain version is never called and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called, routes = [], []
    monkeypatch.setattr(fused_rnn, "lstm_seq_bwd_reference", lambda *a: called.append(a))
    monkeypatch.setattr(fused_rnn, "card_props", lambda device: called.append(device))

    def launch(*a, **kw):
        routes.append(a[8])
        raise RuntimeError("no card")
    monkeypatch.setattr(fused_rnn, "launch_bwd", launch)
    before = fused_rnn.lstm_seq_bwd.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(a.shape, device="cuda") for a in _cpu_inputs(2, b=16, t=3, h=512)]
        with pytest.raises(RuntimeError, match="no card"):
            fused_rnn.lstm_seq_bwd(*args, False)
    assert called == [] and routes == ["direct"]
    assert fused_rnn.lstm_seq_bwd.launches == before


def test_variant_tool_changes_one_piece_each():
    """tools/lstm_bwd_variants.py finds each piece of each route in the
    kernel source (with the shared headers written in place) by its exact
    text; each variant changes what it names and nothing else."""
    from s2vt_tpu_torch.tools import lstm_bwd_variants as tool
    src = tool.kernel_source()
    assert '#include "mma.cuh"' not in src and "void split_tf32(" in src
    direct, cluster = tool.direct_variants(src), tool.cluster_variants(src)
    assert direct["as_built"] == src and cluster["as_built"] == src
    for got, name, gone in ((direct, "no_barrier", tool._BARRIER),
                            (direct, "own_slice", tool._READ),
                            (direct, "no_products", tool._READ),
                            (direct, "one_pass", tool._PASSES),
                            (cluster, "q16", tool._Q),
                            (cluster, "sys_scope", tool._ST_WORD),
                            (cluster, "sys_scope", tool._LD_WORDS),
                            (cluster, "group_half", tool._GROUP),
                            (cluster, "rna_split", tool._SPLIT),
                            (cluster, "no_cluster_barrier", tool._CBARRIER),
                            (cluster, "no_push", tool._PUSH),
                            (cluster, "opaque_w", tool._W_SPLIT),
                            (cluster, "no_products", tool._PRODUCTS),
                            (cluster, "no_poll", tool._POLL)):
        assert src.count(gone) == 1 and gone not in got[name] and got[name] != src, name
        if name != "q16":
            assert len(got[name].splitlines()) == len(src.splitlines()), name


def test_variant_tool_adds_code_only_where_it_says():
    """The variants that add code (a second cluster-size attribute, a grid
    barrier, poll sleeps, phase clocks) keep every line of the source, in
    order, and add only their own lines; the shipped kernel has none of
    them."""
    import difflib
    from s2vt_tpu_torch.tools import lstm_bwd_variants as tool
    src = tool.kernel_source()
    cluster = tool.cluster_variants(src)
    for text in ("cudaFuncAttributeNonPortableClusterSizeAllowed", "atomicAdd(count",
                 "__nanosleep", "clock64", "mark("):
        assert text not in src, text
    added = {"q16": ["cudaFuncAttributeNonPortableClusterSizeAllowed"],
             "grid_barrier": ["atomicAdd(count, 1u);", "__threadfence();"],
             "poll_sleep": ["__nanosleep(100);"],
             "phase_clock": ["clock64()"] + [f"mark({ph});" for ph in range(-1, 7)]}
    for name, texts in added.items():
        got = cluster[name]
        diff = [d for d in difflib.ndiff(src.splitlines(), got.splitlines())
                if d[:2] in ("- ", "+ ")]
        removed = [d for d in diff if d.startswith("- ")]
        if name == "q16":
            assert len(removed) == 1 and removed[0].startswith(f"- {tool._Q}"), removed
        else:
            assert removed == [], (name, removed)
        new = "\n".join(d[2:] for d in diff if d.startswith("+ "))
        assert all(t in new for t in texts), (name, new)
    assert f"xch[{tool._TAIL} + ph]" in cluster["phase_clock"]
    assert len(tool.PHASES) == 7 and tool.TAIL_WORDS >= 7


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, b, t, h):
    """The backward's inputs on the card, from a plain forward run there."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 1.0 / h ** 0.5
    xp = torch.randn(t, b, 4 * h, device="cuda", generator=gen)
    w = (torch.rand(4 * h, h, device="cuda", generator=gen) * 2 - 1) * k
    h0, c0 = (0.5 * torch.randn(b, h, device="cuda", generator=gen) for _ in range(2))
    _, gates, cseq, _, _ = fused_rnn.lstm_seq_fwd_reference(xp, w, h0, c0, False)
    cprev = torch.cat([c0[None], cseq[:-1]])
    dout, dhT, dcT = (torch.randn(s, device="cuda", generator=gen)
                      for s in ((t, b, h), (b, h), (b, h)))
    return gates, cseq, cprev, w, dout, dhT, dcT


def _check(got, want, bf16, label):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g).all(), label
        err = (g - w).abs().max().item()
        assert err <= ATOL[bf16], (label, err)


def _routed_call(args, bf16, route):
    """One wrapper call; checks that it launched once, on ``route``."""
    fn = fused_rnn.lstm_seq_bwd
    before = dict(fn.route_launches)
    got = fn(*args, bf16)
    torch.cuda.synchronize()
    assert {k: fn.route_launches[k] - before[k] for k in before} == \
        {"cluster": 0, "direct": 0, "stream": 0, route: 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 80, 159])
@pytest.mark.parametrize("B", [1, 16, 96, 200])
def test_cluster_route_matches_plain_on_card(B, T, bf16):
    """H = 512 on the cluster route and on the direct route, on the same
    inputs, against the plain version: dxp, dh0 and dc0; the wrapper's own
    call on the route lstm_seq_bwd_route names (bf16 "cluster", float32
    "direct")."""
    _card()
    args = _card_inputs(B * 1000 + T, B, T, 512)
    route = fused_rnn.lstm_seq_bwd_route(512, B, bf16, "cuda")
    assert route == ("cluster" if bf16 else "direct")
    want = fused_rnn.lstm_seq_bwd_reference(*args, bf16)
    _check(_routed_call(args, bf16, route), want, bf16, (route, B, T, bf16))
    for forced in ("cluster", "direct"):
        got = fused_rnn.launch_bwd(*args, bf16, forced)
        torch.cuda.synchronize()
        _check(got, want, bf16, (forced, B, T, bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,B", [(128, 8), (256, 33), (384, 17)])
def test_other_widths_on_the_cluster_route(H, B, bf16):
    _card()
    assert fused_rnn.lstm_seq_bwd_route(H, B, True, "cuda") == "cluster"
    args = _card_inputs(H + B, B, 30, H)
    got = fused_rnn.launch_bwd(*args, bf16, "cluster")
    torch.cuda.synchronize()
    _check(got, fused_rnn.lstm_seq_bwd_reference(*args, bf16), bf16, (H, B, bf16))


@pytest.mark.cuda
def test_card_properties_and_the_source_agree():
    """The card holds the 8 clusters of 8 that H = 512 needs; the route's
    shared-memory and shape rules are the source's."""
    _card()
    props = fused_rnn.card_props("cuda")
    assert props.active_clusters >= 8 and fused_rnn.cluster_serves(512, 200, props)
    lib = fused_rnn._bwd_lib()
    rich = fused_rnn.CardProps(props.sms, 10 ** 9, 10 ** 6)
    for h in (64, 128, 256, 384, 448, 512, 576, 1000):
        for b in (1, 16, 96, 200, 256, 257):
            serves = bool(lib.lstm_seq_bwd_cluster_serves(h, b))
            assert serves == fused_rnn.cluster_serves(h, b, rich), (h, b)
            for bf16 in (False, True):
                if serves:
                    assert lib.lstm_seq_bwd_cluster_smem_bytes(h, b, int(bf16)) == \
                        fused_rnn.cluster_smem_bytes(h, b, bf16), (h, b, bf16)


@pytest.mark.cuda
def test_two_layer_torchrnn_gradients_on_the_cluster_route():
    """A 2-layer TorchRNN at H = 512 on the card against the CPU (plain)
    route: outputs and every gradient within 2e-3 (chip_smoke.py's
    GRAD_TOL), and both backward launches on the route lstm_seq_bwd_route
    names for float32 (the direct one: the cluster route serves the shape,
    in bf16)."""
    _card()
    b, t, h = 16, 24, 512
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(b, t, h)).astype(np.float32))
    m = TorchRNN(h, h, num_layers=2, use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(4))
    res = {}
    for dev in ("cpu", "cuda"):
        mm = TorchRNN(h, h, num_layers=2, use_pallas=True).to(dev)
        mm.load_state_dict(m.state_dict())
        before = dict(fused_rnn.lstm_seq_bwd.route_launches)
        out, _ = mm(xs.to(dev))
        out.square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            route = fused_rnn.lstm_seq_bwd_route(h, b, False, dev)
            assert route == "direct" and fused_rnn.cluster_serves(h, b, fused_rnn.card_props(dev))
            assert fused_rnn.lstm_seq_bwd.route_launches == {**before, route: before[route] + 2}
        res[dev] = [out.detach().cpu()] + [p.grad.cpu() for p in mm.parameters()]
    for g, w in zip(res["cuda"], res["cpu"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_repeated_launches_on_two_streams(bf16):
    """20 launches on each of two streams, in flight together: every result
    equals the first, so no launch reads another's flags or stale state."""
    _card()
    args = _card_inputs(99, 16, 80, 512)
    first = fused_rnn.lstm_seq_bwd(*args, bf16)
    _check(first, fused_rnn.lstm_seq_bwd_reference(*args, bf16), bf16, "first")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append([fused_rnn.lstm_seq_bwd(*args, bf16) for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for per_stream in outs for got in per_stream
               for g, w in zip(got, first))
