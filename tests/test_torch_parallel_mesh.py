"""The port's mesh layer (``s2vt_tpu_torch/parallel/``) against JAX's.

The layout is held to ``s2vt_tpu/parallel/mesh.py::param_shardings`` on the
same models: the same leaves are split over the vocab (embedding,
out_linear.weight, out_linear.bias), and a vocab the model size does not
divide stays replicated. ``shard_state_dict`` / ``gather_state_dict``, the
mesh's groups and the errors of ``make_mesh`` and ``local_batch_size`` run in
four gloo processes at once (``spawn_gloo``, one spawn for every case); the
merge of kernel #8's shards runs in this process, since it is a pure
function of the gathered lists.

``spawn_gloo`` is also the harness of ``tests/test_torch_parallel.py``.
"""

import os
import pickle
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from s2vt_tpu_torch.config import Opt
from s2vt_tpu_torch.ops.fused_decode import argmax_linear_reference, argmax_linear_value
from s2vt_tpu_torch.parallel import distributed
from s2vt_tpu_torch.parallel import mesh as mesh_lib
from s2vt_tpu_torch.parallel.vocab import merge_argmax
from s2vt_tpu_torch.training.loop import build_model

WORLD = 4


# ---------------------------------------------------------------------------
# The harness: one spawn of gloo ranks runs a list of cases.
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    torch.set_num_threads(2)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=300)
    try:
        result = fn(rank, *args)
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_gloo(fn, args=(), world: int = WORLD, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined by a gloo
    group on localhost; returns each rank's (picklable) result, by rank. A
    rank that raises fails the spawn; ranks still running after
    ``timeout_s`` are killed and the spawn fails."""
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.spawn(_entry, args=(world, _free_port(), fn, args, out), nprocs=world,
                       join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks ran over {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
        results = []
        for r in range(world):
            with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# The cases run by every rank.
# ---------------------------------------------------------------------------

def _raises(fn, exc=ValueError) -> str:
    """The message of the ``exc`` that ``fn()`` raises ("" if none)."""
    try:
        fn()
    except exc as e:
        return str(e) or exc.__name__
    return ""


def _mesh_cases(rank, state):
    """Round trips, coordinates and errors on a world of four."""
    import torch.distributed as dist
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    distributed.initialize("127.0.0.1:1", 4, rank)        # a second call: nothing
    out["reinit_same_group"] = dist.get_world_size() == 4
    torch.manual_seed(0)
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = mesh_lib.make_mesh(shape, "cpu")
        d, m = mesh_lib.axis_rank(mesh, "data"), mesh_lib.axis_rank(mesh, "model")
        part = mesh_lib.shard_state_dict(state, mesh)
        back = mesh_lib.gather_state_dict(part, mesh, vocab_size=state["embedding.weight"].shape[0])
        out[shape] = {
            "coords": (d, m),
            "sizes": (mesh_lib.axis_size(mesh, "data"), mesh_lib.axis_size(mesh, "model")),
            "shapes": {k: tuple(v.shape) for k, v in part.items()},
            "rows": {k: v.numpy() for k, v in part.items() if mesh_lib.vocab_dim(k) is not None},
            "round_trip": all(torch.equal(back[k], state[k]) for k in state),
            "batch_rows": mesh_lib.batch_rows(8, mesh),
            "uneven_rows": mesh_lib.batch_rows(6, mesh, even=False),
        }
    out["default_shape"] = mesh_lib.axis_size(mesh_lib.make_mesh(None, "cpu"), "data")
    out["too_few"] = _raises(lambda: mesh_lib.make_mesh((2, 1), "cpu"))
    out["too_many"] = _raises(lambda: mesh_lib.make_mesh((4, 2), "cpu"))
    out["odd_batch"] = _raises(lambda: mesh_lib.batch_rows(6, mesh_lib.make_mesh((4, 1), "cpu")))
    out["local_batch"] = distributed.local_batch_size(8)
    out["local_batch_odd"] = _raises(lambda: distributed.local_batch_size(6))
    out["host_local"] = distributed.host_local_batch(np.arange(8))[0].tolist()
    return out


def _whole_state(V=32, H=16, E=8, F=6, L=5):
    model = build_model(Opt(dim_hidden=H, dim_embed=E, feat_dim=F, train_length=L), V)
    model.reset_parameters(torch.Generator().manual_seed(1))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def mesh_results():
    state = _whole_state()
    return state, spawn_gloo(_mesh_cases, (state,))


def test_ranks_and_reinitialize(mesh_results):
    _, res = mesh_results
    assert [r["rank"] for r in res] == list(range(WORLD))
    assert all(r["world"] == WORLD and r["reinit_same_group"] for r in res)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_shard_and_gather_round_trip(mesh_results, shape):
    """rank = d * tp + m; each rank holds rows [m V/tp, (m + 1) V/tp) of the
    three vocab leaves (AdamW's moments go through the same functions), the
    other leaves whole, and the gather gives back every tensor bit for bit."""
    state, res = mesh_results
    dp, tp = shape
    V = state["embedding.weight"].shape[0]
    for rank, r in enumerate(res):
        got = r[shape]
        assert got["coords"] == (rank // tp, rank % tp) and got["sizes"] == shape
        assert got["round_trip"]
        m = rank % tp
        for key, t in state.items():
            if mesh_lib.vocab_dim(key) is not None and tp > 1:
                assert got["shapes"][key] == (V // tp,) + tuple(t.shape[1:])
                np.testing.assert_array_equal(got["rows"][key],
                                              t.numpy()[m * V // tp:(m + 1) * V // tp])
            else:
                assert got["shapes"][key] == tuple(t.shape), key
        d = rank // tp
        assert got["batch_rows"] == (d * 8 // dp, (d + 1) * 8 // dp)
        step = -(-6 // dp)
        assert got["uneven_rows"] == (min(d * step, 6), min(d * step + step, 6))


def test_mesh_and_batch_errors(mesh_results):
    _, res = mesh_results
    for r in res:
        assert r["default_shape"] == WORLD
        assert "needs 2 ranks" in r["too_few"] and "needs 8 ranks" in r["too_many"]
        assert "not divisible" in r["odd_batch"]
        assert r["local_batch"] == 2 and "not divisible by 4" in r["local_batch_odd"]
    assert [r["host_local"] for r in res] == [[0, 1], [2, 3], [4, 5], [6, 7]]


# ---------------------------------------------------------------------------
# In this process: no process group.
# ---------------------------------------------------------------------------

def test_make_mesh_needs_a_fitting_group(monkeypatch):
    """As JAX's make_mesh raises where the devices do not fit the shape: with
    no process group the world is one process."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh((2, 1))
    with pytest.raises(ValueError, match="initialized process group"):
        mesh_lib.make_mesh((1, 1))
    with pytest.raises(ValueError, match="data, model"):
        mesh_lib.make_mesh((1, 1, 1))
    assert distributed.local_batch_size(6) == 6 and distributed.process_count() == 1
    assert mesh_lib.batch_rows(6, None) == (0, 6)


def test_initialize_without_a_coordinator(monkeypatch):
    """JAX's rules: a single process with no coordinator does nothing; an
    explicit multi-process configuration that cannot start raises."""
    import torch.distributed as dist
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    distributed.initialize(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")
    assert not dist.is_initialized()


def test_initialize_with_a_coordinator_and_no_card_raises(monkeypatch):
    """With a coordinator and no card, the default device is the card:
    initialize raises (utils/device.py::resolve_device) and nothing is
    initialized, rather than quietly starting a gloo group on the CPU; asked
    for the CPU, it starts gloo."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _free_port()
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                       ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    assert not dist.is_initialized()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert distributed.process_count() == 1 and distributed.process_index() == 0
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def _vocab_pick_cases(rank, h, w, b):
    """vocab.greedy_pick with use_pallas on a (1, 2) mesh's vocab shards:
    each pick's tokens and the calls of argmax_linear_value it made."""
    from s2vt_tpu_torch.ops import fused_decode
    from s2vt_tpu_torch.parallel import vocab
    shard = vocab.make_shard(mesh_lib.make_mesh((1, 2), "cpu"), w.shape[0])
    rows = slice(shard.offset, shard.offset + shard.rows)
    calls, out = [], {}
    value = fused_decode.argmax_linear_value
    fused_decode.argmax_linear_value = lambda *a: calls.append(a[1].shape) or value(*a)
    try:
        for cdt in (None, torch.bfloat16):
            for valid in (None, 20):
                calls.clear()
                pick = vocab.greedy_pick(w[rows], b[rows], valid, cdt, True, shard)
                out[(cdt is not None, valid)] = (pick(h), list(calls))
    finally:
        fused_decode.argmax_linear_value = value
    return out


@pytest.fixture(scope="module")
def vocab_picks():
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(16, 24, generator=gen)
    w, b = torch.randn(32, 24, generator=gen), torch.randn(32, generator=gen)
    return (h, w, b), spawn_gloo(_vocab_pick_cases, (h, w, b), world=2)


@pytest.mark.parametrize("valid", [None, 20])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_vocab_shard_picker_calls_the_kernel_per_shard(vocab_picks, bf16, valid):
    """On 2 vocab shards with use_pallas: one argmax_linear_value per shard
    and step, and every rank's tokens equal the whole-vocab plain pick
    exactly (valid 20: the upper shard all padding)."""
    from s2vt_tpu_torch.ops.fused_decode import greedy_pick
    (h, w, b), ranks = vocab_picks
    cdt = torch.bfloat16 if bf16 else None
    want = greedy_pick(w, b, valid, cdt, False)(h)
    for res in ranks:
        tokens, calls = res[(bf16, valid)]
        assert torch.equal(tokens, want)
        assert calls == [(16, 24)]


def _jax_sharded_leaves(jax_mod, model_kw, vocab, model_size):
    """The leaves that JAX's param_shardings splits over 'model', as port
    state_dict keys."""
    jax, jconfig, jloop, jmesh = jax_mod
    model = jloop.build_model(jconfig.Opt(**model_kw), vocab)
    L, F = model_kw["train_length"], model_kw["feat_dim"]
    params = model.init(jax.random.PRNGKey(0), np.zeros((2, L, F), np.float32),
                        np.zeros((2, L - 1), np.int32), mode="train",
                        deterministic=True)["params"]
    mesh = jmesh.make_mesh((2, model_size))
    sh = jmesh.param_shardings(mesh, params)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    out = set()
    for path, s in flat:
        if s.spec != jax.sharding.PartitionSpec():
            names = [getattr(k, "key", getattr(k, "name", None)) for k in path]
            out.add(".".join(names))
    return out


@pytest.fixture(scope="module")
def jax_mod():
    import importlib
    return tuple(importlib.import_module(n) for n in
                 ("jax", "s2vt_tpu.config", "s2vt_tpu.training.loop", "s2vt_tpu.parallel.mesh"))


@pytest.mark.parametrize("model", ["s2vt", "att_baseline"])
@pytest.mark.parametrize("vocab, model_size", [(32, 2), (32, 4), (30, 4)])
def test_vocab_layout_matches_jax(jax_mod, model, vocab, model_size):
    """The same leaves are split as in JAX's param_shardings; 30 rows over 4
    model ranks stay replicated on both sides."""
    kw = dict(model=model, dim_hidden=16, dim_embed=8, feat_dim=6, train_length=5)
    want = _jax_sharded_leaves(jax_mod, kw, vocab, model_size)
    port = build_model(Opt(**kw), vocab)
    got = {k for k, v in port.state_dict().items()
           if mesh_lib.vocab_sharded(k, v.shape, model_size)}
    assert got == want
    divisible = vocab % model_size == 0
    assert got == ({"embedding.weight", "out_linear.weight", "out_linear.bias"}
                   if divisible else set())


def test_merge_takes_the_first_maximum_across_shards():
    """Ties across shards go to the lowest global index, as torch.argmax
    picks it over the whole row; an all-padding shard (-inf) never wins."""
    inf = float("inf")
    vals = [torch.tensor([1.0, 2.0, -inf, 0.5]), torch.tensor([1.0, 3.0, -inf, 0.5]),
            torch.tensor([0.5, 3.0, -inf, -inf])]
    idx = [torch.tensor([3, 1, 0, 2]), torch.tensor([7, 5, 4, 6]), torch.tensor([8, 9, 8, 8])]
    tok, best = merge_argmax(vals, idx)
    assert tok.tolist() == [3, 5, 0, 2] and best.tolist() == [1.0, 3.0, -inf, 0.5]
    # Against torch.argmax over the whole vocab, ties built in on purpose.
    gen = torch.Generator().manual_seed(0)
    logits = torch.randint(0, 4, (64, 24), generator=gen).float()
    for tp in (2, 3, 4):
        rows = 24 // tp
        parts = logits.split(rows, dim=1)
        v = [p.amax(dim=1) for p in parts]
        i = [p.argmax(dim=1) + s * rows for s, p in enumerate(parts)]
        tok, best = merge_argmax(v, i)
        assert torch.equal(tok, logits.argmax(dim=1)) and torch.equal(best, logits.amax(dim=1))


def test_argmax_value_of_shards_merges_to_the_whole_vocab():
    """argmax_linear_value's plain version on each shard of W (valid count
    clamp(valid - offset, 0, V/tp); the last shard all padding) merges to
    the token and value of the launch over the whole vocab, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    B, H, V, valid = 16, 32, 64, 40
    h = torch.randn(B, H, generator=gen)
    w = torch.randn(V, H, generator=gen)
    b = torch.randn(V, generator=gen)
    for bf16 in (False, True):
        want_tok, want_val = argmax_linear_value(h, w, b, valid, bf16)
        assert torch.equal(want_tok, argmax_linear_reference(h, w, b, valid, bf16))
        for tp in (2, 4):
            rows = V // tp
            vals, idxs = [], []
            for s in range(tp):
                local = max(0, min(valid - s * rows, rows))
                tok, val = argmax_linear_value(h, w[s * rows:(s + 1) * rows].contiguous(),
                                               b[s * rows:(s + 1) * rows].contiguous(), local,
                                               bf16)
                if local == 0:
                    assert torch.isneginf(val).all()
                vals.append(val)
                idxs.append(tok + s * rows)
            tok, val = merge_argmax(vals, idxs)
            assert torch.equal(tok, want_tok) and torch.equal(val, want_val)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_batches_read_only_a_ranks_rows(tmp_path, backend):
    """VideoDataset.batches(feat_rows=(lo, hi)) reads the features of rows
    lo..hi-1 of each batch (the last batch short, or past its end) and
    keeps the whole batch's labels; as the whole batch sliced."""
    from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
    meta = make_synthetic_corpus(str(tmp_path), n_videos=30, feat_len=4, feat_dim=6, seed=1)
    ds = VideoDataset(meta["captions_file"], meta["feat_path"], max_len=4, backend=backend)
    if backend == "native" and ds.effective_backend() != "native":
        pytest.skip("the native loader does not build here")
    whole = list(ds.batches(8, epoch=1))
    for lo, hi in ((0, 4), (4, 8), (6, 8)):
        part = list(ds.batches(8, epoch=1, feat_rows=(lo, hi)))
        assert len(part) == len(whole)
        for w, p in zip(whole, part):
            np.testing.assert_array_equal(p.feats, w.feats[lo:hi])
            np.testing.assert_array_equal(p.labels, w.labels)
            assert p.ids == w.ids


def test_device_put_chunked_equals_one_copy():
    x = np.random.default_rng(0).normal(size=(37, 5, 3)).astype(np.float32)
    for dtype in (None, torch.bfloat16):
        whole = torch.from_numpy(x).to("cpu", dtype or torch.float32)
        got = mesh_lib.device_put_chunked(x, "cpu", dtype, chunk_bytes=64)
        assert got.dtype == whole.dtype and torch.equal(got, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16, w_bf16", [(False, False), (True, True), (True, False)],
                         ids=["f32-mma", "bf16-mma", "bf16-direct"])
def test_argmax_value_shards_on_card(bf16, w_bf16):
    """Kernel #8's value launch on the card, on both routes: on 2 and 4
    vocab shards (the last all padding), merged, the tokens and values of
    the launch over the whole vocab bit for bit, and its tokens those of
    argmax_linear; one launch per call, counted in argmax_linear.launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from s2vt_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, V, valid in ((16, 10240, 4000), (96, 10240, None), (5, 1000, 999)):
        h = torch.randn(B, 512, device="cuda", generator=gen)
        w = 0.05 * torch.randn(V, 512, device="cuda", generator=gen)
        w = w.to(torch.bfloat16) if w_bf16 else w
        b = torch.randn(V, device="cuda", generator=gen)
        route = fd.argmax_linear_route(512, w.dtype, bf16, (h.data_ptr(), w.data_ptr()))
        before = dict(fd.argmax_linear.route_launches)
        tok, val = fd.argmax_linear_value(h, w, b, valid, bf16)
        assert fd.argmax_linear.route_launches[route] == before[route] + 1
        assert torch.equal(tok, fd.argmax_linear(h, w, b, valid, bf16))
        for tp in (2, 4):
            rows = V // tp
            vals, idxs = [], []
            for s in range(tp):
                local = rows if valid is None else max(0, min(valid - s * rows, rows))
                t, v = fd.argmax_linear_value(h, w[s * rows:(s + 1) * rows],
                                              b[s * rows:(s + 1) * rows], local, bf16)
                vals.append(v)
                idxs.append(t + s * rows)
            got_tok, got_val = merge_argmax(vals, idxs)
            assert torch.equal(got_tok, tok) and torch.equal(got_val, val), (B, V, tp)
