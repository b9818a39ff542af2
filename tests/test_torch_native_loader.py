"""The port's C++ prefetching loader and VideoDataset backends, on the CPU.

Every case of tests/test_native_loader.py on the port's loader
(``s2vt_tpu_torch/native/s2vt_loader.cpp`` through ``utils/native_build.py``);
then the port's ``VideoDataset`` batches against JAX's for the native, numpy
and preload backends over two epochs, ``prefetch_to_device`` against JAX's,
batches written into the caller's arrays (``feats_alloc``), concurrent
builds in two processes, and the build flags in the library's hash.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from s2vt_tpu_torch.data import dataset as port_dataset
from s2vt_tpu_torch.data.dataset import VideoDataset, make_synthetic_corpus
from s2vt_tpu_torch.data.native_loader import NativeFeatureLoader, native_available
from s2vt_tpu_torch.utils import native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native_available(), reason="g++ toolchain unavailable")


@pytest.fixture(scope="module")
def feat_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i in range(7):
        a = rng.normal(size=(10, 16)).astype(np.float32)
        p = root / f"clip{i}.npy"
        np.save(p, a)
        paths.append(str(p))
        arrays.append(a)
    return paths, arrays


def test_build():
    path = native_build.build_native("s2vt_loader")
    assert path.exists() and path == native_build.library_path("s2vt_loader")


def test_batches_bit_exact(feat_files):
    paths, arrays = feat_files
    loader = NativeFeatureLoader(paths, 10, 16, n_threads=3, queue_depth=2)
    order = [3, 0, 6, 2, 5, 1, 4]
    got = list(loader.iter_batches(order, batch=3))
    assert len(got) == 3
    flat = np.concatenate(got)[:len(order)]
    np.testing.assert_array_equal(flat, np.stack([arrays[i] for i in order]))
    np.testing.assert_array_equal(got[-1][1:], 0.0)   # padded tail rows are zero


@pytest.mark.parametrize("threads", [1, 3, 4])
def test_batches_of_wide_clips_bit_exact(tmp_path, threads):
    """Batches of MSVD-wide [65, 4096] clips, over two epochs, for pools of
    1, 3 and 4 threads."""
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(65, 4096)).astype(np.float32) for _ in range(5)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"w{i}.npy"))
        np.save(paths[-1], a)
    loader = NativeFeatureLoader(paths, 65, 4096, n_threads=threads, queue_depth=2)
    order = [4, 1, 3, 0, 2]
    for _ in range(2):
        got = list(loader.iter_batches(order, batch=3))
        np.testing.assert_array_equal(np.concatenate(got)[:5], np.stack([arrays[i] for i in order]))
        np.testing.assert_array_equal(got[-1][2:], 0.0)


def test_epoch_reuse_different_order(feat_files):
    paths, arrays = feat_files
    loader = NativeFeatureLoader(paths, 10, 16)
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [6, 5]):
        got = np.concatenate(list(loader.iter_batches(order, batch=2)))
        np.testing.assert_array_equal(got[:len(order)], np.stack([arrays[i] for i in order]))


def test_truncates_longer_files(tmp_path):
    a = np.arange(12 * 4, dtype=np.float32).reshape(12, 4)
    np.save(tmp_path / "x.npy", a)
    loader = NativeFeatureLoader([str(tmp_path / "x.npy")], 8, 4)
    got = next(loader.iter_batches([0], 1))
    np.testing.assert_array_equal(got[0], a[:8])


def test_pads_shorter_files(tmp_path):
    np.save(tmp_path / "x.npy", np.ones((3, 4), np.float32))
    loader = NativeFeatureLoader([str(tmp_path / "x.npy")], 8, 4)
    got = next(loader.iter_batches([0], 1))
    np.testing.assert_array_equal(got[0, :3], 1.0)
    np.testing.assert_array_equal(got[0, 3:], 0.0)


def test_videodataset_backend_parity(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=8, feat_len=10, feat_dim=12, seed=5)
    kw = dict(captions_file=corpus["captions_file"], feat_path=corpus["feat_path"], max_len=10,
              mode="train", seed=0)
    ds_np = VideoDataset(backend="numpy", **kw)
    ds_nat = VideoDataset(backend="native", **kw)
    assert ds_np.backend == "numpy" and ds_nat.backend == "native"
    for epoch in range(2):
        for a, b in zip(ds_np.batches(3, epoch=epoch), ds_nat.batches(3, epoch=epoch)):
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.valid, b.valid)
            assert a.ids == b.ids


def test_failure_raises(tmp_path):
    np.save(tmp_path / "good.npy", np.ones((4, 3), np.float32))
    (tmp_path / "bad.npy").write_bytes(b"not an npy file")
    loader = NativeFeatureLoader([str(tmp_path / "good.npy"), str(tmp_path / "bad.npy")], 4, 3)
    with pytest.raises(RuntimeError, match="failed to load"):
        list(loader.iter_batches([0, 1], batch=2))


def test_wrong_dtype_raises(tmp_path):
    np.save(tmp_path / "f64.npy", np.ones((4, 3), np.float64))
    loader = NativeFeatureLoader([str(tmp_path / "f64.npy")], 4, 3)
    with pytest.raises(RuntimeError, match="failed to load"):
        list(loader.iter_batches([0], batch=1))


@pytest.mark.parametrize("case", ["missing", "truncated"])
def test_missing_and_truncated_files_raise(tmp_path, case):
    np.save(tmp_path / "x.npy", np.ones((4, 3), np.float32))
    if case == "truncated":
        data = (tmp_path / "x.npy").read_bytes()
        (tmp_path / "x.npy").write_bytes(data[:-5])
    path = str(tmp_path / ("x.npy" if case == "truncated" else "gone.npy"))
    loader = NativeFeatureLoader([path], 4, 3)
    with pytest.raises(RuntimeError, match="1 feature file"):
        list(loader.iter_batches([0], batch=1))


def test_abandoned_epoch_then_new_epoch(feat_files):
    """Breaking out of an epoch mid-way must not corrupt the next one
    (begin() waits for the worker pool to quiesce)."""
    paths, arrays = feat_files
    loader = NativeFeatureLoader(paths, 10, 16, n_threads=3, queue_depth=2)
    for _ in range(5):
        it = loader.iter_batches([0, 1, 2, 3, 4, 5], batch=2)
        next(it)          # consume one batch
        it.close()        # abandon the epoch mid-flight
        order = [5, 4, 3]
        got = np.concatenate(list(loader.iter_batches(order, batch=2)))
        np.testing.assert_array_equal(got[:3], np.stack([arrays[i] for i in order]))


def test_abandoned_generator_still_referenced(feat_files):
    """A suspended old-epoch generator the caller still holds neither
    blocks the next epoch nor steals its batches; it stops when resumed."""
    paths, arrays = feat_files
    loader = NativeFeatureLoader(paths, 10, 16, n_threads=3, queue_depth=2)
    stale = loader.iter_batches([0, 1, 2, 3, 4, 5], batch=2)
    next(stale)
    order = [5, 4, 3]
    fresh = loader.iter_batches(order, batch=2)
    first = next(fresh)   # starting the new epoch supersedes the stale one
    assert list(stale) == []
    got = np.concatenate([first] + list(fresh))
    np.testing.assert_array_equal(got[:3], np.stack([arrays[i] for i in order]))


def test_dataset_break_mid_epoch_native(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=8, feat_len=10, feat_dim=12, seed=5)
    ds = VideoDataset(corpus["captions_file"], corpus["feat_path"], max_len=10, mode="train",
                      seed=0, backend="native")
    old_gen = ds.batches(3, epoch=0)
    next(old_gen)   # consume one batch, keep the generator referenced
    assert len(list(ds.batches(3, epoch=1))) == ds.steps_per_epoch(3)


def test_auto_backend_falls_back_on_incompatible_dtype(tmp_path):
    """A float64 .npy routes 'auto' to the numpy backend (which converts);
    'native' raises at init with the file named."""
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=6, feat_len=10, feat_dim=12, seed=1)
    kw = dict(captions_file=corpus["captions_file"], feat_path=corpus["feat_path"], max_len=10,
              mode="train", seed=0)
    victim = VideoDataset(backend="numpy", **kw).feat_paths[0]
    np.save(victim, np.load(victim).astype(np.float64))
    ds = VideoDataset(backend="auto", **kw)
    assert ds.backend == ds.effective_backend() == "numpy"
    assert all(np.isfinite(b.feats).all() for b in ds.batches(3, epoch=0))
    with pytest.raises(ValueError, match="native"):
        VideoDataset(backend="native", **kw)
    with pytest.raises(ValueError, match="backend"):
        VideoDataset(backend="cuda", **kw)


def test_auto_backend_falls_back_when_the_build_fails(tmp_path, monkeypatch):
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=6, feat_len=10, feat_dim=12, seed=1)
    kw = dict(captions_file=corpus["captions_file"], feat_path=corpus["feat_path"], max_len=10,
              mode="train", seed=0)

    def broken(*a, **k):
        raise RuntimeError("no compiler")

    monkeypatch.setattr("s2vt_tpu_torch.data.native_loader.NativeFeatureLoader", broken)
    ds = VideoDataset(backend="auto", **kw)
    assert ds.backend == "native" and ds.effective_backend() == "numpy"
    with pytest.raises(RuntimeError, match="no compiler"):
        VideoDataset(backend="native", **kw).effective_backend()


@pytest.fixture(scope="module")
def jax_dataset():
    return pytest.importorskip("s2vt_tpu.data.dataset")


@pytest.mark.parametrize("backend", ["native", "numpy", "preload"])
def test_batches_equal_jax(tmp_path, jax_dataset, backend):
    """The port's batches equal JAX's VideoDataset's (feats, labels, mask,
    valid, ids, rows) for each backend over two epochs, both splits; ragged
    feature files are cut or padded alike."""
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=14, feat_len=10, feat_dim=12, seed=2)
    ragged = sorted(os.listdir(corpus["feat_path"]))
    for name, rows in ((ragged[0], 7), (ragged[1], 13)):
        np.save(os.path.join(corpus["feat_path"], name),
                np.full((rows, 12), rows, np.float32))
    kw = dict(preload=True) if backend == "preload" else dict(backend=backend)
    for mode in ("train", "valid"):
        args = (corpus["captions_file"], corpus["feat_path"])
        ours = VideoDataset(*args, max_len=9, mode=mode, seed=4, **kw)
        theirs = jax_dataset.VideoDataset(*args, max_len=9, mode=mode, seed=4, **kw)
        assert ours.effective_backend() == theirs.effective_backend()
        for epoch in range(2):
            got = list(ours.batches(3, epoch=epoch))
            want = list(theirs.batches(3, epoch=epoch))
            assert len(got) == len(want) == ours.steps_per_epoch(3)
            for a, b in zip(got, want):
                for field in ("feats", "labels", "mask", "valid", "rows"):
                    x, y = getattr(a, field), getattr(b, field)
                    assert x.dtype == y.dtype, field
                    np.testing.assert_array_equal(x, y, err_msg=field)
                assert a.ids == b.ids


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_batches_write_into_the_callers_arrays(tmp_path, backend):
    """feats_alloc: each batch's features land in a fresh array the caller
    hands over, equal to the batches without it (padding rows zeroed)."""
    corpus = make_synthetic_corpus(str(tmp_path), n_videos=10, feat_len=6, feat_dim=8, seed=3)
    ds = VideoDataset(corpus["captions_file"], corpus["feat_path"], max_len=6, seed=1,
                      backend=backend)
    given = []

    def alloc():
        given.append(np.full((4, 6, 8), np.nan, np.float32))
        return given[-1]

    got = list(ds.batches(4, epoch=1, feats_alloc=alloc))
    want = list(ds.batches(4, epoch=1))
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feats, b.feats)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert all(any(a.feats is g for g in given) for a in got)
    if backend == "native":
        with pytest.raises(ValueError, match="alloc"):
            next(ds.batches(4, feats_alloc=lambda: np.zeros((4, 6, 8), np.float64)))


@pytest.mark.parametrize("depth", [1, 2, 3, 7])
def test_prefetch_to_device_yields_jaxs_sequence(jax_dataset, depth):
    """The same (batch, put) pairs in the same order as JAX's, with each put
    made ``depth`` - 1 batches ahead of its consumer."""
    calls, consumed = [], []

    def put(b):
        calls.append((b, len(consumed)))
        return ("put", b)

    got = []
    for batch, dev in port_dataset.prefetch_to_device(iter(range(5)), put, depth):
        consumed.append(batch)
        got.append((batch, dev))
    want = list(jax_dataset.prefetch_to_device(iter(range(5)), lambda b: ("put", b), depth))
    assert got == want
    assert [seen for _, seen in calls] == [max(0, i - depth + 1) for i in range(5)]


_BUILD_AND_LOAD = """
import ctypes, pathlib, sys
from s2vt_tpu_torch.utils import native_build
native_build.BUILD_DIR = pathlib.Path(sys.argv[1])
lib = ctypes.CDLL(str(native_build.build_native("s2vt_loader")))
lib.s2vt_loader_create.restype = ctypes.c_void_p
lib.s2vt_loader_destroy.argtypes = [ctypes.c_void_p]
h = lib.s2vt_loader_create(None, 0, ctypes.c_long(4), ctypes.c_long(3), 2, 2)
lib.s2vt_loader_destroy(ctypes.c_void_p(h))
print("ok")
"""


def test_concurrent_builds_in_two_processes(tmp_path):
    """Two processes build the loader into one empty directory at once: both
    load a whole library, and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip() == "ok" for o, _ in outs)
    assert [p.name for p in tmp_path.iterdir()] == [native_build.library_path("s2vt_loader").name]


def test_build_flags_are_in_the_librarys_hash(monkeypatch):
    """-pthread (the loader's thread pool) is a flag, and the flags are part
    of the library's name, so a change of flags builds anew."""
    assert "-pthread" in native_build.GXX_FLAGS
    before = native_build.library_path("s2vt_loader")
    monkeypatch.setattr(native_build, "GXX_FLAGS",
                        tuple(f for f in native_build.GXX_FLAGS if f != "-pthread"))
    assert native_build.library_path("s2vt_loader") != before


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_read_ahead_yields_the_sequence(depth):
    """read_ahead gives the items in order, at most ``depth`` ahead of the
    consumer, on another thread (none for depth 0)."""
    import threading
    made = []

    def items():
        for i in range(6):
            made.append((i, threading.current_thread() is threading.main_thread()))
            yield i

    got = []
    for x in port_dataset.read_ahead(items(), depth):
        assert len(made) <= len(got) + max(depth, 0) + 2
        got.append(x)
    assert got == list(range(6))
    assert all(main == (depth < 1) for _, main in made)


def test_read_ahead_raises_and_stops_early():
    """The producer's exception reaches the consumer; a consumer that stops
    early closes the producer (its finally runs) and the thread ends."""
    import threading

    def failing():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(port_dataset.read_ahead(failing(), 2))
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    gen = port_dataset.read_ahead(endless(), 2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert closed.wait(5)
    assert not [t for t in threading.enumerate() if t.name == "read_ahead"]
