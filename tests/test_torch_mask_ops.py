"""The port's RLE mask ops (``s2vt_tpu_torch/utils/mask.py`` over its own
``native/s2vt_mask.cpp``) against the JAX package's, bit for bit: each
public function on the same seeded numpy inputs, counts arrays equal,
strings equal byte for byte, IoU matrices equal in their float64 bits.

The JAX package builds its library into ``S2VT_NATIVE_CACHE`` (read at each
call), so this module points it at a private directory: it never writes the
shared cache beside another test process."""

import numpy as np
import pytest

from s2vt_tpu_torch.utils import mask as P
from s2vt_tpu.utils import mask as J

SHAPES = [(1, 1), (13, 7), (480, 640)]
KINDS = ["empty", "full", "random", "sparse", "blocks"]


@pytest.fixture(scope="module", autouse=True)
def private_jax_cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("S2VT_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
    yield
    mp.undo()


def make_mask(shape, kind, seed=0):
    h, w = shape
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(shape, np.uint8)
    if kind == "full":
        return np.ones(shape, np.uint8)
    if kind == "random":
        return (rng.random(shape) > 0.5).astype(np.uint8)
    if kind == "sparse":  # long runs, large counts
        return (rng.random(shape) > 0.999).astype(np.uint8)
    m = np.zeros(shape, np.uint8)  # blocks: a few filled rectangles
    for _ in range(4):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        m[y0:y0 + rng.integers(1, h + 1), x0:x0 + rng.integers(1, w + 1)] = 1
    return m


def same_rle(got, want):
    assert got["size"] == want["size"]
    assert got["counts"].dtype == want["counts"].dtype == np.uint32
    assert np.array_equal(got["counts"], want["counts"])


def same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_decode_area_bbox_string(shape, kind):
    m = make_mask(shape, kind, seed=shape[0] + len(kind))
    rle = P.encode(m)
    same_rle(rle, J.encode(m))
    dec = P.decode(rle)
    same_bits(dec, J.decode(rle))
    assert np.array_equal(dec, m)
    assert P.area(rle) == J.area(rle) == int(m.sum())
    same_bits(P.toBbox(rle), J.toBbox(rle))
    s = P.toString(rle)
    assert isinstance(s, bytes) and s == J.toString(rle)
    back = P.frString(s, *shape)
    same_rle(back, J.frString(s, *shape))
    same_rle(back, rle)


@pytest.mark.parametrize("intersect", [False, True], ids=["union", "intersection"])
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("shape", [(13, 7), (480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_merge(shape, k, intersect):
    masks = [make_mask(shape, KINDS[(i + k) % len(KINDS)], seed=10 * k + i) for i in range(k)]
    rles = [J.encode(m) for m in masks]
    got = P.merge(rles, intersect=intersect)
    same_rle(got, J.merge(rles, intersect=intersect))
    want = masks[0].astype(bool)
    for m in masks[1:]:
        want = (want & m.astype(bool)) if intersect else (want | m.astype(bool))
    assert np.array_equal(P.decode(got), want.astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(13, 7), (480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_iou_with_crowd_flags(shape, seed):
    rng = np.random.default_rng(seed)
    dts = [P.encode(make_mask(shape, KINDS[i % len(KINDS)], seed=seed * 7 + i)) for i in range(4)]
    gts = [P.encode(make_mask(shape, KINDS[(i + 2) % len(KINDS)], seed=seed * 11 + i))
           for i in range(5)]
    for iscrowd in ([int(c) for c in rng.integers(0, 2, 5)], [1, 0], []):
        same_bits(P.iou(dts, gts, iscrowd), J.iou(dts, gts, iscrowd))
    same_bits(P.iou([], gts, [0] * 5), J.iou([], gts, [0] * 5))
    same_bits(P.iou(dts, [], []), J.iou(dts, [], []))


def _boxes(rng, n, h, w):
    """[x, y, w, h] boxes on a half-pixel grid, some partly or wholly
    outside the image, some of zero width."""
    xy = rng.integers(-2 * w // 4, 2 * w + 2, (n, 2)) / 2.0
    wh = rng.integers(0, 2 * max(h, w), (n, 2)) / 2.0
    return np.concatenate([xy, wh], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bbox_iou(seed):
    rng = np.random.default_rng(seed)
    dt, gt = _boxes(rng, 9, 48, 64), _boxes(rng, 7, 48, 64)
    for iscrowd in ([int(c) for c in rng.integers(0, 2, 7)], [0] * 7, [1]):
        same_bits(P.bbox_iou(dt, gt, iscrowd), J.bbox_iou(dt, gt, iscrowd))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fr_bbox_rounds_half_to_even_and_clips(shape):
    h, w = shape
    rng = np.random.default_rng(h)
    boxes = [[0.5, 1.5, 2.5, 3.5], [-1.5, -0.5, w + 0.5, h + 2.5], [w - 0.5, h - 1.5, 4.5, 4.5],
             [w + 3, h + 3, 2, 2], [2.5, 2.5, 0.5, 0.5]] + _boxes(rng, 12, h, w).tolist()
    for box in boxes:
        got = P.frBbox(box, h, w)
        same_rle(got, J.frBbox(box, h, w))
        same_bits(P.toBbox(got), J.toBbox(got))


def test_rle_strings_round_trip_long_counts():
    """Counts up to the whole 480x640 canvas, deltas of both signs against
    the count two places back, and a hand-made string."""
    rng = np.random.default_rng(7)
    cases = [np.array([0, 480 * 640], np.uint32), np.array([480 * 640], np.uint32),
             rng.integers(0, 2 ** 20, 301).astype(np.uint32),
             np.array([5, 300000, 1, 2, 300000, 7, 0, 1], np.uint32),
             np.array([2 ** 32 - 1, 0, 1, 2 ** 32 - 1, 3], np.uint32)]
    for counts in cases:
        rle = {"size": [480, 640], "counts": counts}
        s = P.toString(rle)
        assert s == J.toString(rle)
        same_rle(P.frString(s, 480, 640), J.frString(s, 480, 640))
        assert np.array_equal(P.frString(s, 480, 640)["counts"], counts)
    for s in (b"", b"0", b"61X2", b"PPYo0"):
        same_rle(P.frString(s, 4, 5), J.frString(s, 4, 5))


POLYS = {
    "rectangle": [[2, 3, 9, 3, 9, 7, 2, 7]],
    "triangle": [[0, 0, 20, 0, 0, 20]],
    "union": [[0, 0, 4, 0, 4, 4, 0, 4], [6, 6, 9, 6, 9, 9, 6, 9]],
    "overlapping": [[1.5, 1.5, 11.25, 2.0, 6.0, 10.75], [3, 3, 14, 3, 14, 5, 3, 5]],
    "outside": [[-5.5, -3.0, 30.5, 4.0, 12.0, 40.0]],
    "concave": [[0, 0, 15, 0, 15, 15, 7.5, 5.5, 0, 15]],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(POLYS))
@pytest.mark.parametrize("shape", [(13, 7), (20, 16), (480, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fr_poly(shape, name):
    polys = POLYS[name]
    if shape == (480, 640):
        polys = [[v * 23.75 for v in p] for p in polys]
    got = P.frPoly(polys, *shape)
    same_rle(got, J.frPoly(polys, *shape))


def test_fr_poly_rectangle_is_its_box():
    got = P.frPoly(POLYS["rectangle"], 10, 12)
    same_rle(got, P.frBbox([2, 3, 7, 4], 10, 12))


def test_fr_poly_refuses_fewer_than_three_points():
    with pytest.raises(ValueError, match="3"):
        P.frPoly([[0, 0, 4, 4]], 8, 8)


def _py_objects():
    """Each input form of frPyObjects (built inside a test: the JAX library
    must not build before the private cache is set)."""
    rng = np.random.default_rng(3)
    h, w = 24, 30
    m = make_mask((h, w), "blocks", seed=4)
    counts = J.encode(m)["counts"].tolist()
    return {
        "bbox_array": rng.integers(-3, 35, (5, 4)) / 2.0,
        "uncompressed_dict": {"size": [h, w], "counts": counts},
        "uncompressed_list": [{"size": [h, w], "counts": counts},
                              {"size": [h, w], "counts": [h * w]}],
        "polygons": [[1, 1, 20.5, 2, 10, 18], [3, 3, 9, 3, 9, 9, 3, 9]],
        "polygons_as_arrays": [np.array([1, 1, 20.5, 2, 10, 18])],
        "mixed_boxes_and_polygons": [[2.5, 3.5, 10, 6], (0, 0, 12, 0, 12, 12, 0, 12)],
        "single_polygon": [0.5, 0.5, 25.0, 4.0, 12.5, 20.5],
        "single_box": (4.5, 5.5, 11.0, 7.5),
        "empty_list": [],
    }, h, w


PY_FORMS = ["bbox_array", "empty_list", "mixed_boxes_and_polygons", "polygons",
            "polygons_as_arrays", "single_box", "single_polygon", "uncompressed_dict",
            "uncompressed_list"]


@pytest.mark.parametrize("form", PY_FORMS)
def test_fr_py_objects(form):
    objs, h, w = _py_objects()
    assert sorted(objs) == PY_FORMS
    got, want = P.frPyObjects(objs[form], h, w), J.frPyObjects(objs[form], h, w)
    assert type(got) is type(want)
    if isinstance(want, dict):
        same_rle(got, want)
    else:
        assert len(got) == len(want)
        for g, x in zip(got, want):
            same_rle(g, x)


def test_fr_py_objects_and_decode_refuse_as_jax_does():
    for obj in ("abc", 3.0):
        with pytest.raises(TypeError):
            P.frPyObjects(obj, 4, 4)
        with pytest.raises(TypeError):
            J.frPyObjects(obj, 4, 4)
    bad = {"size": [4, 5], "counts": np.array([3, 30], np.uint32)}
    for mod in (P, J):
        with pytest.raises(ValueError, match="invalid RLE"):
            mod.decode(bad)
    same_rle(P.frUncompressedRLE({"size": [2, 3], "counts": [1, 2, 3]}),
             J.frUncompressedRLE({"size": [2, 3], "counts": [1, 2, 3]}))


def test_library_is_the_ports_own_build():
    """The port loads the library that utils/native_build.py compiles from
    s2vt_tpu_torch/native/s2vt_mask.cpp into build/native/, not the JAX
    package's."""
    from s2vt_tpu_torch.utils import native_build

    lib = P._load()
    assert lib._name == str(native_build.library_path("s2vt_mask"))
    assert native_build.library_path("s2vt_mask").parent == native_build.BUILD_DIR
    assert P._load() is lib and lib is not J._load()
