"""The port's COCO dataset API and detection evaluator
(``s2vt_tpu_torch/cocotools``) against the JAX package's, exactly: on
seeded COCO-format sets (boxes, polygons, uncompressed and string RLE
crowds, keypoints, tied scores, ground truths outside the area ranges)
every query, ``annToRLE`` / ``annToMask``, ``loadRes`` from a list, a JSON
file and an [N, 7] array, and ``evaluate`` / ``accumulate`` / ``summarize``
for each iouType with and without categories: ``ious``, ``evalImgs``,
``eval``'s arrays, ``stats`` and the printed table equal, float64 bit for
bit. A caption round trip (``COCO.loadRes`` -> ``COCOEvalCap``) ties the
slice to the captioner.

``loadRes`` and ``evaluate`` write into the annotation dicts they are given,
so each package gets its own copy of every input. The JAX package builds its
mask library into ``S2VT_NATIVE_CACHE``, pointed here at a private
directory."""

import copy
import json
import sys

import numpy as np
import pytest

from s2vt_tpu_torch import cocotools as P
from s2vt_tpu_torch.evaluation import COCOEvalCap
from s2vt_tpu import cocotools as J
from s2vt_tpu.utils import mask as Jmask

pytest.importorskip("flax", reason="the JAX reference package needs flax")

from s2vt_tpu import evaluation as jevaluation  # noqa: E402

IMG_SHAPES = [(64, 96), (120, 160), (100, 100), (48, 64), (150, 200), (80, 120), (40, 40)]
CATS = [{"id": 1, "name": "person", "supercategory": "human"},
        {"id": 3, "name": "dog", "supercategory": "animal"},
        {"id": 7, "name": "cat", "supercategory": "animal"}]
SCORES = (0.25, 0.5, 0.5, 0.75, 0.9)  # drawn with ties
N_KP = 17


@pytest.fixture(scope="module", autouse=True)
def private_jax_cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("S2VT_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
    yield
    mp.undo()


def np_rle_counts(m: np.ndarray) -> list:
    """Column-major run lengths of a binary mask, starting with zeros."""
    flat = m.T.reshape(-1).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return np.diff(np.concatenate([[0], edges])).tolist()


def shoelace(xy) -> float:
    x, y = np.asarray(xy[0::2], float), np.asarray(xy[1::2], float)
    return float(abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))) / 2)


def _box(rng, h, w):
    """An [x, y, w, h] box on a half-pixel grid, at least 4 pixels a side,
    at most half of it outside the image."""
    bw = rng.integers(8, 2 * w) / 2.0
    bh = rng.integers(8, 2 * h) / 2.0
    x = rng.integers(-bw // 2, 2 * w - bw) / 2.0
    y = rng.integers(-bh // 2, 2 * h - bh) / 2.0
    return [x, y, bw, bh]


def _polygon(rng, box):
    """3-8 points at sorted angles on the ellipse inscribed in the box, on a
    quarter-pixel grid: convex, so its raster is not empty."""
    x, y, bw, bh = box
    t = np.sort(rng.random(int(rng.integers(3, 9)))) * 2 * np.pi
    xy = np.stack([x + bw / 2 * (1 + np.cos(t)), y + bh / 2 * (1 + np.sin(t))], 1)
    return np.round(xy.reshape(-1) * 4) / 4


def _keypoints(rng, box, labelled=True):
    x, y, bw, bh = box
    v = rng.integers(0, 3, N_KP) if labelled else np.zeros(N_KP, int)
    xs, ys = x + rng.random(N_KP) * bw, y + rng.random(N_KP) * bh
    kp = np.stack([np.round(xs, 2), np.round(ys, 2), v], 1).reshape(-1)
    return kp.tolist(), int(np.count_nonzero(v))


def make_gt(seed: int) -> dict:
    """Images of several sizes (one with no annotations, one with 40), three
    categories in two supercategories, polygon instances and RLE crowds
    (uncompressed counts and compressed strings), every annotation with
    keypoints (some with none labelled)."""
    rng = np.random.default_rng(seed)
    images = [{"id": 10 + i, "height": h, "width": w, "file_name": f"{10 + i}.jpg"}
              for i, (h, w) in enumerate(IMG_SHAPES)]
    anns = []
    for i, img in enumerate(images[:-1]):
        h, w = img["height"], img["width"]
        # one image with more ground truths than numpy's small-array sort
        # (16), so that an unstable sort would reorder ties
        for _ in range(40 if i == 1 else int(rng.integers(1, 8))):
            box = _box(rng, h, w)
            kind = rng.choice(["poly", "poly2", "rle_list", "rle_str"], p=[0.5, 0.2, 0.15, 0.15])
            ann = {"id": 100 + len(anns), "image_id": img["id"],
                   "category_id": int(rng.choice([c["id"] for c in CATS])), "bbox": box}
            if kind.startswith("poly"):
                polys = [_polygon(rng, box) for _ in range(1 if kind == "poly" else 2)]
                ann["segmentation"] = [p.tolist() for p in polys]
                ann["area"] = sum(shoelace(p) for p in polys)
                ann["iscrowd"] = 0
            else:
                m = np.zeros((h, w), np.uint8)
                x0, y0 = max(int(box[0]), 0), max(int(box[1]), 0)
                m[y0:y0 + int(box[3]) + 1, x0:x0 + int(box[2]) + 1] = 1
                m &= (rng.random((h, w)) > 0.2).astype(np.uint8)
                counts = np_rle_counts(m)
                if kind == "rle_str":
                    counts = Jmask.toString({"size": [h, w], "counts": counts}).decode()
                ann["segmentation"] = {"size": [h, w], "counts": counts}
                ann["area"] = float(m.sum())
                ann["iscrowd"] = 1
            ann["keypoints"], ann["num_keypoints"] = _keypoints(rng, box, rng.random() > 0.2)
            anns.append(ann)
    return {"info": {"description": "seeded COCO-format set", "year": 2024},
            "images": images, "categories": CATS, "annotations": anns}


def _jitter(rng, box, scale):
    x, y, bw, bh = box
    d = rng.integers(-scale, scale + 1, 4) / 2.0
    return [x + d[0], y + d[1], max(bw + d[2], 0.5), max(bh + d[3], 0.5)]


def make_dets(gt: dict, iou_type: str, seed: int) -> list:
    """Detections near most ground truths (some twice, some in the wrong
    category: jittered boxes, polygons and keypoints; a crowd's masks as
    RLE) and false positives, with tied scores."""
    rng = np.random.default_rng(seed)
    imgs = {i["id"]: i for i in gt["images"]}
    dets = []

    def add(image_id, cat, box):
        h, w = imgs[image_id]["height"], imgs[image_id]["width"]
        det = {"image_id": image_id, "category_id": cat,
               "score": float(rng.choice(SCORES))}
        if iou_type == "bbox":
            det["bbox"] = box
        elif iou_type == "segm":
            form = rng.choice(["poly", "rle_str", "rle_list"])
            if form == "poly":
                det["segmentation"] = [_polygon(rng, box).tolist()]
            else:
                m = np.zeros((h, w), np.uint8)
                x0, y0 = max(int(box[0]), 0), max(int(box[1]), 0)
                m[y0:y0 + int(box[3]) + 1, x0:x0 + int(box[2]) + 1] = 1
                counts = np_rle_counts(m)
                if form == "rle_str":
                    counts = Jmask.toString({"size": [h, w], "counts": counts}).decode()
                det["segmentation"] = {"size": [h, w], "counts": counts}
        else:
            det["keypoints"] = _keypoints(rng, box)[0]
        dets.append(det)

    for ann in gt["annotations"]:
        for _ in range(int(rng.choice([0, 1, 1, 2]))):
            cat = ann["category_id"] if rng.random() > 0.15 else int(rng.choice([1, 3, 7]))
            if iou_type == "segm" and isinstance(ann["segmentation"], list):
                dets.append({"image_id": ann["image_id"], "category_id": cat,
                             "segmentation": [(np.asarray(p) + rng.integers(-2, 3, len(p)) / 2)
                                              .tolist() for p in ann["segmentation"]],
                             "score": float(rng.choice(SCORES))})
            elif iou_type == "keypoints":
                det_kp = np.asarray(ann["keypoints"], float).reshape(-1, 3)
                det_kp[:, :2] += rng.normal(0, 1.5, (N_KP, 2)).round(2)
                dets.append({"image_id": ann["image_id"], "category_id": cat,
                             "keypoints": det_kp.reshape(-1).tolist(),
                             "score": float(rng.choice(SCORES))})
            else:
                add(ann["image_id"], cat, _jitter(rng, ann["bbox"], 3))
    for img in gt["images"]:
        for _ in range(int(rng.integers(0, 4))):
            add(img["id"], int(rng.choice([1, 3, 7])), _box(rng, img["height"], img["width"]))
    return dets


def assert_same(a, b, path="value"):
    """Equal structure, types and values; arrays and floats bit for bit."""
    if isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b), path
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert type(b) is float and np.float64(a).tobytes() == np.float64(b).tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module")
def gt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("coco") / "instances.json"
    path.write_text(json.dumps(make_gt(0)))
    return str(path)


def both(gt_file):
    return P.COCO(gt_file), J.COCO(gt_file)


def test_index_and_queries(gt_file, capsys):
    ours, theirs = both(gt_file)
    assert_same(ours.dataset, theirs.dataset)
    for name in ("anns", "cats", "imgs", "imgToAnns", "catToImgs"):
        assert_same(dict(getattr(ours, name)), dict(getattr(theirs, name)), name)
    ann_ids = theirs.getAnnIds()
    queries = [
        ("getAnnIds", {}), ("getAnnIds", {"imgIds": 11}), ("getAnnIds", {"imgIds": [12, 10, 99]}),
        ("getAnnIds", {"catIds": 3}), ("getAnnIds", {"catIds": [7, 1]}),
        ("getAnnIds", {"areaRng": [32.0 ** 2, 96.0 ** 2]}), ("getAnnIds", {"iscrowd": True}),
        ("getAnnIds", {"iscrowd": False}),
        ("getAnnIds", {"imgIds": [10, 11, 13], "catIds": [1], "areaRng": [0, 1e3],
                       "iscrowd": False}),
        ("getCatIds", {}), ("getCatIds", {"catNms": ["dog", "cat"]}),
        ("getCatIds", {"supNms": "animal"}), ("getCatIds", {"catIds": [7, 2]}),
        ("getCatIds", {"catNms": ["person"], "supNms": ["human"], "catIds": 1}),
        ("getImgIds", {}), ("getImgIds", {"imgIds": [14, 11]}), ("getImgIds", {"catIds": 7}),
        ("getImgIds", {"catIds": [1, 3]}), ("getImgIds", {"imgIds": [10, 11, 12], "catIds": [3]}),
        ("loadAnns", {"ids": ann_ids[3]}), ("loadAnns", {"ids": ann_ids[::2]}),
        ("loadCats", {"ids": 3}), ("loadCats", {"ids": [7, 1]}),
        ("loadImgs", {"ids": 16}), ("loadImgs", {"ids": (10, 12)}),
    ]
    for name, kw in queries:
        assert_same(getattr(ours, name)(**kw), getattr(theirs, name)(**kw), f"{name}({kw})")
    ours.info()
    printed = capsys.readouterr().out
    theirs.info()
    assert printed == capsys.readouterr().out and "seeded" in printed


def test_ann_to_rle_and_mask(gt_file):
    ours, theirs = both(gt_file)
    kinds = set()
    for ann_id in theirs.getAnnIds():
        a, b = ours.loadAnns(ann_id)[0], theirs.loadAnns(ann_id)[0]
        segm = b["segmentation"]
        kinds.add("poly" if isinstance(segm, list) else type(segm["counts"]).__name__)
        rle = ours.annToRLE(a)
        assert_same(rle, theirs.annToRLE(b))
        m = ours.annToMask(a)
        assert_same(m, theirs.annToMask(b))
        assert m.shape == (ours.imgs[a["image_id"]]["height"], ours.imgs[a["image_id"]]["width"])
    assert kinds == {"poly", "list", "str"}


@pytest.mark.parametrize("iou_type,source", [
    ("bbox", "list"), ("bbox", "json"), ("bbox", "array"), ("segm", "list"), ("segm", "json"),
    ("keypoints", "list"), ("keypoints", "json")])
def test_load_res(gt_file, tmp_path, iou_type, source):
    dets = make_dets(make_gt(0), iou_type, seed=1)
    ours, theirs = both(gt_file)
    if source == "list":
        inputs = copy.deepcopy(dets), copy.deepcopy(dets)
    elif source == "json":
        path = tmp_path / "results.json"
        path.write_text(json.dumps(dets))
        inputs = str(path), str(path)
    else:
        arr = np.array([[d["image_id"], *d["bbox"], d["score"], d["category_id"]] for d in dets])
        inputs = arr.copy(), arr.copy()
    res_p, res_j = ours.loadRes(inputs[0]), theirs.loadRes(inputs[1])
    assert_same(res_p.dataset, res_j.dataset)
    for name in ("anns", "imgs", "cats", "imgToAnns", "catToImgs"):
        assert_same(dict(getattr(res_p, name)), dict(getattr(res_j, name)), name)


def test_load_res_refuses_as_jax_does(gt_file):
    ours, theirs = both(gt_file)
    foreign = [{"image_id": 999, "category_id": 1, "bbox": [0, 0, 1, 1], "score": 0.5}]
    for coco in (ours, theirs):
        with pytest.raises(ValueError, match="correspond"):
            coco.loadRes(copy.deepcopy(foreign))
        with pytest.raises(TypeError, match="list"):
            coco.loadRes({"image_id": 10})


def _evaluate(coco_mod, gt_file, dets, iou_type, use_cats, custom, capsys):
    coco = coco_mod.COCO(gt_file)
    E = coco_mod.COCOeval(coco, coco.loadRes(copy.deepcopy(dets)), iouType=iou_type)
    E.params.useCats = use_cats
    if custom:
        E.params.maxDets = [20, 1, 5]
        E.params.areaRng = [[0, 1e10], [0, 30.0 ** 2], [30.0 ** 2, 70.0 ** 2], [70.0 ** 2, 1e10]]
        E.params.imgIds = [15, 10, 11, 12, 16, 10]
    E.evaluate()
    E.accumulate()
    E.summarize()
    printed = capsys.readouterr().out
    assert str(E) == ""
    assert capsys.readouterr().out == printed
    return E, printed


@pytest.mark.parametrize("iou_type,use_cats,custom", [
    ("bbox", 1, False), ("bbox", 0, False), ("segm", 1, False), ("segm", 0, False),
    ("keypoints", 1, False), ("keypoints", 0, False), ("bbox", 1, True), ("segm", 1, True)])
def test_cocoeval_matches_jax(gt_file, capsys, iou_type, use_cats, custom):
    dets = make_dets(make_gt(0), iou_type, seed=2)
    ours, printed_p = _evaluate(P, gt_file, dets, iou_type, use_cats, custom, capsys)
    theirs, printed_j = _evaluate(J, gt_file, dets, iou_type, use_cats, custom, capsys)
    assert printed_p == printed_j
    assert len(printed_p.splitlines()) == (10 if iou_type == "keypoints" else 12)
    assert_same(ours.ious, theirs.ious, "ious")
    assert_same(ours.evalImgs, theirs.evalImgs, "evalImgs")
    assert sum(e is not None for e in ours.evalImgs) > 0
    assert_same(vars(ours.params), vars(theirs.params), "params")
    assert ours.eval["counts"] == theirs.eval["counts"]
    for key in ("precision", "recall", "scores"):
        assert_same(ours.eval[key], theirs.eval[key], key)
    assert_same(ours.stats, theirs.stats, "stats")
    # Without categories computeOks reads the (image, -1) lists, which are
    # empty, as pycocotools' does: no keypoint detection matches.
    assert (ours.eval["precision"] > 0).any() == (iou_type != "keypoints" or bool(use_cats))


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
def test_detections_equal_to_the_ground_truth_score_one(tmp_path, capsys, iou_type):
    """Every non-crowd annotation detected as itself: AP over all areas is 1
    in both packages."""
    gt = make_gt(4)
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    kept = [a for a in gt["annotations"] if not a["iscrowd"]]
    if iou_type == "keypoints":
        kept = [a for a in kept if a["num_keypoints"] > 0]
    key = {"bbox": "bbox", "segm": "segmentation", "keypoints": "keypoints"}[iou_type]
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"], key: a[key],
             "score": 0.5} for a in kept]
    stats = []
    for mod in (P, J):
        E, _ = _evaluate(mod, str(path), dets, iou_type, 1, False, capsys)
        stats.append(E.stats)
    assert_same(stats[0], stats[1])
    assert stats[0][0] == 1.0


def test_show_anns_and_download_as_jax_does(gt_file, monkeypatch, capsys):
    ours, theirs = both(gt_file)
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.collections",
                 "matplotlib.patches"):
        monkeypatch.setitem(sys.modules, name, None)
    anns = theirs.loadAnns(theirs.getAnnIds(imgIds=10))
    for coco in (ours, theirs):
        assert coco.showAnns([]) == 0
        with pytest.raises(RuntimeError, match="matplotlib"):
            coco.showAnns(copy.deepcopy(anns))
    captions = [{"image_id": 10, "caption": "a dog runs"}, {"image_id": 10, "caption": "cats"}]
    printed = []
    for coco in (ours, theirs):
        assert coco.showAnns(captions) is None
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] == "a dog runs\ncats\n"
    messages = []
    for coco in (ours, theirs):
        with pytest.raises(RuntimeError) as err:
            coco.download("images", [10])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


WORDS = ["a", "man", "woman", "dog", "cat", "is", "playing", "riding", "the", "guitar", "bike",
         "on", "road", "slicing", "an", "onion", "."]


def test_caption_round_trip_matches_jax(tmp_path):
    """A COCO captions file through COCO(...).loadRes(results), then the
    gts / res dicts from imgToAnns into COCOEvalCap: the port's scores equal
    the JAX pipeline's to 1e-12."""
    rng = np.random.default_rng(6)

    def sentence():
        return " ".join(rng.choice(WORDS, int(rng.integers(3, 10))))

    images = [{"id": 200 + i, "file_name": f"{i}.jpg", "height": 240, "width": 320}
              for i in range(12)]
    anns = [{"id": 1000 + 5 * i + k, "image_id": img["id"], "caption": sentence()}
            for i, img in enumerate(images) for k in range(int(rng.integers(2, 6)))]
    path = tmp_path / "captions.json"
    path.write_text(json.dumps({"info": {}, "images": images, "annotations": anns,
                                "type": "captions"}))
    results = [{"image_id": img["id"], "caption": sentence()} for img in images[:-3]]
    scores = []
    for coco_mod, evalcap in ((P, COCOEvalCap), (J, jevaluation.COCOEvalCap)):
        coco = coco_mod.COCO(str(path))
        res = coco.loadRes(copy.deepcopy(results))
        ids = res.getImgIds()
        gts = {i: coco.imgToAnns[i] for i in ids}
        hyp = {i: res.imgToAnns[i] for i in ids}
        ev = evalcap(gts, hyp)
        scores.append((ev.evaluate(), res.dataset, ev.evalImgs))
    (got, res_p, imgs_p), (want, res_j, imgs_j) = scores
    assert_same(res_p, res_j)
    assert len(res_p["images"]) == 9 and list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=0, atol=1e-12)
    for a, b in zip(imgs_p, imgs_j):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_allclose([a[k] for k in got], [b[k] for k in got], rtol=0, atol=1e-12)
    assert 0 < got["Bleu_1"] < 1
