"""COCO dataset API, pycocotools-compatible.

Counterpart of ``s2vt_tpu/cocotools/coco.py``: the public surface of
pycocotools' ``coco.py`` (COCO, createIndex, info, getAnnIds / getCatIds /
getImgIds, loadAnns / loadCats / loadImgs, loadRes, loadNumpyAnnotations,
annToRLE, annToMask, showAnns), over the C++ RLE ops of
``s2vt_tpu_torch.utils.mask``. Host-side; it does no device work. As in the
JAX package:

 - quiet by default (``verbose=True`` prints pycocotools' progress lines),
 - ``download()`` raises: the framework runs without network access,
 - ``showAnns`` prints caption annotations, and imports matplotlib only for
   instance annotations, raising ``RuntimeError`` without it.

``loadRes`` writes ``id``, ``area``, ``iscrowd``, ``segmentation`` and
``bbox`` into the caller's result dicts, as pycocotools does.
"""

from __future__ import annotations

import copy
import itertools
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from s2vt_tpu_torch.utils import mask as maskUtils


def _aslist(x) -> list:
    if hasattr(x, "__iter__") and hasattr(x, "__len__") and \
            not isinstance(x, (str, bytes)):
        return list(x)
    return [x]


class COCO:
    """Loads a COCO-format annotation dict and indexes it for queries."""

    def __init__(self, annotation_file: Optional[str] = None,
                 verbose: bool = False):
        self.verbose = verbose
        self.dataset: Dict = {}
        self.anns: Dict = {}
        self.cats: Dict = {}
        self.imgs: Dict = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            t0 = time.time()
            with open(annotation_file, encoding="utf-8") as f:
                dataset = json.load(f)
            if not isinstance(dataset, dict):
                raise TypeError(
                    f"annotation file format {type(dataset)} not supported")
            if self.verbose:
                print(f"Done (t={time.time() - t0:0.2f}s)")
            self.dataset = dataset
            self.createIndex()

    def createIndex(self) -> None:
        anns, cats, imgs = {}, {}, {}
        img_to_anns, cat_to_imgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            img_to_anns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        if "categories" in self.dataset:
            for ann in self.dataset.get("annotations", []):
                cat_to_imgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = img_to_anns, cat_to_imgs

    def info(self) -> None:
        for key, value in self.dataset.get("info", {}).items():
            print(f"{key}: {value}")

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(),
                  iscrowd: Optional[bool] = None) -> List[int]:
        imgIds, catIds = _aslist(imgIds), _aslist(catIds)
        areaRng = list(areaRng)
        if not imgIds and not catIds and not areaRng:
            anns = self.dataset.get("annotations", [])
        else:
            if imgIds:
                anns = list(itertools.chain.from_iterable(
                    self.imgToAnns[i] for i in imgIds if i in self.imgToAnns))
            else:
                anns = self.dataset.get("annotations", [])
            if catIds:
                cat_set = set(catIds)
                anns = [a for a in anns if a["category_id"] in cat_set]
            if areaRng:
                anns = [a for a in anns
                        if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            return [a["id"] for a in anns if a["iscrowd"] == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()) -> List[int]:
        catNms, supNms, catIds = (_aslist(x) for x in (catNms, supNms, catIds))
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in set(catNms)]
        if supNms:
            cats = [c for c in cats if c["supercategory"] in set(supNms)]
        if catIds:
            cats = [c for c in cats if c["id"] in set(catIds)]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=(), catIds=()) -> List[int]:
        imgIds, catIds = _aslist(imgIds), _aslist(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds)
        for i, cat_id in enumerate(catIds):
            if i == 0 and not ids:
                ids = set(self.catToImgs[cat_id])
            else:
                ids &= set(self.catToImgs[cat_id])
        return list(ids)

    def loadAnns(self, ids=()) -> List[Dict]:
        if isinstance(ids, int):
            return [self.anns[ids]]
        return [self.anns[i] for i in _aslist(ids)]

    def loadCats(self, ids=()) -> List[Dict]:
        if isinstance(ids, int):
            return [self.cats[ids]]
        return [self.cats[i] for i in _aslist(ids)]

    def loadImgs(self, ids=()) -> List[Dict]:
        if isinstance(ids, int):
            return [self.imgs[ids]]
        return [self.imgs[i] for i in _aslist(ids)]

    # ------------------------------------------------------------------
    # results loading
    # ------------------------------------------------------------------

    def loadRes(self, resFile: Union[str, list, np.ndarray]) -> "COCO":
        """Build a result-API COCO from a results json/list/ndarray."""
        res = COCO(verbose=self.verbose)
        res.dataset["images"] = list(self.dataset.get("images", []))

        if isinstance(resFile, str):
            with open(resFile, encoding="utf-8") as f:
                anns = json.load(f)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = resFile
        if not isinstance(anns, list):
            raise TypeError("results are not a list of objects")
        res_img_ids = {a["image_id"] for a in anns}
        if not res_img_ids <= set(self.getImgIds()):
            raise ValueError("results do not correspond to this coco set")

        if anns and "caption" in anns[0]:
            keep = {img["id"] for img in res.dataset["images"]} & res_img_ids
            res.dataset["images"] = [img for img in res.dataset["images"]
                                     if img["id"] in keep]
            for i, ann in enumerate(anns):
                ann["id"] = i + 1
        elif anns and "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset["categories"])
            for i, ann in enumerate(anns):
                x, y, w, h = ann["bbox"]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x, y, x, y + h, x + w, y + h,
                                            x + w, y]]
                ann["area"] = w * h
                ann["id"] = i + 1
                ann["iscrowd"] = 0
        elif anns and "segmentation" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset["categories"])
            for i, ann in enumerate(anns):
                rle = self._as_rle(ann["segmentation"],
                                   ann.get("image_id"))
                ann["area"] = maskUtils.area(rle)
                if "bbox" not in ann:
                    ann["bbox"] = maskUtils.toBbox(rle).tolist()
                ann["id"] = i + 1
                ann["iscrowd"] = 0
        elif anns and "keypoints" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset["categories"])
            for i, ann in enumerate(anns):
                kp = ann["keypoints"]
                xs, ys = kp[0::3], kp[1::3]
                x0, x1 = min(xs), max(xs)
                y0, y1 = min(ys), max(ys)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann["id"] = i + 1
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]

        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def loadNumpyAnnotations(self, data: np.ndarray) -> List[Dict]:
        """[N, 7] rows of {imageID, x1, y1, w, h, score, class} -> ann dicts."""
        assert isinstance(data, np.ndarray) and data.shape[1] == 7
        return [{
            "image_id": int(row[0]),
            "bbox": [float(row[1]), float(row[2]), float(row[3]),
                     float(row[4])],
            "score": float(row[5]),
            "category_id": int(row[6]),
        } for row in data]

    # ------------------------------------------------------------------
    # segmentation conversion
    # ------------------------------------------------------------------

    def _as_rle(self, segm, image_id) -> Dict:
        if isinstance(segm, list):
            img = self.imgs.get(image_id, {})
            h, w = img.get("height"), img.get("width")
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles) if isinstance(rles, list) else rles
        if isinstance(segm.get("counts"), list):
            return maskUtils.frUncompressedRLE(segm)
        if isinstance(segm.get("counts"), (bytes, str)):
            counts = segm["counts"]
            if isinstance(counts, str):
                counts = counts.encode()
            return maskUtils.frString(counts, *segm["size"])
        return segm

    def annToRLE(self, ann: Dict) -> Dict:
        """Polygons / uncompressed RLE / compressed string -> counts RLE."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles) if isinstance(rles, list) else rles
        if isinstance(segm["counts"], list):
            return maskUtils.frUncompressedRLE(segm)
        if isinstance(segm["counts"], (bytes, str)):
            counts = segm["counts"]
            if isinstance(counts, str):
                counts = counts.encode()
            return maskUtils.frString(counts, h, w)
        return segm

    def annToMask(self, ann: Dict) -> np.ndarray:
        return maskUtils.decode(self.annToRLE(ann))

    # ------------------------------------------------------------------
    # display / download
    # ------------------------------------------------------------------

    def showAnns(self, anns: Sequence[Dict]):
        """Render annotations (requires matplotlib for instances); caption
        annotations print."""
        if not anns:
            return 0
        if "caption" in anns[0]:
            for ann in anns:
                print(ann["caption"])
            return None
        try:
            import matplotlib.pyplot as plt
            from matplotlib.collections import PatchCollection
            from matplotlib.patches import Polygon
        except ImportError as e:  # headless host: keep the API importable
            raise RuntimeError("showAnns for instance annotations requires "
                               "matplotlib") from e
        ax = plt.gca()
        ax.set_autoscale_on(False)
        polygons, colors = [], []
        rng = np.random.default_rng(0)
        for ann in anns:
            c = (rng.random(3) * 0.6 + 0.4).tolist()
            segm = ann.get("segmentation")
            if isinstance(segm, list):
                for seg in segm:
                    poly = np.asarray(seg).reshape(-1, 2)
                    polygons.append(Polygon(poly))
                    colors.append(c)
            elif segm is not None:
                m = maskUtils.decode(self.annToRLE(ann))
                img = np.ones((m.shape[0], m.shape[1], 3))
                cm = (np.array([2.0, 166.0, 101.0]) / 255
                      if ann.get("iscrowd") else rng.random(3))
                for i in range(3):
                    img[:, :, i] = cm[i]
                ax.imshow(np.dstack((img, m * 0.5)))
        ax.add_collection(PatchCollection(
            polygons, facecolor=colors, linewidths=0, alpha=0.4))
        ax.add_collection(PatchCollection(
            polygons, facecolor="none", edgecolors=colors, linewidths=2))

    def download(self, tarDir=None, imgIds=()):
        raise RuntimeError("download() is unavailable: this framework "
                           "targets zero-egress environments; fetch images "
                           "out of band")
