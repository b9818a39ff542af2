"""COCO detection, segmentation and keypoint evaluator, pycocotools-compatible.

Counterpart of ``s2vt_tpu/cocotools/cocoeval.py``: pycocotools'
``COCOeval`` (evaluate / accumulate / summarize) and ``Params``, host-side:

 - IoU matrices come from the C++ RLE ops (``s2vt_tpu_torch.utils.mask``)
   for 'segm', the C++ box IoU for 'bbox', and a numpy OKS broadcast over
   the detections for 'keypoints'.
 - The per-image greedy matcher keeps pycocotools' order-dependent
   semantics exactly: detections by descending score (a stable sort, so
   tied scores keep their order), ground truths ignore-last, a matched
   non-crowd ground truth never matched again, crowds re-matched, and a
   real match never traded for an ignored one. It is sequential by
   definition and stays an explicit loop.
 - accumulate()'s precision envelope and recall-threshold interpolation
   are vectorized (np.maximum.accumulate / searchsorted), with
   pycocotools' clamp at the last detection.

``evaluate()`` writes ``ignore`` and ``_ignore`` into the ground-truth
annotations, and for 'segm' replaces each annotation's ``segmentation`` by
its RLE, as pycocotools does. Quiet by default; ``verbose=True`` prints the
progress lines. summarize() prints the standard metric table either way.
"""

from __future__ import annotations

import copy
import datetime
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from s2vt_tpu_torch.utils import mask as maskUtils

_OKS_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62,
                        .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0


class Params:
    """Evaluation parameters (pycocotools' Params): detection and keypoint settings."""

    def __init__(self, iouType: str = "segm"):
        if iouType in ("segm", "bbox"):
            self._set_det()
        elif iouType == "keypoints":
            self._set_kp()
        else:
            raise ValueError(f"iouType {iouType!r} not supported")
        self.iouType = iouType
        self.useSegm = None  # deprecated alias kept for API parity

    def _set_det(self):
        self.imgIds: List = []
        self.catIds: List = []
        self.iouThrs = np.linspace(.5, 0.95, 10, endpoint=True)
        self.recThrs = np.linspace(.0, 1.00, 101, endpoint=True)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2],
                        [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1

    def _set_kp(self):
        self._set_det()
        self.maxDets = [20]
        self.areaRng = [[0 ** 2, 1e5 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e5 ** 2]]
        self.areaRngLbl = ["all", "medium", "large"]


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "segm",
                 verbose: bool = False):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.verbose = verbose
        self.evalImgs = defaultdict(list)
        self.eval: Dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.params = Params(iouType=iouType)
        self._paramsEval: Optional[Params] = None
        self.stats: np.ndarray = np.array([])
        self.ious: Dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------------------
    # evaluate
    # ------------------------------------------------------------------

    def _prepare(self) -> None:
        p = self.params
        if p.useCats:
            gts = self.cocoGt.loadAnns(
                self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
            dts = self.cocoDt.loadAnns(
                self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        else:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds))
        if p.iouType == "segm":
            for ann in gts:
                ann["segmentation"] = self.cocoGt.annToRLE(ann)
            for ann in dts:
                ann["segmentation"] = self.cocoDt.annToRLE(ann)
        for gt in gts:
            gt["ignore"] = bool(gt.get("iscrowd", 0))
            if p.iouType == "keypoints":
                gt["ignore"] = (gt.get("num_keypoints", 0) == 0) or gt["ignore"]
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    def evaluate(self) -> None:
        t0 = time.time()
        p = self.params
        if p.useSegm is not None:
            p.iouType = "segm" if p.useSegm == 1 else "bbox"
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p

        self._prepare()
        cat_ids = p.catIds if p.useCats else [-1]
        compute = (self.computeOks if p.iouType == "keypoints"
                   else self.computeIoU)
        self.ious = {(img_id, cat_id): compute(img_id, cat_id)
                     for img_id in p.imgIds for cat_id in cat_ids}
        max_det = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(img_id, cat_id, area_rng, max_det)
            for cat_id in cat_ids
            for area_rng in p.areaRng
            for img_id in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)
        if self.verbose:
            print(f"DONE (t={time.time() - t0:0.2f}s).")

    def _dt_gt(self, img_id, cat_id):
        p = self.params
        if p.useCats:
            return self._dts[img_id, cat_id], self._gts[img_id, cat_id]
        dt = [d for c in p.catIds for d in self._dts[img_id, c]]
        gt = [g for c in p.catIds for g in self._gts[img_id, c]]
        return dt, gt

    def computeIoU(self, imgId, catId):
        p = self.params
        dt, gt = self._dt_gt(imgId, catId)
        if not gt and not dt:
            return []
        order = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in order][:p.maxDets[-1]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        if p.iouType == "segm":
            return maskUtils.iou([d["segmentation"] for d in dt],
                                 [g["segmentation"] for g in gt], iscrowd)
        if p.iouType == "bbox":
            if not dt or not gt:
                return np.zeros((len(dt), len(gt)))
            return maskUtils.bbox_iou(
                np.asarray([d["bbox"] for d in dt], np.float64),
                np.asarray([g["bbox"] for g in gt], np.float64), iscrowd)
        raise ValueError(f"unknown iouType {p.iouType!r}")

    def computeOks(self, imgId, catId):
        """Object keypoint similarity, vectorized over detections."""
        p = self.params
        dts, gts = self._dts[imgId, catId], self._gts[imgId, catId]
        order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in order][:p.maxDets[-1]]
        if not gts or not dts:
            return []
        variances = (_OKS_SIGMAS * 2) ** 2
        k = len(_OKS_SIGMAS)
        d_kp = np.asarray([d["keypoints"] for d in dts], np.float64)
        xd, yd = d_kp[:, 0::3], d_kp[:, 1::3]                   # [D, k]
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            x0, y0, w, h = gt["bbox"]
            if np.count_nonzero(vg > 0) > 0:
                dx, dy = xd - xg, yd - yg                       # [D, k]
            else:
                # unlabeled gt: distance to the doubled bbox
                xa, xb = x0 - w, x0 + 2 * w
                ya, yb = y0 - h, y0 + 2 * h
                dx = np.maximum(0.0, xa - xd) + np.maximum(0.0, xd - xb)
                dy = np.maximum(0.0, ya - yd) + np.maximum(0.0, yd - yb)
            e = (dx ** 2 + dy ** 2) / variances / \
                (gt["area"] + np.spacing(1)) / 2.0
            if np.count_nonzero(vg > 0) > 0:
                e = e[:, vg > 0]
            ious[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
        return ious

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        """Greedy per-image matching, with pycocotools' semantics."""
        p = self.params
        dt, gt = self._dt_gt(imgId, catId)
        if not gt and not dt:
            return None

        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0]
                                 or g["area"] > aRng[1]) else 0
        gt_order = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gt_order]
        dt_order = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dt_order[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = self.ious[imgId, catId]
        if len(ious) > 0:
            ious = ious[:, gt_order]

        T, G, D = len(p.iouThrs), len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.asarray([g["_ignore"] for g in gt])
        dt_ig = np.zeros((T, D))
        if len(ious):
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    best_iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        # matched non-crowd gts can't be re-matched
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # gts are ignore-last: once we hold a real match,
                        # never trade it for an ignore gt
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if ious[dind, gind] < best_iou:
                            continue
                        best_iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[tind, dind] = gt_ig[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched detections outside the area range are ignored
        outside = np.asarray([d["area"] < aRng[0] or d["area"] > aRng[1]
                              for d in dt]).reshape(1, D)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0,
                                                    np.repeat(outside, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    # ------------------------------------------------------------------
    # accumulate
    # ------------------------------------------------------------------

    def accumulate(self, p: Optional[Params] = None) -> None:
        t0 = time.time()
        if not self.evalImgs:
            raise RuntimeError("run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T, R = len(p.iouThrs), len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A, M = len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        pe = self._paramsEval
        cat_ids = pe.catIds if pe.useCats else [-1]
        set_k, set_m = set(cat_ids), set(pe.maxDets)
        set_a = set(map(tuple, pe.areaRng))
        set_i = set(pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in set_k]
        m_list = [m for m in p.maxDets if m in set_m]
        a_list = [n for n, a in enumerate(map(tuple, p.areaRng))
                  if a in set_a]
        i_list = [n for n, i in enumerate(p.imgIds) if i in set_i]
        I0, A0 = len(pe.imgIds), len(pe.areaRng)

        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, max_det in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if not E:
                        continue
                    dt_scores = np.concatenate(
                        [e["dtScores"][:max_det] for e in E])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[order]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :max_det] for e in E],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dtIgnore"][:, :max_det] for e in E],
                        axis=1)[:, order]
                    gt_ig = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gt_ig == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # precision envelope: running max from the right
                        # (pycocotools' backward loop)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, p.recThrs, side="left")
                        valid = inds < nd
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        q[valid] = pr[inds[valid]]
                        ss[valid] = dt_scores_sorted[inds[valid]]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        if self.verbose:
            print(f"DONE (t={time.time() - t0:0.2f}s).")

    # ------------------------------------------------------------------
    # summarize
    # ------------------------------------------------------------------

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        fmt = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
               " = {:0.3f}")
        title = "Average Precision" if ap == 1 else "Average Recall"
        type_str = "(AP)" if ap == 1 else "(AR)"
        iou_str = (f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}"
                   if iouThr is None else f"{iouThr:0.2f}")
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, aind, mind]
        mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        print(fmt.format(title, type_str, iou_str, areaRng, maxDets, mean_s))
        return mean_s

    def summarize(self) -> None:
        if not self.eval:
            raise RuntimeError("run accumulate() first")
        p = self.params
        if p.iouType in ("segm", "bbox"):
            md = p.maxDets
            self.stats = np.array([
                self._summarize(1),
                self._summarize(1, iouThr=.5, maxDets=md[2]),
                self._summarize(1, iouThr=.75, maxDets=md[2]),
                self._summarize(1, areaRng="small", maxDets=md[2]),
                self._summarize(1, areaRng="medium", maxDets=md[2]),
                self._summarize(1, areaRng="large", maxDets=md[2]),
                self._summarize(0, maxDets=md[0]),
                self._summarize(0, maxDets=md[1]),
                self._summarize(0, maxDets=md[2]),
                self._summarize(0, areaRng="small", maxDets=md[2]),
                self._summarize(0, areaRng="medium", maxDets=md[2]),
                self._summarize(0, areaRng="large", maxDets=md[2]),
            ])
        else:  # keypoints
            self.stats = np.array([
                self._summarize(1, maxDets=20),
                self._summarize(1, maxDets=20, iouThr=.5),
                self._summarize(1, maxDets=20, iouThr=.75),
                self._summarize(1, maxDets=20, areaRng="medium"),
                self._summarize(1, maxDets=20, areaRng="large"),
                self._summarize(0, maxDets=20),
                self._summarize(0, maxDets=20, iouThr=.5),
                self._summarize(0, maxDets=20, iouThr=.75),
                self._summarize(0, maxDets=20, areaRng="medium"),
                self._summarize(0, maxDets=20, areaRng="large"),
            ])

    def __str__(self):
        self.summarize()
        return ""
