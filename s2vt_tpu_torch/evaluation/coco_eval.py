"""``COCOEvalCap``: coco-caption's all-metrics harness API.

Counterpart of ``s2vt_tpu/evaluation/coco_eval.py``: the upstream
attribute surface (``evaluate()``, ``eval``, ``imgToEval``, ``evalImgs``,
``params``) over plain caption dicts, backed by :class:`COCOScorer`. SPICE
is not included (the reference could never run it either).
"""

from __future__ import annotations

from typing import Dict, List

from s2vt_tpu_torch.evaluation.scorer import COCOScorer


class COCOEvalCap:
    """``COCOEvalCap(gts, res).evaluate()`` where gts/res map image_id ->
    [{'caption': str}, ...] (coco annotation format)."""

    def __init__(self, gts: Dict, res: Dict, meteor_jar: str = None):
        self.evalImgs: List[dict] = []
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, dict] = {}
        self.gts = gts
        self.res = res
        self.meteor_jar = meteor_jar
        self.params = {"image_id": sorted(set(gts) & set(res))}

    def evaluate(self) -> Dict[str, float]:
        scorer = COCOScorer(verbose=False, meteor_jar=self.meteor_jar)
        self.eval = scorer.score(self.gts, self.res, self.params["image_id"])
        self.imgToEval = scorer.imgToEval
        self.evalImgs = [self.imgToEval[i] for i in sorted(self.imgToEval)]
        return self.eval
