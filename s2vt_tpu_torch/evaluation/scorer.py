"""Caption scoring: predictions + gts -> BLEU/METEOR/ROUGE-L/CIDEr.

Counterpart of ``s2vt_tpu/evaluation/scorer.py`` (the reference's
``COCOScorer`` and ``pred_to_coco_samples_IDs``), over the port's metric
layer (``s2vt_tpu_torch.metrics``), which needs neither java nor nltk.
Scoring runs on the host.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Tuple

from s2vt_tpu_torch.metrics import Bleu, Cider, Meteor, PTBTokenizer, Rouge


def pred_to_coco_samples_IDs(prediction_dict: Dict[str, str],
                             gts: Dict[str, list]) -> Tuple[Dict, List[str]]:
    """Shape {vid: caption} into coco-format samples keyed by video id,
    intersected with the gts keys."""
    samples = {
        vid: [{"image_id": vid, "caption": cap}]
        for vid, cap in prediction_dict.items() if vid in gts
    }
    return samples, list(samples.keys())


def msr_vtt_to_coco_gts(train_source_file: str) -> Dict[str, list]:
    """Scorer gts straight from an MSR-VTT videodatainfo json: sentences
    grouped by their own ``video_id``, tokenized as the reference does
    (lowercase, ``[.!,;?:]`` replaced by spaces), with sequential cap_ids."""
    with open(train_source_file, encoding="utf-8") as f:
        sentences = json.load(f)["sentences"]
    gts: Dict[str, list] = {}
    for sent in sentences:
        image_id = sent["video_id"]
        caps = gts.setdefault(image_id, [])
        caps.append({
            "image_id": image_id,
            "cap_id": len(caps),
            "caption": sent["caption"],
            "tokenized": re.sub(r"[.!,;?:]", " ", sent["caption"].lower()),
        })
    return gts


class COCOScorer:
    """The reference's scorer harness: PTB-tokenize gts and hypotheses, run
    the four metric families, collect corpus-level and per-image scores."""

    def __init__(self, verbose: bool = True, meteor_jar: str = None,
                 meteor_paraphrases: str = None,
                 meteor_function_words=None):
        self.verbose = verbose
        self.meteor_jar = meteor_jar
        self.meteor_paraphrases = meteor_paraphrases
        self.meteor_function_words = meteor_function_words
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, dict] = {}

    def score(self, GT: Dict, RES: Dict, IDs: Iterable[str]) -> Dict[str, float]:
        self.eval = {}
        self.imgToEval = {}
        gts = {i: GT[i] for i in IDs}
        res = {i: RES[i] for i in IDs}

        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize(gts)
        res = tokenizer.tokenize(res)

        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(jar_path=self.meteor_jar,
                    paraphrase_path=self.meteor_paraphrases,
                    function_words=self.meteor_function_words), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self._set_eval(sc, m)
                    self._set_img_scores(scs, IDs, m)
            else:
                self._set_eval(score, method)
                self._set_img_scores(scores, IDs, method)
        if self.verbose:
            for m, v in self.eval.items():
                print(f"{m}: {v:.3f}")
        return self.eval

    def _set_eval(self, score: float, method: str) -> None:
        self.eval[method] = score

    def _set_img_scores(self, scores, IDs, method) -> None:
        for img_id, sc in zip(IDs, scores):
            self.imgToEval.setdefault(img_id, {"image_id": img_id})[method] = sc


def score_predictions(prediction_dict: Dict[str, str], gts: Dict[str, list],
                      verbose: bool = True, meteor_jar: str = None,
                      meteor_paraphrases: str = None,
                      meteor_function_words=None) -> Dict[str, float]:
    """One call: predictions + gts dict -> metric dict."""
    samples, IDs = pred_to_coco_samples_IDs(prediction_dict, gts)
    scorer = COCOScorer(verbose=verbose, meteor_jar=meteor_jar,
                        meteor_paraphrases=meteor_paraphrases,
                        meteor_function_words=meteor_function_words)
    return scorer.score(gts, samples, IDs)
