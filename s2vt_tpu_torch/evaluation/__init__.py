"""Decoding and scoring over dataset splits (counterpart of ``s2vt_tpu.evaluation``)."""

from s2vt_tpu_torch.evaluation.decode import (CaptionDecoder, beam_eval,  # noqa: F401
                                              greedy_eval, ids_to_sentence,
                                              model_from_checkpoint)
from s2vt_tpu_torch.evaluation.scorer import (COCOScorer, msr_vtt_to_coco_gts,  # noqa: F401
                                              pred_to_coco_samples_IDs, score_predictions)
from s2vt_tpu_torch.evaluation.coco_eval import COCOEvalCap  # noqa: F401
