"""Greedy and beam decoding over dataset splits (counterpart of ``s2vt_tpu.evaluation``)."""

from s2vt_tpu_torch.evaluation.decode import (CaptionDecoder, beam_eval,  # noqa: F401
                                              greedy_eval, ids_to_sentence,
                                              model_from_checkpoint)
