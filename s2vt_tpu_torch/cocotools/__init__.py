"""pycocotools-compatible dataset API and detection evaluator.

Counterpart of ``s2vt_tpu/cocotools``: ``COCO`` (``coco.py``), ``COCOeval``
and ``Params`` (``cocoeval.py``), host-side over the C++ RLE ops in
``s2vt_tpu_torch.utils.mask`` (``native/s2vt_mask.cpp``). On the caption
path, ``COCO.loadRes`` reads caption results.
"""

from s2vt_tpu_torch.cocotools.coco import COCO
from s2vt_tpu_torch.cocotools.cocoeval import COCOeval, Params

__all__ = ["COCO", "COCOeval", "Params"]
