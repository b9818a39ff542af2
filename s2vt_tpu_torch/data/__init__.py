"""Corpus reader and batch pipeline (counterpart of ``s2vt_tpu.data``)."""

from s2vt_tpu_torch.data.corpus import build_vocab, load_captions  # noqa: F401
from s2vt_tpu_torch.data.dataset import Batch, VideoDataset, make_synthetic_corpus  # noqa: F401
