from s2vt_tpu_torch.extract.backbones import BACKBONE_SPECS, build_backbone  # noqa: F401
from s2vt_tpu_torch.extract.pipeline import FeatureExtractor, extract  # noqa: F401
from s2vt_tpu_torch.extract.preprocess import (fix_sample_indices,  # noqa: F401
                                               free_sample_indices, preprocess_frames)
