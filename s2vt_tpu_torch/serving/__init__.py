from s2vt_tpu_torch.serving.export import (ServingCaptioner,  # noqa: F401
                                           export_captioner, quantize_feats)
