"""Model factory and checkpoint loading (counterpart of ``s2vt_tpu.training``)."""

from s2vt_tpu_torch.training.checkpoint import (load_checkpoint, load_config,  # noqa: F401
                                                save_checkpoint)
from s2vt_tpu_torch.training.loop import build_model  # noqa: F401
