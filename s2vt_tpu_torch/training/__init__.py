"""Training harness (counterpart of ``s2vt_tpu.training``)."""

from s2vt_tpu_torch.training.callbacks import EarlyStopping, ReduceLROnPlateau  # noqa: F401
from s2vt_tpu_torch.training.checkpoint import (load_checkpoint, load_config,  # noqa: F401
                                                load_training_state, save_checkpoint,
                                                save_training_state, wait_for_saves)
from s2vt_tpu_torch.training.loop import Trainer, batch_loss, build_model  # noqa: F401
