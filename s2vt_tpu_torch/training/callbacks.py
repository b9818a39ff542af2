"""Host-side per-epoch training callbacks.

Counterpart of ``s2vt_tpu/training/callbacks.py``, with the reference's
scheduler and stopper semantics:
 - :class:`ReduceLROnPlateau`: torch ``optim.lr_scheduler.ReduceLROnPlateau``
   defaults as used at the reference's train.py:95-97 (mode='min',
   factor=0.1, relative threshold 1e-4, patience configurable).
 - :class:`EarlyStopping`: the patience counter of the reference's
   utils.py:29-80 (score = -val_loss, delta=0, saves the best).

Both are plain Python over epoch-level scalars.
"""

from __future__ import annotations

from typing import Callable, Optional


class ReduceLROnPlateau:
    def __init__(self, lr: float, patience: int = 20, factor: float = 0.1,
                 threshold: float = 1e-4, min_lr: float = 0.0, verbose: bool = False):
        self.lr = float(lr)
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch validation loss; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                new_lr = max(self.lr * self.factor, self.min_lr)
                if self.verbose and new_lr < self.lr:
                    print(f"ReduceLROnPlateau: lr {self.lr:.2e} -> {new_lr:.2e}")
                self.lr = new_lr
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


class EarlyStopping:
    """Stops when the validation loss has not improved for ``patience`` epochs.

    ``save_fn`` is called on every improvement (the reference's best-model
    '{ts}stop.pth' save, utils.py:74-80)."""

    def __init__(self, patience: int = 7, delta: float = 0.0,
                 save_fn: Optional[Callable[[], None]] = None, verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.save_fn = save_fn
        self.verbose = verbose
        self.best_score: Optional[float] = None
        self.counter = 0
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best_score is None or score > self.best_score + self.delta:
            self.best_score = score
            self.counter = 0
            if self.save_fn is not None:
                self.save_fn()
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    def state_dict(self) -> dict:
        return {"best_score": self.best_score, "counter": self.counter,
                "early_stop": self.early_stop}

    def load_state_dict(self, d: dict) -> None:
        self.best_score = d["best_score"]
        self.counter = d["counter"]
        self.early_stop = d["early_stop"]
