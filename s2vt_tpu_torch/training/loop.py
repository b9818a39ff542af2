"""The training harness: train/eval steps and the epoch loop.

Counterpart of ``s2vt_tpu/training/loop.py`` (the reference's train.py:56-179:
Adam, reduce-on-plateau, early stopping, periodic / best / final
checkpoints), on one device:

 - One train step is forward, loss, backward and an AdamW update; each
   step's loss stays on the device and the epoch's losses are read once, at
   its end.
 - The whole feature set can live on the device as one tensor (the feature
   bank); batches are then gathered there by row index, and only labels and
   row indices cross from the host per step.
 - Dropout masks come from a ``torch.Generator`` seeded from (seed, epoch,
   step), the role of the JAX package's ``fold_in`` keys.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from s2vt_tpu_torch.config import Opt, save_opt
from s2vt_tpu_torch.data.dataset import Batch, VideoDataset
from s2vt_tpu_torch.models.s2vt import S2VT
from s2vt_tpu_torch.ops.losses import _token_nll
from s2vt_tpu_torch.training.callbacks import EarlyStopping, ReduceLROnPlateau
from s2vt_tpu_torch.training.checkpoint import load_training_state, save_training_state
from s2vt_tpu_torch.utils.device import resolve_device
from s2vt_tpu_torch.utils.weights import params_from_jax, params_to_jax


def batch_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               valid: torch.Tensor, masked: bool = True) -> torch.Tensor:
    """Sequence CE with per-sample ``valid`` weights (for padded last batches).

    masked=True: the intended masked-mean CE of MaskCriterion (utils.py:13-26).
    masked=False: the reference's effective loss (plain mean CE over all
    positions, pads included: the reduction='mean' bug, utils.py:11).
    """
    nll = _token_nll(logits, labels[:, 1:])
    if masked:
        w = mask[:, 1:].float() * valid[:, None]
    else:
        w = valid[:, None].expand_as(nll)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def build_model(opt: Opt, vocab_size: int, valid_vocab: Optional[int] = None) -> S2VT:
    """Model factory dispatching on opt.model.

    ``vocab_size`` may be padded up (Opt.vocab_pad_multiple); pass the real
    corpus vocab as ``valid_vocab`` so decode masks the padding rows."""
    cdt = torch.bfloat16 if opt.compute_dtype == "bfloat16" else None
    if opt.model == "s2vt":
        return S2VT(vocab_size=vocab_size, feat_dim=opt.feat_dim,
                    length=opt.train_length, dim_hid=opt.dim_hidden,
                    dim_embed=opt.dim_embed, feat_dropout=opt.feat_dropout,
                    rnn_dropout=opt.rnn_dropout, out_dropout=opt.out_dropout,
                    num_layers=opt.num_layers, bidirectional=opt.bidirectional,
                    rnn_type=opt.rnn_type, sos_ix=opt.sos_ix, eos_ix=opt.eos_ix,
                    compute_dtype=cdt, use_pallas=opt.use_pallas,
                    valid_vocab=valid_vocab)
    if opt.model == "att_baseline":
        raise NotImplementedError(
            "the attention baseline is not ported yet (ROADMAP.md queue 1, item 4: "
            "attention baseline)")
    raise ValueError(f"unknown model {opt.model!r}")


def _refuse_unported(opt: Opt) -> None:
    """Options of the JAX Trainer that the port does not have yet raise here,
    naming their ROADMAP.md item, instead of being skipped (the attention
    baseline raises in ``build_model``)."""
    unported = [
        (opt.metric_eval_freq > 0, "metric_eval_freq > 0 (greedy metrics during training)",
         "queue 1, item 3: metrics and scorer"),
        (bool(opt.glove_path), "glove_path (GloVe warm start)", "queue 1, item 10"),
        (opt.profile, "profile (trace of the first epoch)", "queue 1, item 10"),
        (tuple(opt.mesh_shape) != (1, 1), f"mesh_shape={tuple(opt.mesh_shape)}",
         "queue 1, item 6: parallel"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"Trainer: {what} is not ported yet (ROADMAP.md {item})")


def _dropout_seed(seed: int, epoch: int, step: int) -> int:
    """A generator seed for one train step, a function of (seed, epoch, step)."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """End-to-end training loop (the train() analog, train.py:56-179)."""

    def __init__(self, opt: Opt, model: Optional[S2VT] = None,
                 train_ds: Optional[VideoDataset] = None,
                 valid_ds: Optional[VideoDataset] = None, device=None):
        _refuse_unported(opt)
        self.device = resolve_device(device)
        self.train_ds = train_ds or VideoDataset(
            opt.caption_file, opt.feats_path, max_len=opt.train_length, mode="train",
            seed=opt.seed)
        self.valid_ds = valid_ds or VideoDataset(
            opt.caption_file, opt.feats_path, max_len=opt.train_length, mode="valid",
            seed=opt.seed)
        # Special tokens come from the corpus, not the reference's hardcoded
        # 3/4 (S2VTModel.py:12).
        self.opt = opt = opt.replace(**self.train_ds.specials)

        if self.train_ds.feat_len != opt.train_length:
            raise ValueError(
                f"feature length {self.train_ds.feat_len} != train_length "
                f"{opt.train_length}; S2VT requires them equal (the reference "
                f"states this at train.py:26)")
        if self.train_ds.feat_dim != opt.feat_dim:
            raise ValueError(f"feature dim {self.train_ds.feat_dim} != "
                             f"opt.feat_dim {opt.feat_dim}")

        self.vocab_size = pad_to_multiple(self.train_ds.vocab_size, opt.vocab_pad_multiple)
        if model is None:
            model = build_model(opt, self.vocab_size, valid_vocab=self.train_ds.vocab_size)
            model.reset_parameters(torch.Generator().manual_seed(opt.seed))
        self.model = model.to(self.device)
        # AdamW with these arguments is optax.adamw; with weight_decay 0 it is
        # Adam, the reference's optimizer (train.py:89-93). Torch's default
        # decay is 0.01, so the decay is always passed.
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=opt.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=opt.weight_decay)

        # Features are stored (bank) and sent (streaming) in Opt.bank_dtype;
        # every matmul casts its operands to compute_dtype anyway.
        if opt.bank_dtype not in ("auto", "bfloat16", "float32"):
            raise ValueError(f"Opt.bank_dtype={opt.bank_dtype!r}: expected 'auto', "
                             "'bfloat16', or 'float32'")
        if opt.device_feature_bank not in ("auto", "on", "off"):
            raise ValueError(f"Opt.device_feature_bank={opt.device_feature_bank!r}: "
                             "expected 'auto', 'on', or 'off'")
        bd = opt.bank_dtype if opt.bank_dtype != "auto" else opt.compute_dtype
        self._feat_dtype = torch.bfloat16 if bd == "bfloat16" else torch.float32
        stored = ((self.train_ds.nbytes() + self.valid_ds.nbytes())
                  * self._feat_dtype.itemsize // 4)
        fb = opt.device_feature_bank
        self.use_feature_bank = fb == "on" or (
            fb == "auto" and stored <= opt.feature_bank_max_bytes)
        self._bank: Dict[str, torch.Tensor] = {}
        if self.use_feature_bank:
            self._bank = {"train": self._upload(self.train_ds),
                          "valid": self._upload(self.valid_ds)}

        self.plateau = ReduceLROnPlateau(opt.lr, patience=opt.learning_rate_patience)
        self.early = EarlyStopping(patience=opt.early_stopping_patience,
                                   save_fn=lambda: self.save("stop"))
        self.history: Dict[str, list] = {"train_loss": [], "valid_loss": [], "lr": [],
                                         "clips_per_sec": []}
        self.epochs_done = 0
        self._stop_requested = False

    # ------------------------------------------------------------------

    def _upload(self, ds: VideoDataset) -> torch.Tensor:
        """One split's features as a device tensor [N, L, feat_dim]."""
        return torch.from_numpy(ds.load_all_features()).to(self.device, self._feat_dtype)

    def _put(self, batch: Batch, split: str):
        """(feats, labels, mask, valid) of a host batch, on the device."""
        dev = self.device
        labels = torch.from_numpy(batch.labels).to(dev, torch.long)
        mask = torch.from_numpy(batch.mask).to(dev)
        valid = torch.from_numpy(batch.valid).to(dev)
        if self.use_feature_bank:
            feats = self._bank[split][torch.from_numpy(batch.rows).to(dev, torch.long)]
        else:
            feats = torch.from_numpy(batch.feats).to(dev, self._feat_dtype)
        return feats, labels, mask, valid

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def train_step(self, feats, labels, mask, valid,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward, loss, backward and one AdamW update. Returns the loss as a
        device scalar (no host sync)."""
        logits = self.model(feats, labels[:, :-1], mode="train", deterministic=False,
                            generator=generator)
        loss = batch_loss(logits, labels, mask, valid, masked=self.opt.masked_loss)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, epoch: int) -> tuple:
        losses = []
        clips = 0
        t0 = time.time()
        batches = self.train_ds.batches(self.opt.batch_size, epoch=epoch,
                                        include_feats=not self.use_feature_bank)
        for i, batch in enumerate(batches):
            gen = torch.Generator(device=self.device).manual_seed(
                _dropout_seed(self.opt.seed, epoch, i))
            losses.append(self.train_step(*self._put(batch, "train"), generator=gen))
            clips += int(batch.valid.sum())
        mean_loss = torch.stack(losses).mean().item()   # the epoch's one sync
        return mean_loss, clips / max(time.time() - t0, 1e-9)

    @torch.no_grad()
    def valid_epoch(self, epoch: int) -> float:
        losses, weights = [], []
        batches = self.valid_ds.batches(self.opt.batch_size, shuffle=False, epoch=epoch,
                                        include_feats=not self.use_feature_bank)
        for batch in batches:
            feats, labels, mask, valid = self._put(batch, "valid")
            logits = self.model(feats, labels[:, :-1], mode="train", deterministic=True)
            losses.append(batch_loss(logits, labels, mask, valid,
                                     masked=self.opt.masked_loss))
            weights.append(float(batch.valid.sum()))
        w = np.asarray(weights)
        return float(np.sum(torch.stack(losses).cpu().numpy() * w) / w.sum())

    def fit(self, epochs: Optional[int] = None,
            on_epoch_end: Optional[Callable] = None) -> Dict[str, list]:
        """Train until ``epochs`` (default opt.EPOCHS) epochs are done in all,
        counting those of a restored checkpoint, or until early stopping or
        SIGTERM; then write the 'final' checkpoint."""
        opt = self.opt
        os.makedirs(opt.save_path, exist_ok=True)
        save_opt(opt, os.path.join(opt.save_path, opt.start_time + "opt.json"))
        if opt.resume_path:
            self.restore(opt.resume_path)
        epochs = opt.EPOCHS if epochs is None else epochs

        # Preemption: SIGTERM finishes the current epoch, then falls through
        # to the blocking 'final' save, so --resume_path continues. The old
        # handler comes back only after that save, so a late SIGTERM during
        # it hits the no-op handler instead of killing the write.
        self._stop_requested = False

        def _on_sigterm(signum, frame):
            self._stop_requested = True

        registered, prev_handler = False, None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            registered = True
        except ValueError:            # not in the main thread
            pass
        try:
            self._fit_epochs(epochs, on_epoch_end)
            self.save("final")
        finally:
            if registered:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        return self.history

    def _fit_epochs(self, epochs: int, on_epoch_end: Optional[Callable]) -> None:
        opt = self.opt
        try:
            for epoch in range(self.epochs_done, epochs):
                train_loss, cps = self.train_epoch(epoch)
                valid_loss = self.valid_epoch(epoch)
                lr = self.plateau.step(valid_loss)
                self._set_lr(lr)
                self.history["train_loss"].append(train_loss)
                self.history["valid_loss"].append(valid_loss)
                self.history["lr"].append(lr)
                self.history["clips_per_sec"].append(cps)
                self.epochs_done = epoch + 1
                if on_epoch_end is not None:
                    on_epoch_end(self, epoch)
                if self.early(valid_loss):
                    break
                if epoch % opt.save_freq == 0:
                    self.save(str(epoch))
                if self._stop_requested:
                    break
        except KeyboardInterrupt:
            # The reference saves and exits on Ctrl-C (train.py:170-175): fall
            # through to the 'final' checkpoint.
            pass

    # ------------------------------------------------------------------

    def _optim_tree(self) -> dict:
        """AdamW's moments as parameter trees (the params.npz layout), and its step."""
        moments = {"exp_avg": {}, "exp_avg_sq": {}}
        step = 0.0
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            for m, tensors in moments.items():
                tensors[name] = st.get(m, torch.zeros_like(p))
            step = float(st.get("step", step))
        return {**{m: params_to_jax(t) for m, t in moments.items()},
                "step": np.asarray(step, np.float32)}

    def save(self, tag: str) -> str:
        """Write a blocking checkpoint ``{save_path}/{start_time}{tag}``: the
        best ('stop'), periodic ('{epoch}') and 'final' tags of the loop."""
        path = os.path.join(self.opt.save_path, self.opt.start_time + tag)
        state = {"lr": self.optimizer.param_groups[0]["lr"], "epochs_done": self.epochs_done,
                 "plateau": self.plateau.state_dict(), "early": self.early.state_dict()}
        return save_training_state(path, params_to_jax(self.model), self._optim_tree(), state,
                                   self.opt.to_json())

    def restore(self, path: str) -> None:
        """Parameters, AdamW state, learning rate, callbacks and epoch count
        from a checkpoint written by ``save``."""
        params, optim, state = load_training_state(path)
        self.model.load_state_dict(params_from_jax(params))
        sd = self.optimizer.state_dict()
        step = float(optim["step"])
        moments = {m: params_from_jax(optim[m]) for m in ("exp_avg", "exp_avg_sq")}
        sd["state"] = {i: {"step": torch.tensor(step), **{m: t[name] for m, t in moments.items()}}
                       for i, (name, _) in enumerate(self.model.named_parameters())
                       } if step > 0 else {}
        self.optimizer.load_state_dict(sd)
        self._set_lr(state["lr"])
        self.plateau.load_state_dict(state["plateau"])
        self.early.load_state_dict(state["early"])
        self.epochs_done = state["epochs_done"]
