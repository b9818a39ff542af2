"""The training harness: train/eval steps and the epoch loop.

Counterpart of ``s2vt_tpu/training/loop.py`` (the reference's train.py:56-179:
Adam, reduce-on-plateau, early stopping, periodic / best / final
checkpoints), on one device:

 - One train step is forward, loss, backward and an AdamW update; each
   step's loss stays on the device and the epoch's losses are read once, at
   its end.
 - The whole feature set can live on the device as one tensor (the feature
   bank); batches are then gathered there by row index, and only labels and
   row indices cross from the host per step. With ``Opt.feature_bank_cache``
   the uploaded banks stay in a process-level cache, keyed by the feature
   files' stats, for the next Trainer over the same data.
 - Otherwise features stream from the dataset's backend (the C++ reader
   pool where it can run), assembled on a host thread of their own. On the
   card each batch lands in pinned host memory and is copied on a stream of
   the Trainer's own, ``prefetch_depth`` - 1 batches ahead of the step that
   consumes it, which waits on the copy's event; on the CPU nothing is
   pinned and no stream exists.
 - Dropout masks come from a ``torch.Generator`` seeded from (seed, epoch,
   step), the role of the JAX package's ``fold_in`` keys.
 - With ``Opt.metric_eval_freq`` > 0, every that many epochs the valid
   split is greedy-decoded (from the feature bank when there is one) and
   scored against ``Opt.gts_file`` (BLEU, METEOR, ROUGE-L, CIDEr), into
   ``history["metrics"]``.
 - ``Opt.glove_path`` warm-starts the embedding from GloVe
   (``data/glove.py``); ``Opt.profile`` traces epoch 0's train epoch into
   ``log_dir/profile`` (``utils/profiling.py``); a tensorboardX writer (where
   it imports) logs the reference's scalars, the metric eval's and weight
   histograms every ``histogram_freq`` epochs into ``log_dir``.
 - The train loop's host work is named on a profiler's timeline while one
   records (``utils/profiling.py::annotate``; nothing otherwise): the feed
   (``s2vt.feed.batch``, ``.send``, ``.take``), each step (``s2vt.step``
   and its parts) and the epoch's sync (``s2vt.epoch.sync``).
 - With ``Opt.async_checkpoint`` the periodic and best checkpoints are
   written on a thread of their own from a device snapshot taken at the
   call (``training/checkpoint.py``); 'final' waits for them all.
 - With a mesh (``parallel/mesh.py``; ``Opt.mesh_shape`` other than (1, 1)
   builds one) the run is data- and vocab-parallel over
   ``torch.distributed``: ``Opt.batch_size`` is the global batch, every
   rank draws the same shuffle and takes its rows (and reads only their
   files when streaming), dropout masks are drawn for the global batch and
   sliced, gradients are summed over the data group, and the embedding and
   out-projection are split over the model group (``parallel/vocab.py``).
   A run equals the one-rank run at the same global batch. Rank 0 alone
   writes checkpoints (whole tensors), logs and prints.
 - On the card, with no mesh and no dropout, a train step's forward, loss
   and backward are captured once into a CUDA graph and replayed
   (``training/step_graph.py``); AdamW stays eager.
   ``Trainer.step_graph_stats`` counts eager, captured and replayed steps.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import signal
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from s2vt_tpu_torch.config import Opt, save_opt
from s2vt_tpu_torch.data.dataset import (Batch, VideoDataset, prefetch_to_device,
                                         read_ahead)
from s2vt_tpu_torch.models.attention import AttBaseline
from s2vt_tpu_torch.models.s2vt import S2VT
from s2vt_tpu_torch.ops.layers import global_batch_rows
from s2vt_tpu_torch.ops.losses import _token_nll
from s2vt_tpu_torch.parallel import mesh as mesh_lib
from s2vt_tpu_torch.parallel.distributed import process_index
from s2vt_tpu_torch.parallel.mesh import pad_to_multiple
from s2vt_tpu_torch.parallel.vocab import shard_model_
from s2vt_tpu_torch.training.callbacks import EarlyStopping, ReduceLROnPlateau
from s2vt_tpu_torch.training.checkpoint import (load_training_state, save_training_state,
                                                wait_for_saves)
from s2vt_tpu_torch.training.step_graph import StepGraph
from s2vt_tpu_torch.utils.device import resolve_device
from s2vt_tpu_torch.utils.profiling import annotate
from s2vt_tpu_torch.utils.weights import params_from_jax, unflatten_params

# Process-level device feature banks (Opt.feature_bank_cache): (feats dir,
# content ident, clips, feat_len, feat_dim, split, stored dtype, device) ->
# (tensor, the per-file (path, mtime_ns, size) stats that evict stale entries).
_BANK_CACHE: Dict[tuple, tuple] = {}


def batch_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               valid: torch.Tensor, masked: bool = True, shard=None,
               data_group=None) -> torch.Tensor:
    """Sequence CE with per-sample ``valid`` weights (for padded last batches).

    masked=True: the intended masked-mean CE of MaskCriterion (utils.py:13-26).
    masked=False: the reference's effective loss (plain mean CE over all
    positions, pads included: the reduction='mean' bug, utils.py:11).

    Data- and vocab-parallel: ``shard`` (a ``parallel/vocab.py::VocabShard``)
    takes the CE over vocab-sharded logits; with ``data_group`` the rows are
    this rank's part of the global batch and the weight sum is summed over
    the group, so that the ranks' losses (and gradients) add up to the
    global batch's.
    """
    nll = _token_nll(logits, labels[:, 1:], shard)
    if masked:
        w = mask[:, 1:].float() * valid[:, None]
    else:
        w = valid[:, None].expand_as(nll)
    w_sum = w.sum()
    if data_group is not None:
        dist.all_reduce(w_sum, group=data_group)
    return (nll * w).sum() / w_sum.clamp(min=1.0)


Model = Union[S2VT, AttBaseline]


def build_model(opt: Opt, vocab_size: int, valid_vocab: Optional[int] = None) -> Model:
    """Model factory dispatching on opt.model ('s2vt' | 'att_baseline').

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
        return AttBaseline(vocab_size=vocab_size, dim_feat=opt.feat_dim,
                           length=opt.train_length, dim_hid=opt.dim_hidden,
                           dim_embed=opt.dim_embed, feat_dropout=opt.feat_dropout,
                           out_dropout=opt.out_dropout, sos_ix=opt.sos_ix,
                           eos_ix=opt.eos_ix, compute_dtype=cdt,
                           use_pallas=opt.use_pallas, valid_vocab=valid_vocab)
    raise ValueError(f"unknown model {opt.model!r}")


def _pinned(arr: np.ndarray) -> torch.Tensor:
    """A pinned host tensor holding ``arr``: the pinned tensor ``arr`` views
    (``Trainer._pinned_feats``), else a pinned copy."""
    base = arr.base
    if isinstance(base, torch.Tensor) and base.shape == arr.shape and base.is_pinned():
        return base
    return torch.from_numpy(arr).pin_memory()


def _evict_stale_banks() -> None:
    """Drop every cached bank whose feature files changed or went since it
    was read. Entries that still match stay: two corpora may share one
    features directory."""
    for key in list(_BANK_CACHE):
        for path, mtime_ns, size in _BANK_CACHE[key][1]:
            try:
                st = os.stat(path)
                fresh = st.st_mtime_ns == mtime_ns and st.st_size == size
            except OSError:
                fresh = False
            if not fresh:
                del _BANK_CACHE[key]
                break


def _broadcast_object(obj):
    """Rank 0's ``obj`` on every rank of the default group."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _spanned(batches):
    """``batches``, each ``next()`` of it inside an ``s2vt.feed.batch``
    span that closes before the batch is yielded; closing this closes
    ``batches``."""
    try:
        while True:
            with annotate("s2vt.feed.batch"):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch
    finally:
        batches.close()


def _dropout_seed(seed: int, epoch: int, step: int) -> int:
    """A generator seed for one train step, a function of (seed, epoch, step)."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """End-to-end training loop (the train() analog, train.py:56-179)."""

    def __init__(self, opt: Opt, mesh=None, model: Optional[Model] = None,
                 train_ds: Optional[VideoDataset] = None,
                 valid_ds: Optional[VideoDataset] = None, device=None, writer: Any = "auto"):
        """``mesh``: a (data, model) ``DeviceMesh`` (``parallel/mesh.py::
        make_mesh``) over the ranks of an initialized process group. None
        with ``opt.mesh_shape`` (1, 1) is the one-device run, with no
        process group; None with any other ``opt.mesh_shape`` builds that
        mesh, and ``make_mesh`` raises where the world size does not fit.
        (The JAX Trainer's ``mesh=None`` spreads over all local devices; on
        a machine with one card the two are the same.) ``model``: a whole
        model, split over the mesh here. ``writer``: "auto" opens a
        tensorboardX ``SummaryWriter`` on ``opt.log_dir`` where tensorboardX
        imports (else none), None writes no logs, anything else is used as
        the writer; with a mesh, on rank 0 only."""
        self.device = resolve_device(device)
        if mesh is None and tuple(opt.mesh_shape) != (1, 1):
            mesh = mesh_lib.make_mesh(opt.mesh_shape, self.device)
        self.mesh = mesh
        self._rank0 = process_index() == 0
        self._rows = None if mesh is None else mesh_lib.batch_rows(opt.batch_size, mesh)
        self._data_group = (None if mesh is None
                            else mesh.get_group(mesh_lib.DATA_AXIS))
        self.train_ds = train_ds or VideoDataset(
            opt.caption_file, opt.feats_path, max_len=opt.train_length, mode="train",
            seed=opt.seed)
        self.valid_ds = valid_ds or VideoDataset(
            opt.caption_file, opt.feats_path, max_len=opt.train_length, mode="valid",
            seed=opt.seed)
        # Special tokens come from the corpus, not the reference's hardcoded
        # 3/4 (S2VTModel.py:12).
        self.opt = opt = opt.replace(**self.train_ds.specials)
        if mesh is not None:     # one checkpoint path on every rank
            self.opt = opt = opt.replace(start_time=_broadcast_object(opt.start_time))

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
        if opt.glove_path:
            from s2vt_tpu_torch.data.glove import warm_start_embedding
            warm_start_embedding(model, opt.glove_path, self.train_ds.word2ix, seed=opt.seed)
        self.model = model.to(self.device)
        if mesh is not None:
            shard_model_(self.model, mesh)
        # AdamW with these arguments is optax.adamw; with weight_decay 0 it is
        # Adam, the reference's optimizer (train.py:89-93). Torch's default
        # decay is 0.01, so the decay is always passed.
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=opt.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=opt.weight_decay)
        self._step_graph = StepGraph(self.model, self.device, mesh is not None,
                                     self._forward_backward)
        self.step_graph_stats = self._step_graph.stats

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
            self._bank = {"train": self._bank_tensor(self.train_ds, "train"),
                          "valid": self._bank_tensor(self.valid_ds, "valid")}
        # Batches are copied to the card on a stream of their own.
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

        self.plateau = ReduceLROnPlateau(opt.lr, patience=opt.learning_rate_patience)
        self.early = EarlyStopping(patience=opt.early_stopping_patience,
                                   save_fn=lambda: self.save("stop"))
        self.history: Dict[str, list] = {"train_loss": [], "valid_loss": [], "lr": [],
                                         "clips_per_sec": []}
        self.epochs_done = 0
        self._stop_requested = False
        self._metric_decoder = None
        self.metric_eval_ms: list = []   # per metric eval: {"decode": ms, "score": ms}
        self._owns_writer = writer == "auto"
        self.writer = None
        if self._rank0:
            self.writer = self._make_writer() if writer == "auto" else writer
        self._logs = self.writer is not None
        if mesh is not None:    # every rank takes part in the histograms' gathers
            self._logs = _broadcast_object(self._logs)

    # ------------------------------------------------------------------

    def _upload(self, ds: VideoDataset) -> torch.Tensor:
        """One split's features as a device tensor [N, L, feat_dim], copied in
        chunks (``parallel/mesh.py::device_put_chunked``)."""
        return mesh_lib.device_put_chunked(ds.load_all_features(), self.device,
                                           self._feat_dtype)

    def _bank_tensor(self, ds: VideoDataset, split: str) -> torch.Tensor:
        """One split's feature bank: uploaded, or with ``opt.feature_bank_cache``
        taken from the process-level cache when the same files (ordered paths,
        mtimes and sizes), counts, shape, split, stored dtype and device were
        uploaded before. Off by default: a cached bank outlives its Trainer
        and holds its device memory until the process ends."""
        if not self.opt.feature_bank_cache:
            return self._upload(ds)
        stats = []
        for p in ds.feat_paths:
            st = p.stat()
            stats.append((str(p), st.st_mtime_ns, st.st_size))
        stats = tuple(stats)
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (str(ds.feat_paths[0].parent), hashlib.sha1(repr(stats).encode()).hexdigest(),
               len(ds), ds.feat_len, ds.feat_dim, split, str(self._feat_dtype), str(dev))
        entry = _BANK_CACHE.get(key)
        if entry is not None:
            return entry[0]
        _evict_stale_banks()
        bank = self._upload(ds)
        _BANK_CACHE[key] = (bank, stats)
        return bank

    def _make_writer(self):
        try:
            from tensorboardX import SummaryWriter
            return SummaryWriter(self.opt.log_dir)
        except Exception:
            return None

    def _pinned_feats(self) -> np.ndarray:
        """A [B, L, feat_dim] float32 array over pinned host memory, for the
        dataset to write a streamed batch into. PyTorch's caching host
        allocator hands the block out again only after the copies that read
        it have finished."""
        lo, hi = self._rows or (0, self.opt.batch_size)
        shape = (hi - lo, self.train_ds.feat_len, self.train_ds.feat_dim)
        return torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()

    def _batches(self, split: str, epoch: int):
        """The split's host batches, each followed by its device copy
        (``_send``) ``prefetch_depth`` - 1 batches ahead of its step;
        streamed batches are read on a thread of their own as many ahead."""
        ds = self.train_ds if split == "train" else self.valid_ds
        streamed = not self.use_feature_bank
        alloc = self._pinned_feats if streamed and self._copy_stream is not None else None
        depth = self.opt.prefetch_depth
        batches = ds.batches(self.opt.batch_size, shuffle=None if split == "train" else False,
                             epoch=epoch, include_feats=streamed, feats_alloc=alloc,
                             feat_rows=self._rows)
        if streamed:
            batches = read_ahead(batches, depth - 1)
        return prefetch_to_device(_spanned(batches), self._send, depth=depth)

    def _send(self, batch: Batch):
        """Start a host batch's copy to the device: labels, mask, valid and
        the bank rows or the streamed features. On the card the copies run
        from pinned memory on the Trainer's copy stream; returns the device
        tensors and the event after them (None on the CPU). With a mesh, the
        rank's rows of the batch (streamed features are read for them only)."""
        with annotate("s2vt.feed.send"):
            dev, stream = self.device, self._copy_stream
            labels, mask, valid, rows = batch.labels, batch.mask, batch.valid, batch.rows
            if self._rows is not None:
                lo, hi = self._rows
                labels, mask, valid, rows = labels[lo:hi], mask[lo:hi], valid[lo:hi], rows[lo:hi]
            x = rows if self.use_feature_bank else batch.feats
            x_dtype = torch.long if self.use_feature_bank else self._feat_dtype
            if stream is None:
                return (torch.from_numpy(labels).to(dev, torch.long),
                        torch.from_numpy(mask).to(dev), torch.from_numpy(valid).to(dev),
                        torch.from_numpy(x).to(dev, x_dtype)), None
            with torch.cuda.stream(stream):
                sent = (_pinned(labels).to(dev, non_blocking=True).long(),
                        _pinned(mask).to(dev, non_blocking=True),
                        _pinned(valid).to(dev, non_blocking=True),
                        _pinned(x).to(dev, non_blocking=True).to(x_dtype))
                done = stream.record_event()
            return sent, done

    def _take(self, sent, split: str):
        """(feats, labels, mask, valid) of a batch ``_send`` started, ready
        on the current stream: it waits for the copy, and the tensors are
        marked as used there (``record_stream``), so their memory is not
        handed out again before the step's kernels have read it."""
        with annotate("s2vt.feed.take"):
            (labels, mask, valid, x), done = sent
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in (labels, mask, valid, x):
                    t.record_stream(stream)
            feats = self._bank[split][x] if self.use_feature_bank else x
            return feats, labels, mask, valid

    def _put(self, batch: Batch, split: str):
        """(feats, labels, mask, valid) of a host batch, on the device."""
        return self._take(self._send(batch), split)

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _loss(self, logits, labels, mask, valid) -> torch.Tensor:
        return batch_loss(logits, labels, mask, valid, masked=self.opt.masked_loss,
                          shard=getattr(self.model, "vocab_shard", None),
                          data_group=self._data_group)

    def _global_rows(self):
        """Dropout's view of the global batch: this rank's rows of it."""
        if self._rows is None:
            return contextlib.nullcontext()
        return global_batch_rows(self._rows[0], self.opt.batch_size)

    def _sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group (itself without a mesh)."""
        if self._data_group is not None:
            dist.all_reduce(t, group=self._data_group)
        return t

    def _reduce_grads(self) -> None:
        """Sum the gradients over the data group, in one collective."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = self._sum_over_data(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _forward_backward(self, feats, labels, mask, valid,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A step's forward, loss, ``zero_grad`` and backward, eagerly; the
        loss, detached. What ``StepGraph`` runs or captures."""
        with annotate("s2vt.step.forward"), self._global_rows():
            logits = self.model(feats, labels[:, :-1], mode="train", deterministic=False,
                                generator=generator)
        with annotate("s2vt.step.loss"):
            loss = self._loss(logits, labels, mask, valid)
        with annotate("s2vt.step.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        return loss.detach()

    def train_step(self, feats, labels, mask, valid,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward, loss, backward and one AdamW update. Returns the loss as a
        device scalar of this step's own (no host sync); with a mesh, this
        rank's part of the global batch's loss (the data group's parts sum to
        it). The forward, loss and backward run eagerly or from a CUDA graph
        (``training/step_graph.py``). Its parts are spans
        (``utils/profiling.py::annotate``): ``s2vt.step`` holds either
        ``s2vt.step.eager`` around ``s2vt.step.forward``, ``.loss`` and
        ``.backward`` (with ``zero_grad``), or on a graphed step
        ``s2vt.step.capture`` or ``.replay`` (the input copy and the graph's
        launch); then ``.allreduce`` (with a mesh) and ``.optimizer``."""
        with annotate("s2vt.step"):
            loss = self._step_graph.step((feats, labels, mask, valid), generator)
            if self.mesh is not None:
                with annotate("s2vt.step.allreduce"):
                    self._reduce_grads()
            with annotate("s2vt.step.optimizer"):
                self.optimizer.step()
            return loss

    def train_epoch(self, epoch: int) -> tuple:
        """One epoch of train steps; (mean loss, clips/s). The feed's spans
        (``s2vt.feed.*``) close before a step's: each batch is taken before
        its dropout generator (``s2vt.step.seed``; made only where a dropout
        rate is above 0, so that the step draws from it) and its
        ``train_step``."""
        losses = []
        clips = 0
        t0 = time.perf_counter()
        for i, (batch, sent) in enumerate(self._batches("train", epoch)):
            inputs = self._take(sent, "train")
            with annotate("s2vt.step.seed"):
                gen = (torch.Generator(device=self.device).manual_seed(
                    _dropout_seed(self.opt.seed, epoch, i))
                    if self._step_graph.draws_random else None)
            losses.append(self.train_step(*inputs, generator=gen))
            clips += int(batch.valid.sum())
        with annotate("s2vt.epoch.sync"):     # the epoch's one sync
            mean_loss = self._sum_over_data(torch.stack(losses)).mean().item()
        return mean_loss, clips / max(time.perf_counter() - t0, 1e-9)

    @torch.no_grad()
    def valid_epoch(self, epoch: int) -> float:
        """Mean validation loss, teacher-forced with no gradient recorded (the
        attention baseline's decoder loop then runs its kernel)."""
        losses, weights = [], []
        for batch, sent in self._batches("valid", epoch):
            feats, labels, mask, valid = self._take(sent, "valid")
            logits = self.model(feats, labels[:, :-1], mode="train", deterministic=True)
            losses.append(self._loss(logits, labels, mask, valid))
            weights.append(float(batch.valid.sum()))
        w = np.asarray(weights)
        losses = self._sum_over_data(torch.stack(losses)).cpu().numpy()
        return float(np.sum(losses * w) / w.sum())

    def fit(self, epochs: Optional[int] = None,
            on_epoch_end: Optional[Callable] = None) -> Dict[str, list]:
        """Train until ``epochs`` (default opt.EPOCHS) epochs are done in all,
        counting those of a restored checkpoint, or until early stopping or
        SIGTERM; then write the 'final' checkpoint."""
        opt = self.opt
        if self._rank0:
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
            self.save("final", blocking=True)   # waits for the saves in flight too
        finally:
            if registered:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        self._flush_writer()
        return self.history

    def _flush_writer(self) -> None:
        """Land every logged event: a writer the Trainer opened is closed
        (tensorboardX's ``flush`` does not wait for the events still queued
        for its writer thread; ``close`` does, and a later event opens a
        new file), a writer it was given is flushed."""
        if self.writer is None:
            return
        if self._owns_writer:
            self.writer.close()
        else:
            self.writer.flush()

    def _fit_epochs(self, epochs: int, on_epoch_end: Optional[Callable]) -> None:
        opt = self.opt
        try:
            for epoch in range(self.epochs_done, epochs):
                if opt.profile and epoch == 0 and self._rank0:
                    from s2vt_tpu_torch.utils.profiling import trace
                    with trace(os.path.join(opt.log_dir, "profile")):
                        train_loss, cps = self.train_epoch(epoch)
                else:
                    train_loss, cps = self.train_epoch(epoch)
                valid_loss = self.valid_epoch(epoch)
                lr = self.plateau.step(valid_loss)
                self._set_lr(lr)
                self.history["train_loss"].append(train_loss)
                self.history["valid_loss"].append(valid_loss)
                self.history["lr"].append(lr)
                self.history["clips_per_sec"].append(cps)
                self._log_epoch(epoch, train_loss, valid_loss, lr)
                self.epochs_done = epoch + 1
                if opt.metric_eval_freq > 0 and (epoch + 1) % opt.metric_eval_freq == 0:
                    self._metric_eval(epoch)
                if on_epoch_end is not None:
                    on_epoch_end(self, epoch)
                if self.early(valid_loss):
                    break
                if epoch % opt.save_freq == 0:
                    self.save(str(epoch))
                if self._stop_everywhere():
                    break
        except KeyboardInterrupt:
            # The reference saves and exits on Ctrl-C (train.py:170-175): fall
            # through to the 'final' checkpoint.
            if self.writer is not None:
                self.writer.flush()

    def _stop_everywhere(self) -> bool:
        """Whether a SIGTERM reached this rank (with a mesh: any rank, so
        that every rank stops after the same epoch)."""
        if self.mesh is None:
            return self._stop_requested
        flag = torch.tensor([float(self._stop_requested)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _log_epoch(self, epoch: int, train_loss: float, valid_loss: float, lr: float) -> None:
        """The reference's scalar tags (train.py:131,149-150) and clips/s;
        every ``histogram_freq`` epochs a histogram per weight, named by its
        JAX parameter path (``vid_rnn/l0/w_ih``)."""
        if self._logs and epoch % self.opt.histogram_freq == 0:
            state = self._whole_state_dict()     # a collective with a mesh
        if self.writer is None:
            return
        self.writer.add_scalar("train_loss", train_loss, global_step=epoch)
        self.writer.add_scalar("valid_loss", valid_loss, global_step=epoch)
        self.writer.add_scalar("lr", lr, global_step=epoch)
        self.writer.add_scalar("clips_per_sec", self.history["clips_per_sec"][-1],
                               global_step=epoch)
        if epoch % self.opt.histogram_freq == 0:
            for key, val in sorted(state.items()):
                self.writer.add_histogram(key.replace(".", "/"),
                                          val.detach().cpu().numpy(), epoch)

    def _whole_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the vocab leaves whole: gathered over
        the model group where they are split (a collective)."""
        sd = self.model.state_dict()
        if self.mesh is None:
            return sd
        return mesh_lib.gather_state_dict(sd, self.mesh, self.vocab_size)

    def _metric_eval(self, epoch: int) -> Optional[dict]:
        """Greedy-decode the valid split at ``eval_batch_size`` and score it
        against ``opt.gts_file`` (BLEU-1..4, METEOR, ROUGE-L, CIDEr); the
        scores go into ``history["metrics"]`` with their epoch. Returns them,
        or None when the gts file is missing. The decoder is built once, over
        the valid feature bank when the Trainer keeps one. With a mesh the
        decode is split over the ranks (``CaptionDecoder``), rank 0 scores
        the gathered captions and broadcasts the scores."""
        from s2vt_tpu_torch.evaluation.decode import CaptionDecoder
        from s2vt_tpu_torch.evaluation.scorer import score_predictions

        try:
            with open(self.opt.gts_file, encoding="utf-8") as f:
                gts = json.load(f)["gts"]
        except FileNotFoundError:
            return None
        if self._metric_decoder is None:
            self._metric_decoder = CaptionDecoder(self.model, self.valid_ds, self.device,
                                                  feature_bank=self._bank.get("valid"),
                                                  mesh=self.mesh)
        t0 = time.perf_counter()
        preds = self._metric_decoder.greedy(self.opt.eval_batch_size)   # ends on the host
        t1 = time.perf_counter()
        scores = score_predictions(preds, gts, verbose=False) if self._rank0 else None
        if self.mesh is not None:
            scores = _broadcast_object(scores)
        self.metric_eval_ms.append({"decode": (t1 - t0) * 1e3,
                                    "score": (time.perf_counter() - t1) * 1e3})
        self.history.setdefault("metrics", []).append({"epoch": epoch, **scores})
        if self.writer is not None:
            for name, value in scores.items():
                self.writer.add_scalar(f"valid/{name}", value, global_step=epoch)
        return scores

    # ------------------------------------------------------------------

    def _state_trees(self, snapshot: bool) -> tuple:
        """(params, optim): the parameters, and AdamW's moments with its step,
        as trees in the params.npz layout whose leaves are the device tensors,
        or with ``snapshot`` clones of them (AdamW updates its tensors in
        place, so a write that runs later needs its own copy)."""
        take = (lambda t: t.detach().clone()) if snapshot else (lambda t: t.detach())

        def tree(named):
            whole = dict(named)
            if self.mesh is not None:     # the vocab leaves whole
                whole = mesh_lib.gather_state_dict(whole, self.mesh, self.vocab_size)
            return unflatten_params({k.replace(".", "//"): take(v) for k, v in whole.items()})

        moments = {"exp_avg": [], "exp_avg_sq": []}
        step = 0.0
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            for m, named in moments.items():
                named.append((name, st[m] if m in st else torch.zeros_like(p)))
            step = float(st.get("step", step))
        optim = {**{m: tree(named) for m, named in moments.items()},
                 "step": np.asarray(step, np.float32)}
        return tree(self.model.state_dict().items()), optim

    def save(self, tag: str, blocking: Optional[bool] = None) -> str:
        """Write the checkpoint ``{save_path}/{start_time}{tag}``: the best
        ('stop'), periodic ('{epoch}') and 'final' tags of the loop. Blocking
        unless ``opt.async_checkpoint`` (or ``blocking=False``): the write
        then runs on a thread of its own from a snapshot of the state taken
        now, and this returns at once. Either way it first waits for the
        saves in flight and raises if one of them failed. With a mesh every
        rank calls it: the vocab leaves are gathered (at the snapshot), rank 0
        writes whole tensors, and a blocking save returns on every rank once
        the checkpoint has landed."""
        if blocking is None:
            blocking = not self.opt.async_checkpoint
        path = os.path.join(self.opt.save_path, self.opt.start_time + tag)
        state = {"lr": self.optimizer.param_groups[0]["lr"], "epochs_done": self.epochs_done,
                 "plateau": self.plateau.state_dict(), "early": self.early.state_dict()}
        with torch.no_grad():
            params, optim = self._state_trees(snapshot=not blocking)
        if self._rank0:
            path = save_training_state(path, params, optim, state, self.opt.to_json(),
                                       blocking=blocking)
        if self.mesh is not None and blocking:
            dist.barrier()
        return os.path.abspath(path)

    def restore(self, path: str) -> None:
        """Parameters, AdamW state, learning rate, callbacks and epoch count
        from a checkpoint written by ``save``; with a mesh each rank takes
        its shards of the whole tensors."""
        if self.mesh is not None:       # rank 0's saves in flight land first
            if self._rank0:
                wait_for_saves()
            dist.barrier()
        params, optim, state = load_training_state(path)
        self.model.load_state_dict(self._local(params_from_jax(params)))
        sd = self.optimizer.state_dict()
        step = float(optim["step"])
        moments = {m: self._local(params_from_jax(optim[m])) for m in ("exp_avg", "exp_avg_sq")}
        sd["state"] = {i: {"step": torch.tensor(step), **{m: t[name] for m, t in moments.items()}}
                       for i, (name, _) in enumerate(self.model.named_parameters())
                       } if step > 0 else {}
        self.optimizer.load_state_dict(sd)
        self._set_lr(state["lr"])
        self.plateau.load_state_dict(state["plateau"])
        self.early.load_state_dict(state["early"])
        self.epochs_done = state["epochs_done"]

    def _local(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's shards of a whole state_dict (itself without a mesh)."""
        return state if self.mesh is None else mesh_lib.shard_state_dict(state, self.mesh)
