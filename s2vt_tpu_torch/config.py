"""Configuration: the ``Opt`` dataclass, field for field.

Counterpart of ``s2vt_tpu/config.py``, copied so that an ``opt.json``
written by the JAX package loads unchanged. Fields that only the JAX
package reads (mesh, orbax, feature bank, ...) are kept for that reason;
the port reads the model, data and decode fields.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any


@dataclasses.dataclass
class Opt:
    """Training / model / data configuration.

    Mirrors the reference's train.py:20-48 field-for-field, with TPU-native
    extensions at the bottom.
    """

    # - data config (train.py:22-24)
    caption_file: str = "./data/captions.json"
    feats_path: str = "./data/feats/vgg16_bn"
    gts_file: str = "./data/gts.json"

    # - model config (train.py:26-35)
    train_length: int = 80   # fixed sequence length; feats length must equal this
    dim_hidden: int = 512
    dim_embed: int = 512
    feat_dim: int = 4096
    feat_dropout: float = 0.0
    out_dropout: float = 0.0
    rnn_dropout: float = 0.0
    num_layers: int = 1
    bidirectional: bool = False
    rnn_type: str = "lstm"  # 'lstm' or 'gru'
    model: str = "s2vt"     # 's2vt' or 'att_baseline' (train.py:86 ships att_baseline)

    # - data config (train.py:37)
    batch_size: int = 16
    eval_batch_size: int = 10  # eval.py:27

    # - train config (train.py:39-44)
    EPOCHS: int = 300
    save_freq: int = 100
    save_path: str = "./checkpoint"
    histogram_freq: int = 10
    start_time: str = dataclasses.field(
        default_factory=lambda: time.strftime("%y_%m_%d_%H_%M_%S-", time.localtime())
    )
    early_stopping_patience: int = 30

    # - optimizer config (train.py:46-47)
    lr: float = 1e-4
    learning_rate_patience: int = 20
    weight_decay: float = 0.0

    # - special tokens (explicit, unlike the reference's hardcoded 3/4)
    sos_ix: int = 3
    eos_ix: int = 4
    pad_ix: int = 0
    unk_ix: int = 1

    # - embedding warm start (S2VTModel.py:112-147, commented at train.py:88)
    glove_path: str = ""  # e.g. ./data/glove.6B.512d.txt; "" disables

    # - decode config (S2VTModel.py:39, eval.py)
    beam_width: int = 3
    max_beam_depth: int = 30
    length_norm_alpha: float = 0.7
    beam_score_mode: str = "cumulative"  # 'cumulative' (intended objective)
    #   or 'reference' (bit-faithful to the reference's last-step-logp
    #   scoring quirk, S2VTModel.py:221-223 — verified against a
    #   PriorityQueue oracle in tests/test_beam_oracle.py)

    # - TPU-native extensions
    seed: int = 0
    compute_dtype: str = "float32"   # 'float32' or 'bfloat16' for matmul inputs
    use_pallas: bool = False         # use the Pallas-fused LSTM sequence kernel
    mesh_shape: tuple = (1, 1)       # (data, model) mesh axes
    masked_loss: bool = True         # True = the *intended* masked-mean CE;
    #   False reproduces the reference's MaskCriterion bug (utils.py:11-26),
    #   where reduction='mean' makes the mask a no-op (plain mean CE incl. pads).
    donate_state: bool = True
    log_dir: str = "./runs"
    resume_path: str = ""    # checkpoint dir to resume training from
    profile: bool = False    # torch.profiler trace of the first epoch -> log_dir
    metric_eval_freq: int = 0  # every N epochs: greedy-decode the valid
    #   split and log BLEU/METEOR/ROUGE-L/CIDEr (0 = off; new capability,
    #   the reference only tracks losses)
    prefetch_depth: int = 2  # device-input double-buffering: batches with
    #   an in-flight async device_put ahead of the consuming step (1 = off)
    async_checkpoint: bool = True  # periodic/best checkpoint writes run on
    #   orbax's background thread against a device-side state snapshot, so
    #   the epoch loop never blocks on D2H + disk; the 'final' checkpoint
    #   (and every restore) still waits for all in-flight writes.
    device_feature_bank: str = "auto"  # 'on' | 'off' | 'auto': keep the
    #   ENTIRE feature set resident in device HBM (one upload at startup)
    #   and gather batches on device by row index, so the per-step H2D
    #   transfer shrinks from [B, L, feat_dim] floats to a few KB of
    #   labels+indices. The right design for MSVD-scale data (~2.4 GB vs
    #   16 GB HBM); 'auto' enables it when the split fits the budget below,
    #   streaming mode remains for datasets that don't fit.
    feature_bank_max_bytes: int = 6 << 30
    feature_bank_cache: bool = False  # keep uploaded banks in a process-
    #   level cache keyed by dataset identity + device set + storage dtype,
    #   so repeated Trainer runs over the same data (sweeps, benchmarks)
    #   skip the multi-GB re-upload; the cached bank's HBM persists until
    #   exit.
    bank_dtype: str = "auto"  # dtype features are STORED in on device (and
    #   transferred in, for both the bank upload and streaming batches):
    #   'auto' follows compute_dtype — bf16 compute stores a bf16 bank,
    #   halving the multi-GB upload, the bank's HBM footprint, and the
    #   per-batch H2D bytes in streaming mode; 'float32' forces f32
    #   storage. Numerically equivalent to storing f32: matmul operands
    #   are cast to compute_dtype at point of use regardless
    #   (ops/rnn.py::input_projection), so pre-casting moves the identical
    #   rounding earlier (bit-identical when feat_dropout == 0, the
    #   reference's configuration).
    vocab_pad_multiple: int = 1  # pad vocab size up to a multiple (e.g. 128
    #   for MXU-friendly logits and tensor-parallel vocab sharding); padded
    #   indices never occur in captions and are masked out of decode.

    def replace(self, **kw: Any) -> "Opt":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(d["mesh_shape"])
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Opt":
        d = json.loads(s)
        if "mesh_shape" in d:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(**d)


def save_opt(opt: Opt, path: str) -> None:
    """Config snapshot, the analog of the reference's ``{ts}opt.txt``
    (the reference's train.py:51-53), written as JSON for round-tripping."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(opt.to_json())


def load_opt(path: str) -> Opt:
    with open(path, encoding="utf-8") as f:
        return Opt.from_json(f.read())
