"""Host and device time of one S2VT train step on the card.

    PYTHONPATH=<checkout> python <checkout>/s2vt_tpu_torch/tools/train_step_time.py
        [--rnn_type gru] [--num_layers 1] [--batch 16] [--dtype float32] [--reps 40]
        [--label NAME]

Builds a ``Trainer`` at the MSVD width of chip_smoke.py's training phases
(H = E = 512, F = 4096, L = 80, the vocab padded to 10240, use_pallas, the
compute dtype ``--dtype``, float32 by default)
on a synthetic corpus and random weights made from ``--seed``, and times
``Trainer.train_step`` on one random batch: the median host ms of ``--reps``
synchronised steps, then one step under ``torch.profiler``: the device busy
ms (the kernels' own device time), the idle share against the median, and
the port's kernels' device ms and launches. Prints one line.

Run as a file, it times the ``s2vt_tpu_torch`` package that ``PYTHONPATH``
names, so one copy of the script times two checkouts in one call on one card
(in turns: A, B, B, A). Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import statistics
import tempfile
import time

import torch

H = 512
FEAT = 4096
LENGTH = 80
VOCAB = 10240
# The port's kernels by the symbol of their CUDA function.
KERNELS = {"gru_seq_fwd": "gru_seq_fwd_kernel", "gru_seq_bwd": "gru_seq_bwd_kernel",
           "lstm_seq_fwd": "lstm_seq_fwd_kernel", "lstm_seq_bwd": "lstm_seq_bwd_kernel",
           "fused_s2vt_fwd": "s2vt_fused_fwd", "fused_s2vt_bwd": "s2vt_fused_bwd"}


def card_line() -> str:
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def trainer(root: str, seed: int, rnn_type: str, num_layers: int, batch: int, dtype: str):
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.dataset import make_synthetic_corpus
    from s2vt_tpu_torch.training import Trainer
    meta = make_synthetic_corpus(root, n_videos=32, vocab_extra=8, max_caption_words=24,
                                 feat_len=LENGTH, feat_dim=FEAT, seed=seed)
    opt = Opt(caption_file=meta["captions_file"], feats_path=meta["feat_path"],
              gts_file=meta["gts_file"], train_length=LENGTH, dim_hidden=H, dim_embed=H,
              feat_dim=FEAT, vocab_pad_multiple=VOCAB, batch_size=batch, use_pallas=True,
              compute_dtype=dtype, seed=seed, rnn_type=rnn_type, num_layers=num_layers,
              save_path=f"{root}/ckpt", log_dir=f"{root}/runs")
    return Trainer(opt, device="cuda")


def random_batch(batch: int, vocab: int, seed: int):
    """(feats, labels, mask, valid) on the card: captions of 4..26 tokens."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(batch, LENGTH, FEAT, generator=gen)
    mask = (torch.arange(LENGTH)[None, :] < torch.randint(4, 27, (batch, 1), generator=gen))
    labels = torch.randint(0, vocab, (batch, LENGTH), generator=gen) * mask.long()
    return tuple(t.cuda() for t in (feats, labels, mask.float(), torch.ones(batch)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rnn_type", default="gru", choices=("lstm", "gru"))
    ap.add_argument("--num_layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_time needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as root:
        tr = trainer(root, args.seed, args.rnn_type, args.num_layers, args.batch, args.dtype)
        step_args = random_batch(args.batch, tr.train_ds.vocab_size, args.seed + 2)
        for _ in range(3):
            tr.train_step(*step_args).item()
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            tr.train_step(*step_args).item()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.train_step(*step_args).item()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    own = {k: (sum(e.self_device_time_total for e in kernels if sym in e.key) / 1e3,
               sum(e.count for e in kernels if sym in e.key)) for k, sym in KERNELS.items()}
    print(f"train step {args.label} rnn={args.rnn_type} layers={args.num_layers} "
          f"B={args.batch} {args.dtype}: host_ms median={med:.3f} min={min(secs) * 1e3:.3f} "
          f"max={max(secs) * 1e3:.3f} (of {args.reps}) clips_per_s={args.batch / med * 1e3:.1f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / med:.4f} "
          f"device_kernels={sum(e.count for e in kernels)} "
          + " ".join(f"{k}_ms={ms:.3f}x{n}" for k, (ms, n) in own.items() if n)
          + f" [{card_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
