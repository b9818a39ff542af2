"""Training CLI of the port: ``python -m s2vt_tpu_torch.cli.train``.

Counterpart of ``s2vt_tpu/cli/train.py`` (the reference's ``python
train.py``, train.py:178-179). Every ``Opt`` field is a flag, e.g.
``--lr 1e-4 --batch_size 16 --EPOCHS 300``; ``--config`` loads an
``opt.json`` (as ``save_opt`` writes it) as the base values. ``--device``
picks the torch device: the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from s2vt_tpu_torch.config import Opt, load_opt

_OWN_FLAGS = ("config", "device")


def add_opt_flags(ap: argparse.ArgumentParser, opt: Opt) -> None:
    for f in dataclasses.fields(Opt):
        if f.name == "start_time":
            continue
        val = getattr(opt, f.name)
        if isinstance(val, bool):
            ap.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                            default=None, metavar="BOOL")
        elif isinstance(val, (int, float, str)):
            ap.add_argument(f"--{f.name}", type=type(val), default=None)
        elif isinstance(val, tuple):
            ap.add_argument(f"--{f.name}", type=lambda s: tuple(int(x) for x in s.split(",")),
                            default=None, metavar="N,M")


def opt_from_args(args: argparse.Namespace, base: Opt) -> Opt:
    overrides = {k: v for k, v in vars(args).items() if v is not None and k not in _OWN_FLAGS}
    return base.replace(**overrides)


def _print_epoch(trainer, epoch: int) -> None:
    h = trainer.history
    metrics = h.get("metrics", [])
    scores = "".join(f" {k} {v:.4f}" for k, v in metrics[-1].items() if k != "epoch"
                     ) if metrics and metrics[-1]["epoch"] == epoch else ""
    print(f"epoch {epoch}: train_loss {h['train_loss'][-1]:.4f} valid_loss "
          f"{h['valid_loss'][-1]:.4f} lr {h['lr'][-1]:.2e} "
          f"clips/s {h['clips_per_sec'][-1]:.1f}{scores}", flush=True)


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags, train, and return the ``Trainer``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, default=None,
                    help="JSON config file (an opt.json written by save_opt)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to train on (default: the CUDA card)")
    add_opt_flags(ap, Opt())
    args = ap.parse_args(argv)

    base = load_opt(args.config) if args.config else Opt()
    opt = opt_from_args(args, base)

    from s2vt_tpu_torch.training.loop import Trainer
    trainer = Trainer(opt, device=args.device)
    history = trainer.fit(on_epoch_end=_print_epoch)
    print(f"finished after {len(history['train_loss'])} epochs; best valid loss "
          f"{min(history['valid_loss'], default=float('nan')):.4f}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
