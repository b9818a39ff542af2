"""Corpus preparation CLI of the port: ``python -m s2vt_tpu_torch.cli.prepare``.

Counterpart of ``s2vt_tpu/cli/prepare.py`` (the reference's ``python
prepare_captions.py``): MSVD CSV or MSR-VTT JSON -> captions.json + gts.json,
with a seedable train/valid/test split, the same subcommands, flags and
printed line:

    python -m s2vt_tpu_torch.cli.prepare msvd --csv_file video_corpus.csv --seed 0
    python -m s2vt_tpu_torch.cli.prepare msr-vtt --train_source_file ... \\
        --test_source_file ...
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse the flags, write the artifacts, print one summary line and
    return the parser's result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="dataset", required=True)

    msvd = sub.add_parser("msvd", help="MSVD video_corpus.csv")
    msvd.add_argument("--csv_file", default="./data/video_corpus.csv")
    msvd.add_argument("--captions_file", default="./data/captions.json")
    msvd.add_argument("--gts_file", default="./data/gts.json")
    msvd.add_argument("--clean_only", action="store_true")
    msvd.add_argument("--min_feq", type=int, default=1)
    msvd.add_argument("--n_train", type=int, default=1400)
    msvd.add_argument("--n_valid", type=int, default=450)
    msvd.add_argument("--seed", type=int, default=None)

    vtt = sub.add_parser("msr-vtt", help="MSR-VTT train_val/test JSON")
    vtt.add_argument("--train_source_file", default="./data/train_val_videodatainfo.json")
    vtt.add_argument("--test_source_file", default="./data/test_videodatainfo.json")
    vtt.add_argument("--captions_file", default="./data/captions.json")
    vtt.add_argument("--gts_file", default="./data/gts.json")
    vtt.add_argument("--min_feq", type=int, default=1)

    args = ap.parse_args(argv)
    from s2vt_tpu_torch.data.corpus import parse_csv, parse_msr_vtt

    if args.dataset == "msvd":
        out = parse_csv(args.csv_file, args.captions_file, args.gts_file,
                        clean_only=args.clean_only, min_feq=args.min_feq,
                        split_sizes=(args.n_train, args.n_valid), seed=args.seed)
    else:
        out = parse_msr_vtt(args.train_source_file, args.test_source_file,
                            args.captions_file, args.gts_file, min_feq=args.min_feq)
    print(f"vocab size: {len(out['word2ix'])}; "
          f"videos: {len(out['captions'])}; "
          f"splits: { {k: len(v) for k, v in out['splits'].items()} }")
    return out


if __name__ == "__main__":
    main()
