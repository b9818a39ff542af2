"""Evaluation CLI of the port: ``python -m s2vt_tpu_torch.cli.eval``.

Counterpart of ``s2vt_tpu/cli/eval.py`` (the reference's ``python eval.py``,
eval.py:222-235): decode a split of a checkpoint greedily (or with beam
search) and score BLEU-1..4 / METEOR / ROUGE-L / CIDEr against gts.json;
prints one ``metric: value`` line per score. ``--device`` picks the torch
device: the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Parse the flags, decode, score, print; returns the scores."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", required=True,
                    help="checkpoint directory (as written by Trainer.save)")
    ap.add_argument("--caption_file", default=None)
    ap.add_argument("--feats_path", default=None)
    ap.add_argument("--gts_file", default="./data/gts.json")
    ap.add_argument("--batch_size", type=int, default=10)  # eval.py:27
    ap.add_argument("--split", default="test", choices=["train", "valid", "test"])
    ap.add_argument("--beam", action="store_true",
                    help="beam search instead of greedy (eval.py:223)")
    ap.add_argument("--beam_width", type=int, default=3)
    ap.add_argument("--max_beam_depth", type=int, default=30)
    ap.add_argument("--beam_score_mode", default="cumulative",
                    choices=["cumulative", "reference"],
                    help="'reference' replays the reference's last-step-logp "
                         "beam scoring quirk (S2VTModel.py:221-223)")
    ap.add_argument("--meteor_jar", default=None,
                    help="optional meteor-1.5.jar for jar-exact METEOR")
    ap.add_argument("--meteor_paraphrases", default=None,
                    help="paraphrase-en.gz-format table for the lite "
                         "METEOR's paraphrase stage (gz or plain text)")
    ap.add_argument("--meteor_function_words", default=None,
                    help="function-word list file (one word per line), e.g. "
                         "the jar's function.words or one derived via "
                         "metrics.meteor.derive_function_words")
    ap.add_argument("--dump_predictions", default=None,
                    help="write {video_id: caption} JSON here")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to decode on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from s2vt_tpu_torch.evaluation import beam_eval, greedy_eval, score_predictions

    if args.beam:
        preds = beam_eval(args.model_path, args.caption_file, args.feats_path,
                          batch_size=args.batch_size, beam_width=args.beam_width,
                          max_beam_depth=args.max_beam_depth, mode=args.split,
                          beam_score_mode=args.beam_score_mode, device=args.device)
    else:
        preds = greedy_eval(args.model_path, args.caption_file, args.feats_path,
                            batch_size=args.batch_size, mode=args.split, device=args.device)

    if args.dump_predictions:
        with open(args.dump_predictions, "w", encoding="utf-8") as f:
            json.dump(preds, f, indent=1)

    with open(args.gts_file, encoding="utf-8") as f:
        gts = json.load(f)["gts"]
    fw = None
    if args.meteor_function_words:
        with open(args.meteor_function_words, encoding="utf-8") as f:
            fw = [w.strip() for w in f if w.strip()]
    scores = score_predictions(preds, gts, verbose=False,
                               meteor_jar=args.meteor_jar,
                               meteor_paraphrases=args.meteor_paraphrases,
                               meteor_function_words=fw)
    for metric, value in scores.items():
        print(f"{metric}: {value:.4f}")
    return scores


if __name__ == "__main__":
    main()
