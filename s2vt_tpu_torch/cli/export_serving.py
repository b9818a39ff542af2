"""Export a trained checkpoint as a serving artifact (an exported PyTorch
program): ``python -m s2vt_tpu_torch.cli.export_serving``.

Counterpart of ``s2vt_tpu/cli/export_serving.py``, with its flags:

    python -m s2vt_tpu_torch.cli.export_serving --model_path checkpoint/... \\
        --out artifacts/msvd_greedy --batch 16 [--beam]

The artifact (decode.pt2 + manifest.json) is replayed by
``s2vt_tpu_torch.serving.ServingCaptioner``, or by the caption CLI's
``--artifact`` flag, without the model definition. It replays on the device
it was exported for: ``--device`` (default: the CUDA card). A checkpoint
trained with ``use_pallas`` exports its kernel route.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", required=True,
                    help="checkpoint directory (opt.json + params.npz)")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--caption_file", default=None,
                    help="captions.json for the vocab (default: the one recorded in the "
                         "checkpoint config)")
    ap.add_argument("--batch", default="16",
                    help="exported batch size, or 'poly' for a dynamic batch dimension (one "
                         "artifact serves any batch)")
    ap.add_argument("--beam", action="store_true",
                    help="export beam-search decode instead of greedy")
    ap.add_argument("--beam_width", type=int, default=None)
    ap.add_argument("--max_beam_depth", type=int, default=None)
    ap.add_argument("--feats_dtype", default="float32",
                    choices=("float32", "bfloat16", "float16", "int8"),
                    help="the artifact's feature-input dtype: bfloat16 halves the upload of "
                         "a request, int8 quarters it by per-clip absmax quantization with "
                         "dequantisation on the device (lossy: at most absmax/254 per "
                         "element)")
    ap.add_argument("--device", default=None,
                    help="torch device the artifact is exported for and replays on "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.data.corpus import load_captions, special_token_indices
    from s2vt_tpu_torch.evaluation.decode import model_from_checkpoint
    from s2vt_tpu_torch.serving import export_captioner
    from s2vt_tpu_torch.training.checkpoint import load_config

    cfg = load_config(args.model_path)
    base_opt = Opt(**cfg) if cfg else Opt()
    data = load_captions(args.caption_file or base_opt.caption_file)
    ix2word = {int(k): v for k, v in data["ix2word"].items()}
    specials = special_token_indices(data["word2ix"])
    opt, model = model_from_checkpoint(args.model_path, len(data["word2ix"]), args.device)
    batch = None if args.batch == "poly" else int(args.batch)
    out = export_captioner(
        model, ix2word, specials, batch, args.out, mode="beam" if args.beam else "greedy",
        beam_width=args.beam_width or opt.beam_width,
        max_beam_depth=args.max_beam_depth or opt.max_beam_depth,
        beam_score_mode=opt.beam_score_mode, feats_dtype=args.feats_dtype)
    print(f"exported {'beam' if args.beam else 'greedy'} captioner "
          f"(batch={'dynamic' if batch is None else batch}) to {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
