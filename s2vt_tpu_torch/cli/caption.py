"""End-to-end clip captioning of the port: video or frame directory ->
backbone features -> caption, in one process:
``python -m s2vt_tpu_torch.cli.caption``.

Counterpart of ``s2vt_tpu/cli/caption.py``, with its flags and checks. The
decode comes from a checkpoint (``--model_path``) or from a serving artifact
(``--artifact``, ``cli/export_serving.py``), which replays without the model
code. ``--device`` picks the torch device (default: the CUDA card); an
artifact replays on the device it was exported for.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


class ClipCaptioner:
    """Serving object built once (checkpoint or artifact, vocab, backbone);
    then ``caption(paths)`` per request."""

    def __init__(self, model_path: str = None, captions_file: str = None,
                 backbone: str = "vgg16", weights: str = None, beam: bool = False,
                 compute_dtype: str = None, early_stop: bool = False, artifact: str = None,
                 device=None):
        from s2vt_tpu_torch.extract.pipeline import FeatureExtractor

        self.artifact = None
        if artifact is not None:
            from s2vt_tpu_torch.serving import ServingCaptioner
            self.artifact = ServingCaptioner(artifact)
            self.frames_num = self.artifact.manifest["length"]
        else:
            from s2vt_tpu_torch.config import Opt
            from s2vt_tpu_torch.data.corpus import load_captions, special_token_indices
            from s2vt_tpu_torch.evaluation.decode import model_from_checkpoint
            from s2vt_tpu_torch.training.checkpoint import load_config

            cfg = load_config(model_path)
            base_opt = Opt(**cfg) if cfg else Opt()
            data = load_captions(captions_file or base_opt.caption_file)
            self.ix2word = {int(k): v for k, v in data["ix2word"].items()}
            self.specials = special_token_indices(data["word2ix"])
            self.opt, self.model = model_from_checkpoint(model_path, len(data["word2ix"]),
                                                         device)
            self.frames_num = self.opt.train_length
        self.extractor = FeatureExtractor(backbone, weights, compute_dtype, device=device)
        self.beam = beam
        self.early_stop = early_stop

    def caption(self, inputs) -> dict:
        import numpy as np
        import torch

        from s2vt_tpu_torch.data.corpus import ids_to_sentence

        feats = np.stack([self.extractor.extract_clip(str(p), mode="fix",
                                                      frames_num=self.frames_num)
                          for p in inputs])
        if self.artifact is not None:
            return {str(p): s for p, s in zip(inputs, self.artifact.caption(feats))}
        x = torch.from_numpy(feats).to(next(self.model.parameters()).device)
        if self.beam:
            res = self.model.beam(x, self.opt.beam_width, self.opt.max_beam_depth,
                                  score_mode=self.opt.beam_score_mode)
            rows = res.tokens[:, 0, 1:].cpu().numpy()
        else:
            kw = {"early_stop": True} if self.early_stop else {}
            rows = self.model.greedy(x, **kw).cpu().numpy()
        sp = self.specials
        return {str(p): ids_to_sentence(ids, self.ix2word, sp["eos_ix"], sos_ix=sp["sos_ix"],
                                        pad_ix=sp["pad_ix"])
                for p, ids in zip(inputs, rows)}


def caption_clips(model_path: str, inputs, captions_file: str = None,
                  backbone: str = "vgg16", weights: str = None, beam: bool = False,
                  compute_dtype: str = None, device=None) -> dict:
    return ClipCaptioner(model_path, captions_file, backbone, weights, beam, compute_dtype,
                         device=device).caption(inputs)


def serve(captioner: ClipCaptioner, infile=None, outfile=None) -> int:
    """Line-oriented serving loop: one clip path (or a whitespace-separated
    batch of paths) per input line -> one JSON object per output line. A
    blank line or EOF ends the session; a bad clip answers with an error
    object. Returns the requests served."""
    import sys

    infile = infile if infile is not None else sys.stdin
    outfile = outfile if outfile is not None else sys.stdout
    served = 0
    for line in infile:
        paths = line.split()
        if not paths:
            break
        try:
            result = captioner.caption(paths)
        except Exception as e:  # a bad clip must not kill the server
            result = {"error": f"{type(e).__name__}: {e}", "paths": paths}
        print(json.dumps(result), file=outfile, flush=True)
        served += 1
    return served


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="*",
                    help="video files or frame directories (omit with --serve)")
    ap.add_argument("--serve", action="store_true",
                    help="long-lived serving loop: clip path(s) per stdin line -> JSON per "
                         "stdout line; model and backbone are built once")
    ap.add_argument("--model_path", default=None,
                    help="checkpoint directory (required unless --artifact)")
    ap.add_argument("--artifact", default=None,
                    help="serving artifact directory (from cli/export_serving.py); replaces "
                         "--model_path")
    ap.add_argument("--caption_file", default=None,
                    help="captions.json for the vocab (default: the one recorded in the "
                         "checkpoint config)")
    ap.add_argument("--backbone", default="vgg16",
                    choices=["vgg16", "vgg16_bn", "resnet152", "inception_v4", "tiny"])
    ap.add_argument("--weights", default=None, help="pretrained backbone .pth (imagenet)")
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--early_stop", action="store_true",
                    help="greedy decode stops once every clip has emitted <eos> (sentences "
                         "unchanged)")
    ap.add_argument("--compute_dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.model_path is None and args.artifact is None:
        ap.error("one of --model_path / --artifact is required")
    if args.artifact is not None:
        # The artifact's decode governs: flags that try to change it are
        # errors, not silent no-ops. --compute_dtype stays legal: it
        # configures the backbone, which runs outside the artifact.
        import pathlib
        if args.model_path is not None:
            ap.error("--artifact replaces --model_path; pass one, not both")
        if args.caption_file is not None:
            ap.error("--caption_file cannot apply with --artifact: the vocabulary is baked "
                     "into the artifact manifest")
        if args.early_stop:
            ap.error("--early_stop cannot apply with --artifact: the decode loop is baked "
                     "into the exported program")
        try:
            manifest = json.loads((pathlib.Path(args.artifact) / "manifest.json").read_text())
        except (OSError, ValueError) as e:   # missing, unreadable, corrupt
            ap.error(f"cannot read artifact manifest: {e}")
        if args.beam and manifest.get("mode") != "beam":
            ap.error(f"--beam cannot apply: artifact was exported with "
                     f"mode={manifest.get('mode')!r} (re-export with --beam, "
                     f"cli/export_serving.py)")
        if not args.beam and manifest.get("mode") == "beam":
            import sys
            print("note: artifact was exported with mode='beam'; replaying beam decode "
                  "(pass --beam to silence this)", file=sys.stderr)

    if not args.serve and not args.inputs:
        ap.error("provide clip paths, or use --serve")
    captioner = ClipCaptioner(args.model_path, args.caption_file, args.backbone, args.weights,
                              args.beam, args.compute_dtype, args.early_stop,
                              artifact=args.artifact, device=args.device)
    if args.serve:
        n = serve(captioner)
        print(f"served {n} request(s)", flush=True)
        return n
    result = captioner.caption(args.inputs)
    print(json.dumps(result, indent=1), flush=True)
    return result


if __name__ == "__main__":
    main()
