"""Feature-extraction CLI of the port: ``python -m s2vt_tpu_torch.cli.extract``.

Counterpart of ``s2vt_tpu/cli/extract.py`` (the reference's ``python
extract_features.py``), with its flags. The backbone is built once and
streamed over the clips; VGG16's conv blocks run the fused conv kernel.
``--device`` picks the torch device (default: the CUDA card). ``--mesh_shape
D M`` under ``python -m torch.distributed.run --nproc_per_node D*M`` splits
each forward's frames over the D data ranks; rank 0 writes the files.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--video_path", required=True,
                    help="directory of MSVD/MSR-VTT videos (or frame dirs)")
    ap.add_argument("--mode", required=True, choices=["fix", "free"],
                    help="'fix': frames_num evenly spaced frames; 'free': every interval-th "
                         "frame")
    ap.add_argument("--feat_path", default="./data/feats")
    ap.add_argument("--model", default="vgg16",
                    choices=["vgg16", "vgg16_bn", "resnet152", "inception_v4", "tiny"])
    ap.add_argument("--interval", type=int, default=10)
    ap.add_argument("--frames_num", type=int, default=80)
    ap.add_argument("--weights", default=None,
                    help="path to a pretrained torch .pth state_dict (pretrainedmodels zoo "
                         "format)")
    ap.add_argument("--compute_dtype", default=None, choices=[None, "bfloat16"],
                    help="bfloat16 conv and linear operands")
    ap.add_argument("--clip_batch", type=int, default=4,
                    help="fix-mode clips per device forward (1 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device to extract on (default: the CUDA card)")
    ap.add_argument("--mesh_shape", type=int, nargs=2, default=None, metavar="N",
                    help="(data, model) mesh under torch.distributed.run")
    args = ap.parse_args(argv)

    from s2vt_tpu_torch.extract import extract
    from s2vt_tpu_torch.parallel import distributed, make_mesh

    mesh = None
    if args.mesh_shape is not None and tuple(args.mesh_shape) != (1, 1):
        distributed.initialize(device=args.device)
        mesh = make_mesh(args.mesh_shape, args.device)
    n = extract(args.video_path, args.feat_path, model=args.model, mode=args.mode,
                frames_num=args.frames_num, interval=args.interval, weights=args.weights,
                compute_dtype=args.compute_dtype, clip_batch=args.clip_batch,
                device=args.device, mesh=mesh)
    if distributed.process_index() == 0:
        print(f"extracted features for {n} clips -> {args.feat_path}", flush=True)
    return n


if __name__ == "__main__":
    main()
