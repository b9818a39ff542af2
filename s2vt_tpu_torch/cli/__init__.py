"""Command-line entry points of the port (``python -m s2vt_tpu_torch.cli.train``).

Console scripts (pyproject.toml): s2vt-torch-train, s2vt-torch-eval,
s2vt-torch-prepare-captions, s2vt-torch-extract-features and
s2vt-torch-export-serving, the counterparts of the JAX package's s2vt-*
scripts. Each function imports its module when called: a package that
imported ``cli.train`` at import time would make ``python -m
s2vt_tpu_torch.cli.train`` run a module already in ``sys.modules``
(runpy's RuntimeWarning). Each returns None, as the JAX package's mains
do: the installed script runs ``sys.exit(fn())``, which would print a main's
result (the Trainer, a scores dict, a clip count) and exit with a failure
code.
"""


def train_main():
    from s2vt_tpu_torch.cli.train import main
    main()


def eval_main():
    from s2vt_tpu_torch.cli.eval import main
    main()


def prepare_main():
    from s2vt_tpu_torch.cli.prepare import main
    main()


def extract_main():
    from s2vt_tpu_torch.cli.extract import main
    main()


def export_serving_main():
    from s2vt_tpu_torch.cli.export_serving import main
    main()
