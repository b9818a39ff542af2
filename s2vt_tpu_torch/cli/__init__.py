"""Command-line entry points of the port (``python -m s2vt_tpu_torch.cli.train``)."""
