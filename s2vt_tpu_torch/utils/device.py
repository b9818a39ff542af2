"""Device selection for the port's entry points.

Entry points take ``device=None``, which means the card ("cuda"). Without a
card they raise unless the caller asks for the CPU: a run meant for the card
never quietly runs on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev
