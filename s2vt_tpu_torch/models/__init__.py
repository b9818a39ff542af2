"""Captioning models (counterpart of ``s2vt_tpu.models``)."""

from s2vt_tpu_torch.models.s2vt import S2VT  # noqa: F401
