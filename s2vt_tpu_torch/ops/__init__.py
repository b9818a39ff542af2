"""Cells, layers and the fused S2VT kernel (counterpart of ``s2vt_tpu.ops``)."""
