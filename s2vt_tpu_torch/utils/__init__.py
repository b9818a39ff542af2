"""Weight bridge and device selection (counterpart of ``s2vt_tpu.utils``)."""
