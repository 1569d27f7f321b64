"""Stage runners (counterparts of psnerf_tpu/runners)."""
