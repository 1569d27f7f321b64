"""Scene loading and the synthetic scene (counterparts of psnerf_tpu/data)."""
