"""Frame rendering and metrics (counterparts of psnerf_tpu/eval)."""
