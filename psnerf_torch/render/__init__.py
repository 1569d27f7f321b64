"""Stage-2 shading (counterpart of psnerf_tpu/render)."""
