"""MLPs, BRDFs and the PSNet heads (counterparts of psnerf_tpu/fields)."""
