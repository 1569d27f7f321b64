"""Checkpoints, stage-2 params and configs (counterparts of psnerf_tpu/train)."""
