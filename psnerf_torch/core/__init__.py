"""Encoding and camera math (counterparts of psnerf_tpu/core)."""
