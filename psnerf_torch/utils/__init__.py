"""Utilities (counterparts of psnerf_tpu/utils)."""
