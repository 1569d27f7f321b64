"""The benchmark of psnerf_torch: run.py drives one cell."""
