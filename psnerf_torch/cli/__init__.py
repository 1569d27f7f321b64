"""Command line (counterpart of psnerf_tpu/cli): `python -m
psnerf_torch.cli.main <command>` and `python -m psnerf_torch.cli.plot_metrics`."""
