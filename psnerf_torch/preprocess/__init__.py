"""Dataset preprocessing (counterpart of psnerf_tpu/preprocess): SDPS-Net
light and normal estimation (sdps, runner) and the light-averaged and
intensity-normalized images (light_avg)."""
