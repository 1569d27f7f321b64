"""Hand-written CUDA kernels and their plain PyTorch versions
(counterparts of the Pallas kernels in psnerf_tpu/ops)."""
