"""psnerf_torch — the PyTorch and CUDA port of psnerf_tpu for NVIDIA Hopper.

The subpackages mirror psnerf_tpu's (core, fields, render, ops, eval, data,
train, runners), so each module's counterpart has the same path. Parameters
keep the JAX package's layout (weights [din, dout], `/`-joined checkpoint
keys), so one .npz loads in either package.

Entry points run on the card (`device="cuda"`) and raise when CUDA is
missing; they run on the CPU only when the caller passes `device="cpu"`.
The hand-written CUDA kernels (psnerf_torch.ops) are built on first use, so
importing this package needs no GPU, no nvcc and no triton.
"""

__version__ = "0.1.0"
