"""PyTorch + CUDA port of the vcagan serving path and train step, for
NVIDIA Hopper.

The JAX package ``vcagan`` is the reference; this package imports nothing
of it and nothing of JAX.  Entry points run on CUDA unless the caller asks
for the CPU (``device="cpu"``), where the plain PyTorch versions of the
kernels run.
"""
