"""Hand-written Hopper kernels (sources in ``vcagan_torch/csrc``), each with
its plain PyTorch version beside it."""
