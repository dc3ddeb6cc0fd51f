"""Hand-written Hopper kernels (sources in ``vcagan_torch/csrc``), each with
its plain PyTorch version beside it."""

import torch


def refuse_grad(kernel: str, **inputs: torch.Tensor) -> None:
    """The raw kernel launchers are forward only: their results carry no
    ``grad_fn``, so under grad mode an input that requires grad would
    silently get none.  Raise instead; the plain versions (CPU tensors) stay
    differentiable, and so does the attention through ``masked_cross_attention``
    (its ``autograd.Function``)."""
    if torch.is_grad_enabled():
        needs = [name for name, t in inputs.items() if t.requires_grad]
        if needs:
            raise RuntimeError(
                f"the {kernel} kernel is forward only, but inputs that require grad under grad "
                f"mode would get no gradient: {', '.join(needs)}; run it under torch.no_grad() "
                "or torch.inference_mode()"
            )
