from vcagan_torch.io.weights import from_jax, load_serving_npz, read_serving_npz

__all__ = ["from_jax", "load_serving_npz", "read_serving_npz"]
