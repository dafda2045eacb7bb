"""Plain PyTorch/NumPy reference of the benchmark's configurations."""
