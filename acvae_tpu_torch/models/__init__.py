"""The flagship Hybrid AC-VAE in PyTorch, with the reference's parameter names."""
