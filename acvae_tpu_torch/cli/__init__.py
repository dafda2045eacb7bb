"""The experiment CLI: ``python -m acvae_tpu_torch.cli <command> ...``."""
