"""Hand-written Hopper kernels and their wrappers.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor (or raises).  Sources live in
``acvae_tpu_torch/csrc/`` and are built at first use by :mod:`.build`;
importing these modules needs neither ``nvcc`` nor a card.
"""
