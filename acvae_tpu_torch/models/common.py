"""Shared decode helpers (counterpart of ``acvae_tpu/models/common.py:22-37``)."""
from __future__ import annotations

from typing import Optional

import torch


def eps_stack(steps: int, rows: int, dim: int,
              generator: Optional[torch.Generator] = None, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """[steps, rows, dim] standard normals: one prior-noise slab per step."""
    return torch.randn((steps, rows, dim), generator=generator, device=device,
                       dtype=dtype)
