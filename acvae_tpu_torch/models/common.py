"""Shared decode helpers (counterpart of ``acvae_tpu/models/common.py:22-37``
and the greedy branch of ``acvae_tpu/decoding/sampling.py:15-39``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def eps_stack(steps: int, rows: int, dim: int,
              generator: Optional[torch.Generator] = None, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """[steps, rows, dim] standard normals: one prior-noise slab per step."""
    return torch.randn((steps, rows, dim), generator=generator, device=device,
                       dtype=dtype)


def greedy(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, V] -> (argmax word [N] int64, its log-probability [N]).
    Ties go to the first index, as with ``jnp.argmax``."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    w = torch.argmax(logprobs, dim=-1)
    return w, torch.gather(logprobs, -1, w[:, None])[:, 0]
