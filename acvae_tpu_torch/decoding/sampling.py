"""Next-word sampling (counterpart of ``acvae_tpu/decoding/sampling.py:15-39``).

Greedy argmax, gumbel perturbation, or temperature sampling; every method
returns (word [N] int64, log-probability of that word [N]).  The noise of
``gumbel`` and ``sample`` is a Gumbel draw ``g`` of the logits' shape,
passed in as ``gumbel`` or drawn from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_next_word(logits: torch.Tensor, method: str = "greedy",
                     temp: float = 1.0, gumbel: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, V] -> (word [N] int64, logprob [N]).

    * ``greedy``: argmax of the log-softmax (word_model.py:178-179).
    * ``gumbel``: argmax of ``logprobs + g``; the reported logprob is the
      unperturbed one (word_model.py:188-197).
    * ``sample``: the categorical over ``logprobs / temp``, drawn as the
      argmax of ``logprobs / temp + g`` (word_model.py:198-203).

    The log-softmax is in float32; ties go to the first index."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    if method == "greedy":
        w = torch.argmax(logprobs, dim=-1)
    elif method in ("gumbel", "sample"):
        g = (gumbel_noise(logprobs.shape, generator, logprobs.device)
             if gumbel is None else gumbel.to(logprobs.device))
        x = logprobs if method == "gumbel" else logprobs / temp
        w = torch.argmax(x + g, dim=-1)
    else:
        raise ValueError(f"unknown sampling method {method!r}")
    return w, torch.gather(logprobs, -1, w[:, None])[:, 0]
