"""Caption losses (counterpart of ``acvae_tpu/ops/losses.py:29-99``).

Masked means divide by ``max(Σmask, 1)``; ``mask=None`` averages over every
position, like the reference call site (pytorch_runner_vae.py:315).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _target_logp(logprobs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE averaged over valid positions."""
    nll = -_target_logp(F.log_softmax(logits, dim=-1), targets)
    return _masked_mean(nll, mask)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed CE (utils/train_util.py:234-251): smoothing/(V-1)
    everywhere, 1-smoothing on the target, mean over valid positions."""
    vocab = logits.shape[-1]
    confidence = 1.0 - smoothing
    off_value = smoothing / (vocab - 1)
    logprobs = F.log_softmax(logits, dim=-1)
    sum_logp = torch.sum(logprobs, dim=-1)
    per_tok = (-off_value * sum_logp
               - (confidence - off_value) * _target_logp(logprobs, targets))
    return _masked_mean(per_tok, mask)


def _normal_kl(mu_q, logvar_q, mu_p, logvar_p):
    v_q = torch.exp(logvar_q)
    v_p = torch.exp(logvar_p)
    return (0.5 * (logvar_p - logvar_q) + (v_q + (mu_q - mu_p) ** 2) / (2.0 * v_p)
            - 0.5)


def normal_kl_loss(mu_q: torch.Tensor, logvar_q: torch.Tensor,
                   mu_p: torch.Tensor, logvar_p: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Analytic KL(N(mu_q, e^lv_q) ‖ N(mu_p, e^lv_p)), summed over the
    feature dim, masked mean over the leading dims."""
    kl = torch.sum(_normal_kl(mu_q, logvar_q, mu_p, logvar_p), dim=-1)
    return _masked_mean(kl, mask)


def normal_kl_per_dim(mu_q: torch.Tensor, logvar_q: torch.Tensor,
                      mu_p: torch.Tensor, logvar_p: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-latent-dimension KL, masked mean over the leading dims -> [E]
    (feeds the ``active_units`` / ``kl_dim_max`` diagnostics)."""
    kl = _normal_kl(mu_q, logvar_q, mu_p, logvar_p)
    if mask is None:
        return kl.reshape(-1, kl.shape[-1]).mean(dim=0)
    m = mask.to(kl.dtype)[..., None]
    flat_kl = (kl * m).reshape(-1, kl.shape[-1])
    return torch.sum(flat_kl, dim=0) / torch.clamp_min(torch.sum(m), 1.0)
