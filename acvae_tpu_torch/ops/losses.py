"""Caption losses (counterpart of ``acvae_tpu/ops/losses.py:29-118``).

Masked means divide by ``max(Σmask, 1)``; ``mask=None`` averages over every
position, like the reference call site (pytorch_runner_vae.py:315).  Inside
a parallel train step (``parallel/state.py``) each mean is this rank's
share of the global batch's: the count is the global one, and a vocab-split
step's logits are this rank's vocab shard (``parallel/vocab.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.vocab import vp_logprob_parts


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return pstate.batch_mean(values)
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp_min(pstate.global_count(mask),
                                                      1.0)


def _vocab_split():
    st = pstate.active()
    return st.grid if st is not None and st.vocab_logits else None


def _target_logp(logprobs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE averaged over valid positions."""
    grid = _vocab_split()
    if grid is not None:
        return _masked_mean(-vp_logprob_parts(logits, targets, grid)[0], mask)
    nll = -_target_logp(F.log_softmax(logits, dim=-1), targets)
    return _masked_mean(nll, mask)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed CE (utils/train_util.py:234-251): smoothing/(V-1)
    everywhere, 1-smoothing on the target, mean over valid positions."""
    confidence = 1.0 - smoothing
    grid = _vocab_split()
    if grid is not None:
        target_logp, sum_logp, vocab = vp_logprob_parts(logits, targets, grid)
    else:
        vocab = logits.shape[-1]
        logprobs = F.log_softmax(logits, dim=-1)
        sum_logp = torch.sum(logprobs, dim=-1)
        target_logp = _target_logp(logprobs, targets)
    off_value = smoothing / (vocab - 1)
    per_tok = -off_value * sum_logp - (confidence - off_value) * target_logp
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
    (feeds the ``active_units`` / ``kl_dim_max`` diagnostics); in a parallel
    step this rank's share (the caller sums the shares)."""
    kl = _normal_kl(mu_q, logvar_q, mu_p, logvar_p)
    if mask is None:
        flat = kl.reshape(-1, kl.shape[-1])
        if pstate.data_extent() == 1:
            return flat.mean(dim=0)
        return flat.sum(dim=0) / (flat.shape[0] * pstate.data_extent())
    m = mask.to(kl.dtype)[..., None]
    flat_kl = (kl * m).reshape(-1, kl.shape[-1])
    return torch.sum(flat_kl, dim=0) / torch.clamp_min(pstate.global_count(m),
                                                       1.0)


def gmm_kl_loss(mu_q: torch.Tensor, logvar_q: torch.Tensor,
                logits_c_q: torch.Tensor, mu_p: torch.Tensor,
                logvar_p: torch.Tensor, logits_c_p: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mixture-of-Gaussians KL upper bound (utils/train_util.py:273-291):
    ``KL(c_q‖c_p) + masked mean of Σ_k c_q[k]·KL(q‖p_k)``.  mu/logvar:
    [K, ..., E] (the posterior's broadcast over K); logits_c: [K]."""
    c_q = torch.softmax(logits_c_q, dim=0)
    c_p = torch.softmax(logits_c_p, dim=0)
    kl_i = _normal_kl(mu_q, logvar_q, mu_p, logvar_p)
    kl_c = torch.sum(c_q * (torch.log(c_q) - torch.log(c_p)))
    c = c_q.reshape((c_q.shape[0],) + (1,) * (kl_i.ndim - 1))
    kl = torch.sum(torch.sum(c * kl_i, dim=0), dim=-1)
    if pstate.data_extent() > 1:   # a term of the parameters alone: once
        kl_c = kl_c / pstate.data_extent()
    return kl_c + _masked_mean(kl, mask)
