"""Composite loss wrappers (counterpart of ``acvae_tpu/losses/wrappers.py``).

* :func:`masked_cross_entropy` / :func:`masked_label_smoothing` — the
  length-masked losses (loss.py:12-70).
* :func:`augment_keep_mask` (host, numpy) and :func:`augment_loss` —
  ``AugmentLossWrapper`` (loss.py:72-94): a caption whose ``cap_id`` holds
  "aug" is kept with ``use_aug_prob``, every other caption always.
* :func:`reparameterize_argmax` / :func:`gumbel_softmax` — straight-through
  one-hots (loss.py:96-125): the value of the hard one-hot, the gradient of
  the soft distribution.  The Gumbel noise is a tensor of the logits' shape,
  passed in or drawn from a ``torch.Generator``.
* :func:`bce_logits_loss` — BCE on probabilities clamped to [1e-7, 1-1e-7]
  (loss.py:258-277).
* :func:`condition_loss`, :func:`specificity_loss` (loss.py:127-181) and
  :func:`adverse_loss` (loss.py:279-319: CE + β·KL + α·discriminator BCE,
  the terms composed rather than the reference's discarded sum).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from acvae_tpu_torch.decoding.sampling import gumbel_noise
from acvae_tpu_torch.ops.losses import _target_logp, cross_entropy, normal_kl_loss
from acvae_tpu_torch.ops.masked import length_mask, mean_with_lens
from acvae_tpu_torch.parallel import state as pstate


def _reduce(per: torch.Tensor, mask: torch.Tensor, reduction: str):
    if reduction == "none":
        return per
    if reduction == "sum":
        return per.sum()
    return per.sum() / torch.clamp_min(mask.sum(), 1.0)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         lens: torch.Tensor, reduction: str = "mean"):
    """loss.py:12-37: CE over the first ``lens`` targets of each row."""
    mask = length_mask(lens, targets.shape[1]).to(logits.dtype)
    nll = -_target_logp(F.log_softmax(logits, dim=-1), targets) * mask
    return _reduce(nll, mask, reduction)


def masked_label_smoothing(logits: torch.Tensor, targets: torch.Tensor,
                           lens: torch.Tensor, smoothing: float = 0.1,
                           reduction: str = "mean"):
    """loss.py:39-70: smoothing/(V-1) off the target, 1-smoothing on it."""
    mask = length_mask(lens, targets.shape[1]).to(logits.dtype)
    V = logits.shape[-1]
    conf, off = 1.0 - smoothing, smoothing / (V - 1)
    logprobs = F.log_softmax(logits, dim=-1)
    per = (-off * logprobs.sum(-1)
           - (conf - off) * _target_logp(logprobs, targets)) * mask
    return _reduce(per, mask, reduction)


def augment_keep_mask(cap_ids: Sequence, use_aug_prob: float,
                      rng: np.random.Generator) -> np.ndarray:
    """[N] bool: the captions tagged "aug" kept where ``rng.random() <
    use_aug_prob`` (one draw each, in order), the others always
    (loss.py:82-89)."""
    is_aug = np.array(["aug" in str(c) for c in cap_ids])
    keep = ~is_aug
    keep[is_aug] = rng.random(is_aug.sum()) < use_aug_prob
    return keep


def augment_loss(logits: torch.Tensor, targets: torch.Tensor,
                 lens: torch.Tensor, keep_mask: torch.Tensor,
                 smoothing: float = 0.0, eps: float = 1e-12) -> torch.Tensor:
    """loss.py:72-94: the per-token CE (label-smoothed when ``smoothing`` >
    0) of the kept rows, over their token count."""
    per = (masked_label_smoothing(logits, targets, lens, smoothing, "none")
           if smoothing > 0 else
           masked_cross_entropy(logits, targets, lens, "none"))
    keep = keep_mask.to(per.dtype)[:, None]
    mask = length_mask(lens, targets.shape[1]).to(per.dtype) * keep
    return (per * keep).sum() / (pstate.global_count(mask) + eps)


def _straight_through(y: torch.Tensor) -> torch.Tensor:
    hard = F.one_hot(torch.argmax(y, -1), y.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


def reparameterize_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The one-hot of the argmax, with the logits' gradient
    (loss.py:96-104)."""
    return _straight_through(logits)


def gumbel_softmax(logits: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                   temperature: float = 1.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The one-hot of ``argmax(softmax((logits + g) / temperature))``, with
    the softmax's gradient (loss.py:106-125); ``g`` is ``gumbel`` or drawn
    from ``generator``."""
    g = (gumbel_noise(logits.shape, generator, logits.device)
         if gumbel is None else gumbel.to(logits.device, logits.dtype))
    return _straight_through(torch.softmax((logits + g) / temperature, dim=-1))


def bce_logits_loss(probs: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Mean BCE of probabilities clamped to [1e-7, 1 - 1e-7]
    (loss.py:258-277)."""
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    return pstate.batch_mean(-(pos_weight * targets * torch.log(p)
                               + (1 - targets) * torch.log(1 - p)))


def _sample_preds(logits: torch.Tensor, sample_method: str,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The caption sample a discriminator reads: ``argmax`` and ``gumbel``
    straight-through one-hots, ``weighted`` the softmax."""
    if sample_method == "argmax":
        return reparameterize_argmax(logits)
    if sample_method == "gumbel":
        return gumbel_softmax(logits, gumbel, generator=generator)
    if sample_method == "weighted":
        return torch.softmax(logits, -1)
    raise ValueError(f"sample method {sample_method!r} not supported")


def condition_loss(word_loss, logits, conditions, lens, dscrm_fn: Callable,
                   alpha: float = 1.0, sample_method: str = "argmax",
                   gumbel: Optional[torch.Tensor] = None):
    """ConditionLossWrapper (loss.py:127-155): word loss + α·BCE of
    ``dscrm_fn({caps, lens})`` (probabilities) against ``conditions``."""
    preds = _sample_preds(logits, sample_method, gumbel)
    probs = dscrm_fn({"caps": preds, "lens": lens - 1})
    cond = bce_logits_loss(probs, conditions)
    return word_loss + alpha * cond, word_loss, cond


def specificity_loss(word_loss, logits, conditions, lens,
                     word_specificity: torch.Tensor, alpha: float = 1.0,
                     sentence_reduce: str = "sum"):
    """SpecificityLossWrapper (loss.py:157-181): the expected word
    specificity, summed (or averaged) over ``lens - 1`` steps, regressed on
    ``conditions``."""
    cond_pred = torch.softmax(logits, -1) @ word_specificity      # [N, T]
    lens = lens - 1
    if sentence_reduce == "sum":
        mask = length_mask(lens, cond_pred.shape[1]).to(cond_pred.dtype)
        cond_pred = torch.sum(cond_pred * mask, dim=1)
    else:
        cond_pred = mean_with_lens(cond_pred[..., None], lens)[..., 0]
    cond = torch.mean((cond_pred - conditions) ** 2)
    return word_loss + alpha * cond, word_loss, cond


def adverse_loss(packed_logits, targets, q_means, q_logs, p_means, p_logs,
                 logits, label, lens, dscrm_fn: Callable,
                 alpha: float = 1.0, beta: float = 1.0,
                 sample_method: str = "argmax", mask=None, audio_feats=None,
                 feats_lens=None, kl_mask="same",
                 gumbel: Optional[torch.Tensor] = None):
    """AdverseLossWrapper (loss.py:279-319): (loss, ce, kl, dscrm) with
    loss = CE + β·KL + α·BCE(``dscrm_fn`` of the audio and the sampled
    caption, ``label``).  ``mask`` scopes the CE; the KL reuses it
    (``kl_mask="same"``) or takes ``kl_mask`` itself (None: every
    position)."""
    ce = cross_entropy(packed_logits, targets, mask)
    kl = normal_kl_loss(q_means, q_logs, p_means, p_logs,
                        mask if kl_mask == "same" else kl_mask)
    preds = _sample_preds(logits, sample_method, gumbel)
    probs = dscrm_fn({"audio_feats": audio_feats, "feats_lens": feats_lens,
                      "caps": preds, "lens": lens - 1})
    dscrm = bce_logits_loss(probs, label)
    return ce + beta * kl + alpha * dscrm, ce, kl, dscrm
