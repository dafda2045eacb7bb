"""Length-masked reductions (counterpart of ``acvae_tpu/ops/masked.py``).

The time axis is the padded maximum; validity comes from ``lens``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e10  # matches the reference's masked_fill value (models/attn_model.py:41)


def length_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[N] lengths -> [N, max_len] bool mask (True = valid)."""
    idxs = torch.arange(max_len, device=lens.device)[None, :]
    return idxs < lens.long()[:, None]


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def mean_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked mean over axis 1. features: [N, T, ...], lens: [N]."""
    mask = _expand(length_mask(lens, features.shape[1]), features.ndim)
    total = torch.sum(features * mask, dim=1)
    denom = torch.clamp_min(lens.to(features.dtype), 1.0)
    return total / denom.reshape(denom.shape + (1,) * (features.ndim - 2))


def max_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked max over axis 1. features: [N, T, ...], lens: [N]."""
    mask = _expand(length_mask(lens, features.shape[1]), features.ndim)
    neg = torch.finfo(features.dtype).min
    return torch.amax(features.masked_fill(~mask, neg), dim=1)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   axis: int = -1) -> torch.Tensor:
    """Softmax over ``axis`` with the invalid entries (mask False) at
    ``NEG_INF``, so their weight is ~0 (``acvae_tpu/ops/masked.py:38-43``;
    no module of either package calls it)."""
    scores = torch.where(mask, scores, NEG_INF)
    scores = scores - torch.amax(scores, dim=axis, keepdim=True)
    e = torch.exp(scores)
    return e / torch.sum(e, dim=axis, keepdim=True)
