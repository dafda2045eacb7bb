"""Additive (Bahdanau) attention (counterpart of
``acvae_tpu/models/attention.py:24-90``).

``score = v · tanh(W [h_dec; h_enc])`` with a length-masked softmax.  The
reference's single ``h2attn`` Linear over ``[h_dec; h_enc]`` is kept as the
parameter; it is applied split, ``W_enc h_enc + b`` once per utterance
(:meth:`project_enc`) and ``W_dec h_dec`` once per step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.ops.masked import NEG_INF


class AdditiveAttention(nn.Module):
    def __init__(self, dec_dim: int, enc_dim: int, attn_size: int, device=None):
        super().__init__()
        self.dec_dim = dec_dim
        self.h2attn = nn.Linear(dec_dim + enc_dim, attn_size, device=device)
        self.v = nn.Parameter(torch.randn(attn_size, device=device))

    def project_enc(self, h_enc: torch.Tensor) -> torch.Tensor:
        """[N, S, enc] -> [N, S, attn]; once per utterance."""
        return F.linear(h_enc, self.h2attn.weight[:, self.dec_dim:],
                        self.h2attn.bias)

    def forward(self, h_dec: torch.Tensor, h_enc: torch.Tensor,
                enc_proj: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h_dec: [Nq, dec]; h_enc: [N, S, enc]; enc_proj: [N, S, attn];
        mask: [N, S] bool (True = valid).  Returns (ctx [Nq, enc],
        weights [Nq, S]).

        ``Nq`` may be ``N * B`` (beam-folded queries, row-major per
        instance): query ``n*B + b`` attends over memory row ``n``.  The
        memory is broadcast over the beam axis, never replicated."""
        dec_proj = F.linear(h_dec, self.h2attn.weight[:, :self.dec_dim])
        N, Nq = h_enc.shape[0], h_dec.shape[0]
        if Nq != N:
            B = Nq // N
            score = torch.tanh(enc_proj[:, None]
                               + dec_proj.view(N, B, 1, -1)) @ self.v  # [N,B,S]
            if mask is not None:
                score = score.masked_fill(~mask[:, None], NEG_INF)
            weights = torch.softmax(score, dim=-1)
            ctx = torch.einsum("nbs,nse->nbe", weights, h_enc)
            return (ctx.reshape(Nq, h_enc.shape[-1]),
                    weights.reshape(Nq, h_enc.shape[1]))
        score = torch.tanh(enc_proj + dec_proj[:, None, :]) @ self.v
        if mask is not None:
            score = score.masked_fill(~mask, NEG_INF)
        weights = torch.softmax(score, dim=-1)
        ctx = torch.einsum("ns,nse->ne", weights, h_enc)
        return ctx, weights
