"""Prior / posterior latent networks (counterpart of
``acvae_tpu/models/latent.py:43-70, 115-142, 176-248``).

* :class:`PosteriorRNNHybrid` — token-level q(z_t | x) from a masked BiGRU
  over the shifted caption, plus the utterance embedding (masked mean + max
  of the BiGRU states) for the global constraint (text_encoder.py:156-216).
* :class:`PriorRNN` — p(z_t | x_{<t}, A, z_{t-1}) as a per-step API:
  word->audio attention, LSTM over [word; ctx; z_{t-1}], Linear -> (μ, log σ²)
  (text_encoder.py:218-268).  The LSTM state is sized by ``hidden_size``
  (the reference sizes it by ``embed_size``, text_encoder.py:240-245).

Noise is an explicit ``eps`` argument.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from acvae_tpu_torch.models.attention import AdditiveAttention
from acvae_tpu_torch.models.rnn import GRU, LSTMCell
from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens

# ±4 keeps the posterior z-chain bounded (z scale <= e^2); the reference
# leaves log σ² unclamped and can reach inf/nan at init.
MAX_LOGVAR = 4.0


def reparameterize(mean: torch.Tensor, log: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = μ + ε·exp(½·log σ²) (text_encoder.py:143-144)."""
    return eps * torch.exp(0.5 * log) + mean


def split_mean_log(ml: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a stacked (μ, log σ²) projection; clamp log σ² to ±MAX_LOGVAR."""
    mean, log = torch.chunk(ml, 2, dim=-1)
    return mean, torch.clamp(log, -MAX_LOGVAR, MAX_LOGVAR)


def _xavier_linear(i: int, o: int, device) -> nn.Linear:
    lin = nn.Linear(i, o, device=device)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class PosteriorRNNHybrid(nn.Module):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 embed_size: int = 512, hidden_size: int = 256, device=None):
        super().__init__()
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.network = GRU(word_dim, hidden_size, bidirectional=True,
                           device=device)
        self.token_mean_log = _xavier_linear(2 * hidden_size, 2 * embed_size,
                                             device)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """caps: [N, L]; eps: [N, L-1, E].  Returns q_means/q_logs/q_z
        [N, L-1, E] and q_means_utt [N, 2H]."""
        x = self.word_embedding(caps[:, :-1])
        lens = cap_lens - 1
        hidden_o, _ = self.network(x, lens)            # zeros past len
        means, logs = split_mean_log(self.token_mean_log(hidden_o))
        z = reparameterize(means, logs, eps)
        hidden = mean_with_lens(hidden_o, lens) + max_with_lens(hidden_o, lens)
        return {"q_means": means, "q_logs": logs, "q_z": z,
                "q_means_utt": hidden}


class PriorRNN(nn.Module):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 audiofeats_size: int = 512, embed_size: int = 512,
                 hidden_size: int = 512, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.word_attn = AdditiveAttention(word_dim, audiofeats_size,
                                           audiofeats_size, device=device)
        self.network = LSTMCell(word_dim + audiofeats_size + embed_size,
                                hidden_size, device=device)
        self.mean_log_out = _xavier_linear(hidden_size, 2 * embed_size, device)

    def init_state(self, batch: int, device=None, dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
        return (z, z)

    def project_enc(self, enc_mem: torch.Tensor) -> torch.Tensor:
        return self.word_attn.project_enc(enc_mem)

    def step(self, word: torch.Tensor, enc_mem: torch.Tensor,
             enc_proj: torch.Tensor, enc_mask: torch.Tensor,
             state: Tuple[torch.Tensor, torch.Tensor], last_z: torch.Tensor,
             eps: torch.Tensor) -> Dict[str, Any]:
        """One prior step: word [N] int; enc_mem [N, S, E]; enc_proj
        [N, S, attn]; enc_mask [N, S]; state (h, c); last_z, eps [N, E]."""
        x = self.word_embedding(word)
        ctx, attn_w = self.word_attn(x, enc_mem, enc_proj, enc_mask)
        h, c = self.network(torch.cat([x, ctx, last_z], dim=-1), state)
        mean, log = split_mean_log(self.mean_log_out(h))
        return {"mean": mean, "log": log, "z": reparameterize(mean, log, eps),
                "state": (h, c), "attn_weights": attn_w}
