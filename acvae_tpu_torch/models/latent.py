"""Prior / posterior latent networks (counterpart of
``acvae_tpu/models/latent.py:43-310``).

* :class:`PosteriorRNN` — q(z_t | x, z_{<t}): a masked BiGRU over the
  shifted caption, then a sequential z-chain through ``mean_log_out([h_t;
  z_{t-1}])`` (text_encoder.py:96-154).  The BiGRU outputs are zero past
  each length, so the padded steps still chain.
* :class:`PosteriorRNNHybrid` — token-level q(z_t | x) from a masked BiGRU
  over the shifted caption, plus the utterance embedding (masked mean + max
  of the BiGRU states) for the global constraint (text_encoder.py:156-216).
* :class:`PosteriorSentence` — one z per caption from the masked mean + max
  pool of the BiGRU states (the SimpleVAE ablation's posterior).
* :class:`PriorRNN` — p(z_t | x_{<t}, A, z_{t-1}) as a per-step API:
  word->audio attention, LSTM over [word; ctx; z_{t-1}], Linear -> (μ, log σ²)
  (text_encoder.py:218-268).  The LSTM state is sized by ``hidden_size``
  (the reference sizes it by ``embed_size``, text_encoder.py:240-245).
* :class:`GMMPriorRNN` — the mixture-of-Gaussians prior: the same step with
  K (μ, log σ²) heads laid out [K, N, E] and learned ``mixture_logits``; z
  comes from the argmax component (the first at a tie), or from the
  component a uniform ``component_u`` picks.

Noise is an explicit ``eps`` argument.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


class _BiGRUPosterior(nn.Module):
    """Word embedding + masked BiGRU over the shifted caption; the heads
    differ by family."""

    def __init__(self, vocab_size: int, word_dim: int = 512,
                 embed_size: int = 512, hidden_size: int = 256, device=None):
        super().__init__()
        self.embed_size = embed_size
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.network = GRU(word_dim, hidden_size, bidirectional=True,
                           device=device)

    def states(self, caps: torch.Tensor, cap_lens: torch.Tensor):
        """(BiGRU outputs [N, L-1, 2H], zeros past each length; lengths)."""
        lens = cap_lens - 1
        hidden_o, _ = self.network(self.word_embedding(caps[:, :-1]), lens)
        return hidden_o, lens


class PosteriorRNN(_BiGRUPosterior):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 embed_size: int = 512, hidden_size: int = 256, device=None):
        super().__init__(vocab_size, word_dim, embed_size, hidden_size, device)
        self.mean_log_out = _xavier_linear(2 * hidden_size + embed_size,
                                           2 * embed_size, device)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """caps: [N, L]; eps: [N, L-1, E].  Returns q_means/q_logs/q_z
        [N, L-1, E]."""
        hidden_o, _ = self.states(caps, cap_lens)
        z = torch.zeros((caps.shape[0], self.embed_size), dtype=hidden_o.dtype,
                        device=caps.device)
        ys = {"q_means": [], "q_logs": [], "q_z": []}
        for t in range(hidden_o.shape[1]):
            mean, log = split_mean_log(
                self.mean_log_out(torch.cat([hidden_o[:, t], z], dim=-1)))
            z = reparameterize(mean, log, eps[:, t])
            for k, v in (("q_means", mean), ("q_logs", log), ("q_z", z)):
                ys[k].append(v)
        return {k: torch.stack(v, dim=1) for k, v in ys.items()}


class PosteriorSentence(_BiGRUPosterior):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 embed_size: int = 512, hidden_size: int = 256, device=None):
        super().__init__(vocab_size, word_dim, embed_size, hidden_size, device)
        self.utterance_mean_log = _xavier_linear(2 * hidden_size,
                                                 2 * embed_size, device)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """eps: [N, E].  Returns one q_means/q_logs/q_z [N, E] a caption."""
        hidden_o, lens = self.states(caps, cap_lens)
        hidden = mean_with_lens(hidden_o, lens) + max_with_lens(hidden_o, lens)
        mean, log = split_mean_log(self.utterance_mean_log(hidden))
        return {"q_means": mean, "q_logs": log,
                "q_z": reparameterize(mean, log, eps)}


class PosteriorRNNHybrid(_BiGRUPosterior):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 embed_size: int = 512, hidden_size: int = 256, device=None):
        super().__init__(vocab_size, word_dim, embed_size, hidden_size, device)
        self.token_mean_log = _xavier_linear(2 * hidden_size, 2 * embed_size,
                                             device)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """caps: [N, L]; eps: [N, L-1, E].  Returns q_means/q_logs/q_z
        [N, L-1, E] and q_means_utt [N, 2H]."""
        hidden_o, lens = self.states(caps, cap_lens)
        means, logs = split_mean_log(self.token_mean_log(hidden_o))
        z = reparameterize(means, logs, eps)
        hidden = mean_with_lens(hidden_o, lens) + max_with_lens(hidden_o, lens)
        return {"q_means": means, "q_logs": logs, "q_z": z,
                "q_means_utt": hidden}


class PriorRNN(nn.Module):
    def __init__(self, vocab_size: int, word_dim: int = 512,
                 audiofeats_size: int = 512, embed_size: int = 512,
                 hidden_size: int = 512, device=None, heads: int = 1):
        super().__init__()
        self.hidden_size, self.embed_size = hidden_size, embed_size
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.word_attn = AdditiveAttention(word_dim, audiofeats_size,
                                           audiofeats_size, device=device)
        self.network = LSTMCell(word_dim + audiofeats_size + embed_size,
                                hidden_size, device=device)
        self.mean_log_out = _xavier_linear(hidden_size, 2 * heads * embed_size,
                                           device)

    def init_state(self, batch: int, device=None, dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
        return (z, z)

    def project_enc(self, enc_mem: torch.Tensor) -> torch.Tensor:
        return self.word_attn.project_enc(enc_mem)

    def _recur(self, word, enc_mem, enc_proj, enc_mask, state, last_z):
        """Attention read and LSTM step: (h, c, attention weights)."""
        x = self.word_embedding(word)
        ctx, attn_w = self.word_attn(x, enc_mem, enc_proj, enc_mask)
        h, c = self.network(torch.cat([x, ctx, last_z], dim=-1), state)
        return h, c, attn_w

    def step(self, word: torch.Tensor, enc_mem: torch.Tensor,
             enc_proj: torch.Tensor, enc_mask: torch.Tensor,
             state: Tuple[torch.Tensor, torch.Tensor], last_z: torch.Tensor,
             eps: torch.Tensor) -> Dict[str, Any]:
        """One prior step: word [N] int; enc_mem [N, S, E]; enc_proj
        [N, S, attn]; enc_mask [N, S]; state (h, c); last_z, eps [N, E]."""
        h, c, attn_w = self._recur(word, enc_mem, enc_proj, enc_mask, state,
                                   last_z)
        mean, log = split_mean_log(self.mean_log_out(h))
        return {"mean": mean, "log": log, "z": reparameterize(mean, log, eps),
                "state": (h, c), "attn_weights": attn_w}


class GMMPriorRNN(PriorRNN):
    """``mean_log_out`` gives 2·K·E: per component [μ; log σ²]."""

    def __init__(self, vocab_size: int, word_dim: int = 512,
                 audiofeats_size: int = 512, embed_size: int = 512,
                 hidden_size: int = 512, gmm_kernel: int = 3, device=None):
        super().__init__(vocab_size, word_dim, audiofeats_size, embed_size,
                         hidden_size, device, heads=gmm_kernel)
        self.gmm_kernel = gmm_kernel
        self.mixture_logits = nn.Parameter(torch.zeros(gmm_kernel,
                                                       device=device))

    def step(self, word, enc_mem, enc_proj, enc_mask, state, last_z, eps,
             component_u: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """As :meth:`PriorRNN.step`, with ``mean``/``log`` [K, N, E].
        ``component_u`` [N] uniform(0, 1) picks each row's component (the
        count of the mixture's cdf below it); without it every row takes the
        argmax component, the first at a tie."""
        h, c, attn_w = self._recur(word, enc_mem, enc_proj, enc_mask, state,
                                   last_z)
        K, E = self.gmm_kernel, self.embed_size
        ml = self.mean_log_out(h).reshape(-1, K, 2 * E)
        mean = ml[..., :E].transpose(0, 1)                          # [K, N, E]
        log = torch.clamp(ml[..., E:].transpose(0, 1), -MAX_LOGVAR, MAX_LOGVAR)
        probs = torch.softmax(self.mixture_logits, dim=0)
        if component_u is None:
            comp = torch.argmax(probs).expand(mean.shape[1])
        else:   # u above a rounded cdf's last entry clamps, as JAX's gather
            comp = torch.clamp((component_u[:, None]
                                > torch.cumsum(probs, 0)[None]).sum(-1),
                               max=K - 1)
        rows = torch.arange(mean.shape[1], device=mean.device)
        return {"mean": mean, "log": log,
                "z": reparameterize(mean[comp, rows], log[comp, rows], eps),
                "state": (h, c), "attn_weights": attn_w,
                "mixture_logits": self.mixture_logits}
