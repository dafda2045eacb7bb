"""Text decoders (counterpart of ``acvae_tpu/models/decoders.py:34-359``).

* :class:`RNNDecoder` — a GRU over [word; pooled audio] (decoder.py:28-98).
* :class:`RNNBahdanauAttnDecoder` / :class:`VAERNNBahdanauAttnDecoder` —
  Bahdanau attention from the decoder state to the encoder memory, then a
  GRU over [emb; ctx] (decoder.py:129-162), or over [emb; ctx; z] for the
  AC-VAE (decoder.py:164-203).
* :class:`RNNLuongAttnDecoder` — the GRU first, then attention with its new
  state and logits from tanh(W [h; ctx]) (decoder.py:101-126).
* :class:`TransformerDecoder` / :class:`VAETransformerDecoder` — post-norm
  causal transformer decoders over the whole prefix (decoder.py:225-332);
  the VAE one appends the per-position latents to the cross-attention
  memory and uses GELU.

torch names are the reference's: ``word_embeddings``, ``attn``, ``model``
(the GRU, or the transformer's ``model.layers.<i>`` with ``self_attn``,
``multihead_attn``, ``linear1``/``linear2`` and ``norm1``-``norm3``),
``classifier`` / ``outputlayer``.

Three choices hold the transformer to flax's numbers: LayerNorm's epsilon is
flax's 1e-6 (torch's default is 1e-5); GELU is the tanh approximation,
flax's ``nn.gelu``; and a masked attention logit is filled with the dtype's
finite minimum, as flax fills it, so a row with no valid key gives uniform
weights where a fill of -inf would give NaN.  No call site here builds such
a row in the self-attention (key 0, the start word, is always valid and
always causal); a cross-attention row has none only for a clip whose
encoder length is 0.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.models.attention import AdditiveAttention
from acvae_tpu_torch.models.rnn import GRUCell
from acvae_tpu_torch.ops.masked import length_mask


class RNNDecoder(nn.Module):
    """GRU over [word_emb; enc_mem]; ``enc_mem`` is the pooled utterance
    embedding fed at every step (word_model.py:81,147)."""

    def __init__(self, vocab_size: int, enc_mem_size: int,
                 embed_size: int = 256, hidden_size: int = 256,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.embed_size, self.hidden_size = embed_size, hidden_size
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, embed_size,
                                            device=device)
        self.model = GRUCell(embed_size + enc_mem_size, hidden_size,
                             device=device)
        self.classifier = nn.Linear(hidden_size, vocab_size, device=device)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)

    def state_dtype(self) -> torch.dtype:
        return self.model.weight_hh.dtype

    def step(self, word: torch.Tensor, state: torch.Tensor,
             enc_mem: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        """word [N] int; state [N, H]; enc_mem [N, enc_mem_size]."""
        emb = F.dropout(self.word_embeddings(word), self.dropout, train)
        h = self.model(torch.cat([emb, enc_mem], dim=-1), state)
        return {"state": h, "output": h, "logits": self.classifier(h)}

    def forward(self, words: torch.Tensor, enc_mem: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, Any]:
        """Teacher forcing over words [N, T]; enc_mem [N, T, enc] or [N, enc]
        (broadcast over T)."""
        N, T = words.shape
        if enc_mem.ndim == 2:
            enc_mem = enc_mem[:, None].expand(N, T, enc_mem.shape[-1])
        emb = F.dropout(self.word_embeddings(words), self.dropout, train)
        x = torch.cat([emb, enc_mem], dim=-1)
        h = self.init_state(N, words.device, emb.dtype) if state is None else state
        outs = []
        for t in range(T):
            h = self.model(x[:, t], h)
            outs.append(h)
        outs = torch.stack(outs, dim=1)
        return {"output": outs, "logits": self.classifier(outs)}


class _AttnRNNBase(nn.Module):
    """The Bahdanau-attention GRU decoders: GRU over [emb; ctx] (+ z)."""
    use_z = False

    def __init__(self, vocab_size: int, enc_mem_size: int,
                 embed_size: int = 256, hidden_size: int = 256,
                 dropout: float = 0.0, attn_size: Optional[int] = None,
                 device=None):
        super().__init__()
        self.embed_size, self.hidden_size = embed_size, hidden_size
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, embed_size,
                                            device=device)
        self.attn = AdditiveAttention(hidden_size, enc_mem_size,
                                      attn_size or hidden_size, device=device)
        self.model = GRUCell(embed_size + enc_mem_size * (2 if self.use_z else 1),
                             hidden_size, device=device)
        self.classifier = nn.Linear(hidden_size, vocab_size, device=device)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)

    def state_dtype(self) -> torch.dtype:
        """The decode state's dtype: the parameters' (``ops/amp.py``)."""
        return self.model.weight_hh.dtype

    def project_enc(self, enc_mem: torch.Tensor) -> torch.Tensor:
        return self.attn.project_enc(enc_mem)

    def _step(self, word, state, enc_mem, enc_proj, enc_mask, z, train):
        ctx, attn_w = self.attn(state, enc_mem, enc_proj, enc_mask)
        emb = F.dropout(self.word_embeddings(word), self.dropout, train)
        h = self.model(torch.cat([emb, ctx] + ([z] if z is not None else []),
                                 dim=-1), state)
        return {"state": h, "output": h, "logits": self.classifier(h),
                "attn_weights": attn_w}


class RNNBahdanauAttnDecoder(_AttnRNNBase):
    def step(self, word: torch.Tensor, state: torch.Tensor,
             enc_mem: torch.Tensor, enc_proj: torch.Tensor,
             enc_mask: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        return self._step(word, state, enc_mem, enc_proj, enc_mask, None, train)


class VAERNNBahdanauAttnDecoder(_AttnRNNBase):
    use_z = True

    def step(self, word: torch.Tensor, state: torch.Tensor,
             enc_mem: torch.Tensor, enc_proj: torch.Tensor,
             enc_mask: torch.Tensor, z: torch.Tensor,
             train: bool = False) -> Dict[str, Any]:
        return self._step(word, state, enc_mem, enc_proj, enc_mask, z, train)


class RNNLuongAttnDecoder(nn.Module):
    def __init__(self, vocab_size: int, enc_mem_size: int,
                 embed_size: int = 256, hidden_size: int = 256,
                 attn_hidden_size: int = 256, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.embed_size, self.hidden_size = embed_size, hidden_size
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, embed_size,
                                            device=device)
        self.model = GRUCell(embed_size, hidden_size, device=device)
        self.attn = AdditiveAttention(hidden_size, enc_mem_size,
                                      attn_hidden_size, device=device)
        self.hc2attn_h = nn.Linear(hidden_size + enc_mem_size,
                                   attn_hidden_size, device=device)
        self.classifier = nn.Linear(attn_hidden_size, vocab_size, device=device)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)

    def state_dtype(self) -> torch.dtype:
        return self.model.weight_hh.dtype

    def project_enc(self, enc_mem: torch.Tensor) -> torch.Tensor:
        return self.attn.project_enc(enc_mem)

    def step(self, word, state, enc_mem, enc_proj, enc_mask,
             train: bool = False) -> Dict[str, Any]:
        emb = F.dropout(self.word_embeddings(word), self.dropout, train)
        h = self.model(emb, state)
        ctx, attn_w = self.attn(h, enc_mem, enc_proj, enc_mask)
        attn_h = torch.tanh(self.hc2attn_h(torch.cat([h, ctx], dim=-1)))
        return {"state": h, "output": attn_h,
                "logits": self.classifier(attn_h), "attn_weights": attn_w}


# ---------------------------------------------------------------------- #
# transformer
# ---------------------------------------------------------------------- #
def sinusoidal_pe(max_len: int, d_model: int) -> torch.Tensor:
    """Sin/cos positional encoding [max_len, d_model] (decoder.py:205-222)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model))
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class MultiheadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` under torch
    ``nn.MultiheadAttention``'s names: ``in_proj_weight`` [3E, E] (rows q;
    k; v, each head-major) and ``out_proj``.  The query is scaled by
    1/sqrt(head_dim) before the product; masked logits take the dtype's
    finite minimum; the weights drop out at ``dropout`` in train."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim,
                                                     device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        """query [N, T, E], memory [N, S, E], mask [N, T or 1, S] bool
        (True = attend) -> [N, T, E]."""
        N, T, E = query.shape
        S, H = memory.shape[1], self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:E], b[:E]).view(N, T, H, E // H).transpose(1, 2)
        k = F.linear(memory, w[E:2 * E], b[E:2 * E]).view(N, S, H, E // H)
        v = F.linear(memory, w[2 * E:], b[2 * E:]).view(N, S, H, E // H)
        q = q / math.sqrt(E // H)
        logits = q @ k.permute(0, 2, 3, 1)                       # [N, H, T, S]
        logits = logits.masked_fill(~mask[:, None],
                                    torch.finfo(logits.dtype).min)
        weights = F.dropout(torch.softmax(logits, dim=-1), self.dropout, train)
        out = (weights @ v.transpose(1, 2)).transpose(1, 2).reshape(N, T, E)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer (torch ``nn.TransformerDecoderLayer``'s
    order): self-attention, add & norm, cross-attention, add & norm, FFN,
    add & norm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float, activation: str = "relu", device=None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise KeyError(activation)
        self.dropout, self.activation = dropout, activation
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, device)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout, device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1, self.norm2, self.norm3 = (
            nn.LayerNorm(d_model, eps=1e-6, device=device) for _ in range(3))

    def forward(self, tgt, memory, tgt_mask, mem_mask, train: bool):
        """tgt [N, T, D]; memory [N, S, D]; tgt_mask [N, T, T] and mem_mask
        [N, S] bool (True = attend)."""
        drop = lambda x: F.dropout(x, self.dropout, train)  # noqa: E731
        x = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt_mask, train)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, mem_mask[:, None],
                                                    train)))
        ff = self.linear1(x)
        ff = F.relu(ff) if self.activation == "relu" else F.gelu(
            ff, approximate="tanh")
        return self.norm3(x + drop(self.linear2(drop(ff))))


class _Layers(nn.Module):
    """Holds ``layers`` so the names read ``model.layers.<i>``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _TransformerBase(nn.Module):
    activation = "relu"

    def __init__(self, vocab_size: int, enc_mem_size: int,
                 embed_size: int = 256, nhead: int = 4, nlayers: int = 2,
                 hidden_size: int = 2048, dropout: float = 0.5,
                 activation: Optional[str] = None, max_len: int = 100,
                 device=None):
        super().__init__()
        self.embed_size, self.dropout = embed_size, dropout
        self.word_embeddings = nn.Embedding(vocab_size, embed_size,
                                            device=device)
        self.model = _Layers([
            TransformerDecoderLayer(embed_size, nhead, hidden_size, dropout,
                                    activation or self.activation, device)
            for _ in range(nlayers)])
        self.outputlayer = nn.Linear(embed_size, vocab_size, device=device)
        self.register_buffer("pe", sinusoidal_pe(max_len, embed_size).to(device),
                             persistent=False)

    def state_dtype(self) -> torch.dtype:
        """The decode's dtype: the parameters' (``ops/amp.py``)."""
        return self.word_embeddings.weight.dtype

    def _run(self, words, memory, mem_mask, tgt_valid, train):
        T = words.shape[1]
        emb = (F.dropout(self.word_embeddings(words), self.dropout, train)
               * math.sqrt(self.embed_size))
        x = F.dropout(emb + self.pe[:T].to(emb.dtype)[None], self.dropout, train)
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=words.device).tril()
        tgt_mask = causal[None] & tgt_valid[:, None, :]          # [N, T, T]
        for layer in self.model.layers:
            x = layer(x, memory, tgt_mask, mem_mask, train)
        return x

    def _out(self, x, at):
        """output and logits at every position, or at position ``at``."""
        if at is not None:
            x = x[:, at]
        return {"output": x, "logits": self.outputlayer(x)}


class TransformerDecoder(_TransformerBase):
    def forward(self, words: torch.Tensor, enc_mem: torch.Tensor,
                enc_mem_lens: torch.Tensor, caps_padding_mask: torch.Tensor,
                train: bool = False, at: Optional[int] = None
                ) -> Dict[str, Any]:
        """words [N, T]; enc_mem [N, S, E]; caps_padding_mask [N, T] (True =
        padded, torch's convention).  Returns output/logits for all T, or
        for position ``at`` alone."""
        mem_mask = length_mask(enc_mem_lens, enc_mem.shape[1])
        return self._out(self._run(words, enc_mem, mem_mask, ~caps_padding_mask,
                                   train), at)


class VAETransformerDecoder(_TransformerBase):
    activation = "gelu"

    def forward(self, words: torch.Tensor, enc_mem: torch.Tensor,
                enc_mem_lens: torch.Tensor, caps_padding_mask: torch.Tensor,
                z: torch.Tensor, train: bool = False,
                at: Optional[int] = -1) -> Dict[str, Any]:
        """z [N, T, E] per-position latents, appended to the memory.  Returns
        position ``at`` (the last by default; None for all)."""
        mem = torch.cat([enc_mem, z], dim=1)
        mem_mask = torch.cat([length_mask(enc_mem_lens, enc_mem.shape[1]),
                              ~caps_padding_mask], dim=1)
        return self._out(self._run(words, mem, mem_mask, ~caps_padding_mask,
                                   train), at)


DECODERS = {c.__name__: c for c in (
    RNNDecoder, RNNBahdanauAttnDecoder, VAERNNBahdanauAttnDecoder,
    RNNLuongAttnDecoder, TransformerDecoder, VAETransformerDecoder)}
