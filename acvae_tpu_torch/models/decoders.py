"""The AC-VAE RNN decoder (counterpart of
``acvae_tpu/models/decoders.py:91-162, 215-227``): Bahdanau attention from
the decoder state to the encoder memory, then a GRU over [emb; ctx; z]
(decoder.py:164-203).  torch names: ``word_embeddings``, ``attn``, ``model``
(the GRU), ``classifier``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.models.attention import AdditiveAttention
from acvae_tpu_torch.models.rnn import GRUCell


class VAERNNBahdanauAttnDecoder(nn.Module):
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
        self.model = GRUCell(embed_size + 2 * enc_mem_size, hidden_size,
                             device=device)
        self.classifier = nn.Linear(hidden_size, vocab_size, device=device)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)

    def state_dtype(self) -> torch.dtype:
        """The decode state's dtype: the parameters' (``ops/amp.py``)."""
        return self.model.weight_hh.dtype

    def project_enc(self, enc_mem: torch.Tensor) -> torch.Tensor:
        return self.attn.project_enc(enc_mem)

    def step(self, word: torch.Tensor, state: torch.Tensor,
             enc_mem: torch.Tensor, enc_proj: torch.Tensor,
             enc_mask: torch.Tensor, z: torch.Tensor,
             train: bool = False) -> Dict[str, Any]:
        ctx, attn_w = self.attn(state, enc_mem, enc_proj, enc_mask)
        emb = F.dropout(self.word_embeddings(word), self.dropout, train)
        h = self.model(torch.cat([emb, ctx, z], dim=-1), state)
        return {"state": h, "output": h, "logits": self.classifier(h),
                "attn_weights": attn_w}
