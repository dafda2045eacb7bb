"""Caption discriminators for adversarial training (counterpart of
``acvae_tpu/models/discriminator.py``).

:class:`DiscriminatorRNNModel` scores audio↔caption (``aud2cap``) and
caption↔caption (``cap2cap``) pairs as ``max(scale, 1e-6)·cos + bias``
(``scale`` from 10, ``bias`` from -5) between projections of a caption
context (embedding -> BiGRU -> mean+max over the length -> ``proj``) and of
the length-mean of the audio (``aud_proj``); :class:`DiscriminatorModel`
adds the sigmoid.  Captions are ids [N, T] or distributions [N, T, V] (the
straight-through samples of the generator), which mix the embedding rows.
The two trainer wrappers pair positives and negatives from one batch:
:class:`Aud2CapDiscriminatorTrainer` rolls the captions by one row,
:class:`Cap2CapDiscriminatorTrainer` pairs siblings of one audio against the
same slot of the next audio.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from acvae_tpu_torch.models.encoders import _dense
from acvae_tpu_torch.models.rnn import GRU
from acvae_tpu_torch.ops.amp import promoted_linear
from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens


def _embed_soft(embedding: nn.Embedding, caps: torch.Tensor) -> torch.Tensor:
    """ids [N, T] -> the lookup; distributions [N, T, V] -> their mix of the
    embedding rows (differentiable in the distributions)."""
    if caps.ndim == 2:
        return embedding(caps.long())
    return caps @ embedding.weight


class CaptionContext(nn.Module):
    """(soft-)embedding -> BiGRU -> mean+max pooling -> ``proj``."""

    def __init__(self, vocab_size: int, word_dim: int = 512,
                 hidden_size: int = 256, embed_size: int = 512, device=None):
        super().__init__()
        # torch's N(0, 1) init is flax nn.Embed's normal(1.0)
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.rnn = GRU(word_dim, hidden_size, bidirectional=True, device=device)
        self.proj = _dense(2 * hidden_size, embed_size, "kaiming_uniform",
                           device)

    def forward(self, caps: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.rnn(_embed_soft(self.word_embedding, caps), lens)
        return self.proj(mean_with_lens(hidden, lens)
                         + max_with_lens(hidden, lens))


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a / torch.clamp_min(torch.linalg.norm(a, dim=-1, keepdim=True), eps)
    b = b / torch.clamp_min(torch.linalg.norm(b, dim=-1, keepdim=True), eps)
    return torch.sum(a * b, dim=-1)


class DiscriminatorRNNModel(nn.Module):
    """Raw similarity scores; :class:`DiscriminatorModel` adds the
    sigmoid.  ``audio_dim=None`` leaves out ``aud_proj``, as flax never
    creates it for a discriminator trained on cap2cap alone."""

    def __init__(self, vocab_size: int, audio_dim: Optional[int] = 512,
                 word_dim: int = 512, hidden_size: int = 256,
                 embed_size: int = 512, device=None):
        super().__init__()
        self.cap_context = CaptionContext(vocab_size, word_dim, hidden_size,
                                          embed_size, device)
        self.aud_proj = (None if audio_dim is None else
                         _dense(audio_dim, embed_size, "kaiming_uniform", device))
        self.scale = nn.Parameter(torch.tensor(10.0, device=device))
        self.bias = nn.Parameter(torch.tensor(-5.0, device=device))

    def _score(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(self.scale, 1e-6) * _cosine(a, b) + self.bias

    def aud2cap(self, audio_feats: torch.Tensor, feats_lens, caps: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        """``audio_feats`` [N, S, D] (mean-pooled over ``feats_lens``) or
        [N, D]; ``caps`` ids [N, T] or distributions [N, T, V]."""
        audio = (mean_with_lens(audio_feats, feats_lens)
                 if audio_feats.ndim == 3 else audio_feats)
        # a bf16 encoder's embeddings promote to float32, as in flax's Dense
        return self._score(promoted_linear(audio, self.aud_proj),
                           self.cap_context(caps, lens))

    def cap2cap(self, caps_a, lens_a, caps_b, lens_b) -> torch.Tensor:
        return self._score(self.cap_context(caps_a, lens_a),
                           self.cap_context(caps_b, lens_b))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.aud2cap(batch["audio_feats"], batch.get("feats_lens"),
                            batch["caps"], batch["lens"])


class DiscriminatorModel(DiscriminatorRNNModel):
    """The probability ``sigmoid(aud2cap)`` the losses read
    (loss.py:134,152)."""

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(super().forward(batch))


class Aud2CapDiscriminatorTrainer(nn.Module):
    """The encoder's ``audio_embeds`` against the batch's captions
    (positives) and the captions rolled by one row (negatives); returns
    both sigmoid probabilities."""

    def __init__(self, encoder: nn.Module, dscrm: DiscriminatorRNNModel):
        super().__init__()
        self.encoder, self.dscrm = encoder, dscrm

    def forward(self, feats, feat_lens, caps, cap_lens, train: bool = True):
        enc = self.encoder(feats, feat_lens, train=train)
        a, al = enc["audio_embeds"], enc["audio_embeds_lens"]
        pos = self.dscrm.aud2cap(a, al, caps, cap_lens)
        neg = self.dscrm.aud2cap(a, al, torch.roll(caps, 1, 0),
                                 torch.roll(cap_lens, 1, 0))
        return torch.sigmoid(pos), torch.sigmoid(neg)


class Cap2CapDiscriminatorTrainer(nn.Module):
    """Captions grouped ``uttnumbers`` an audio ([A·utt, L], the
    Stage1Dataset layout): each caption against the next sibling of its
    audio (positives) and against the same slot of the next audio
    (negatives)."""

    def __init__(self, dscrm: DiscriminatorRNNModel, uttnumbers: int = 5):
        super().__init__()
        self.dscrm, self.uttnumbers = dscrm, uttnumbers

    def forward(self, caps, cap_lens, train: bool = True):
        n, u = caps.shape[0], self.uttnumbers
        idx = torch.arange(n, device=caps.device)
        sibling = (idx // u) * u + (idx + 1) % u
        other = (idx + u) % n
        pos = self.dscrm.cap2cap(caps, cap_lens, caps[sibling], cap_lens[sibling])
        neg = self.dscrm.cap2cap(caps, cap_lens, caps[other], cap_lens[other])
        return torch.sigmoid(pos), torch.sigmoid(neg)
