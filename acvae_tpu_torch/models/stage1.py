"""The stage-1 caption embedder and the GE2E loss (counterpart of
``acvae_tpu/models/stage1.py``).

:class:`Stage1Encoder`: embedding -> BiGRU -> mean+max over the length ->
``projection`` -> a flax-semantics BatchNorm (momentum 0.9, the biased
batch variance; ``models/encoders.py::BatchNorm``).  Trained with
:class:`GE2ELoss` over [audios × utterances] caption groups
(``runners/stage1_runner.py``; the centroid/cosine math of
``models/utils.py:170-274``); its per-caption embeddings regularize caption
training through ``embedding_path``.  :func:`equal_error_rate` is the
reference's threshold sweep, on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from acvae_tpu_torch.models.encoders import BatchNorm, _dense
from acvae_tpu_torch.models.rnn import GRU
from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens


class Stage1Encoder(nn.Module):
    """Caption ids [N, L] -> caption embeddings [N, E]."""

    def __init__(self, vocab_size: int, word_dim: int = 512,
                 hidden_size: int = 512, embed_size: int = 512, device=None):
        super().__init__()
        # torch's N(0, 1) init is flax nn.Embed's normal(1.0)
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.rnn = GRU(word_dim, hidden_size, bidirectional=True, device=device)
        self.projection = _dense(2 * hidden_size, embed_size,
                                 "kaiming_uniform", device)
        self.bn = BatchNorm(embed_size, momentum=0.9, device=device)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        hidden, _ = self.rnn(self.word_embedding(caps.long()), cap_lens)
        pooled = mean_with_lens(hidden, cap_lens) + max_with_lens(hidden, cap_lens)
        return self.bn(self.projection(pooled), train)


def get_centroids(embeddings: torch.Tensor) -> torch.Tensor:
    """[A, M, E] -> [A, E] (models/utils.py:170-172)."""
    return embeddings.mean(dim=1)


def get_utterance_centroids(embeddings: torch.Tensor) -> torch.Tensor:
    """Leave-one-out centroids [A, M, E] (models/utils.py:183-200)."""
    total = embeddings.sum(dim=1, keepdim=True)
    return (total - embeddings) / (embeddings.shape[1] - 1)


def _cos(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = torch.sum(a * b, -1)
    return num / torch.clamp_min(torch.linalg.norm(a, dim=-1)
                                 * torch.linalg.norm(b, dim=-1), eps)


def get_cossim(embeddings: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[A, M, E] × [A, E] -> [A, M, A] cosines + 1e-6, the own audio's
    entries against its leave-one-out centroid (models/utils.py:214-257)."""
    A = embeddings.shape[0]
    cos_diff = _cos(embeddings[:, :, None, :], centroids[None, None, :, :])
    own = _cos(embeddings, get_utterance_centroids(embeddings))      # [A, M]
    eye = torch.eye(A, dtype=torch.bool, device=embeddings.device)[:, None, :]
    return torch.where(eye, own[:, :, None], cos_diff) + 1e-6


class GE2ELoss(nn.Module):
    """``sim = max(w, 1e-6)·cossim + b`` (``w`` from 10, ``b`` from -5); the
    softmax contrast summed over every caption (models/utils.py:268-274)."""

    def __init__(self, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(10.0, device=device))
        self.b = nn.Parameter(torch.tensor(-5.0, device=device))

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        sim = (torch.clamp_min(self.w, 1e-6)
               * get_cossim(embeddings, get_centroids(embeddings)) + self.b)
        A = sim.shape[0]
        ar = torch.arange(A, device=sim.device)
        pos = sim[ar, :, ar]                                  # [A, M]
        neg = torch.log(torch.exp(sim).sum(dim=2) + 1e-6)     # [A, M]
        return torch.sum(-(pos - neg))


def equal_error_rate(sim_matrix) -> Tuple[float, float]:
    """(EER, threshold) of an [A, Mv, A] verification similarity matrix
    (its [i, :, i] the genuine trials): thresholds 0.00..0.99, a trial
    accepted where ``sim > thr``, FAR over the (A-1)·Mv·A impostor trials,
    FRR over the Mv·A genuine ones; the threshold of the least |FAR - FRR|
    (the first on a tie) and EER = (FAR + FRR)/2 there
    (stage1_runner.py:190-207).  The search starts from |FAR - FRR| = inf
    where the reference starts from 1, so a matrix whose every threshold
    gives 1 reports its EER of 0.5, as the JAX package does."""
    sim = (sim_matrix.detach().cpu().numpy() if torch.is_tensor(sim_matrix)
           else np.asarray(sim_matrix))
    a, mv, _ = sim.shape
    if a < 2:
        raise ValueError("EER needs at least 2 audios (FAR divides by A-1)")
    diag = sim[np.arange(a), :, np.arange(a)]
    best = (float("inf"), 0.5, 0.0)
    for thr in (0.01 * i for i in range(100)):
        acc = sim > thr
        diag_acc = diag > thr
        far = (acc.sum() - diag_acc.sum()) / (a - 1.0) / mv / a
        frr = (mv * a - diag_acc.sum()) / mv / a
        diff = abs(far - frr)
        if diff < best[0]:
            best = (diff, (far + frr) / 2, thr)
    return float(best[1]), float(best[2])
