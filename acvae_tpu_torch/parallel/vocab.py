"""Vocab tensor parallelism: the decoder's word embeddings and classifier
split over the ``model`` axis (JAX's ``shard_by_vocab`` placement, whose
collectives the SPMD partitioner inserts; here they are written out).

* :class:`VocabParallelEmbedding` — rows ``[lo, lo + V/M)`` of the table;
  a lookup outside them reads zeros, and the group's sum is the lookup.
* :class:`VocabParallelLinear` — the classifier's rows: a column-parallel
  product, whose shard of the logits a train step keeps (the loss reads it
  with :func:`vp_logprob_parts`) and which is gathered otherwise.
* :func:`vp_logprob_parts` — log-softmax over the shards with an
  all-reduced max and sum: the target's log-probability from its owner
  shard and the sum of log-probabilities over every shard.
* :func:`vocab_argmax` — the global argmax, ties to the lowest index as
  ``argmax`` breaks them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.collectives import (_all_gather, all_reduce_max_nograd,
                                                  copy_to_split, gather_replicated,
                                                  reduce_to_replicated)


class VocabParallelEmbedding(nn.Module):
    def __init__(self, weight: torch.Tensor, lo: int, vocab_size: int, grid):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.lo, self.vocab_size, self.grid = lo, vocab_size, grid

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        local = idx.long() - self.lo
        inside = (local >= 0) & (local < self.weight.shape[0])
        emb = F.embedding(torch.where(inside, local, 0), self.weight)
        emb = emb * inside[..., None].to(emb.dtype)
        return reduce_to_replicated(emb, self.grid.model_group)


class VocabParallelLinear(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, lo: int,
                 vocab_size: int, grid):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.lo, self.vocab_size, self.grid = lo, vocab_size, grid

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = F.linear(copy_to_split(h, self.grid.model_group), self.weight,
                     self.bias)
        st = pstate.active()
        if st is not None and st.vocab_logits:
            return y
        return gather_replicated(y, y.ndim - 1, self.grid.model_group)


def _lse(x: torch.Tensor, group) -> torch.Tensor:
    """logsumexp over the vocab shards of x [..., V/M] (float32)."""
    m = all_reduce_max_nograd(x.amax(dim=-1), group)
    s = reduce_to_replicated(torch.exp(x - m[..., None]).sum(-1), group)
    return m + torch.log(s)


def _vocab_lo(x: torch.Tensor, grid) -> int:
    return grid.m * x.shape[-1]


def vp_logprob_parts(logits: torch.Tensor, targets: torch.Tensor, grid
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(log p(target), Σ_v log p(v), V) from this rank's shard of the
    logits [..., V/M], V the whole vocabulary."""
    x = logits.float()
    group = grid.model_group
    lse = _lse(x, group)
    V = x.shape[-1] * grid.model
    sum_logp = reduce_to_replicated(x.sum(-1), group) - V * lse
    local = targets.long() - _vocab_lo(x, grid)
    inside = (local >= 0) & (local < x.shape[-1])
    picked = torch.gather(x, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    tgt = reduce_to_replicated(picked * inside.to(x.dtype), group) - lse
    return tgt, sum_logp, V


def vocab_argmax(logits: torch.Tensor, grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global argmax of the log-softmax [...], its log-probability),
    ties to the lowest index."""
    x = logits.float()
    with torch.no_grad():
        lp = x - _lse(x, grid.model_group)[..., None]
        val, idx = lp.max(dim=-1)
        vals = torch.stack(_all_gather(val, grid.model_group))        # [M, ...]
        idxs = torch.stack(_all_gather(idx + _vocab_lo(x, grid),
                                       grid.model_group))
        best = torch.argmax(vals, dim=0)       # the first shard on a tie
        word = torch.gather(idxs, 0, best[None])[0]
        logp = torch.gather(vals, 0, best[None])[0]
    return word, logp


def full_logits(logits: torch.Tensor) -> torch.Tensor:
    """The whole vocabulary's logits: the shard gathered inside a
    vocab-split step, else ``logits``."""
    st = pstate.active()
    if st is None or not st.vocab_logits:
        return logits
    return gather_replicated(logits, logits.ndim - 1, st.grid.model_group)


def split_decoder(decoder: nn.Module, grid, vocab_size: int) -> None:
    """Swap ``decoder``'s ``word_embeddings`` and its classifier
    (``classifier``, the transformers' ``outputlayer``) for their
    vocab-parallel shards (rows of this rank's model index), in place."""
    size = vocab_size // grid.model
    rows = slice(grid.m * size, (grid.m + 1) * size)
    emb = decoder.word_embeddings
    decoder.word_embeddings = VocabParallelEmbedding(
        emb.weight.detach()[rows].clone(), rows.start, vocab_size, grid)
    name = "classifier" if hasattr(decoder, "classifier") else "outputlayer"
    cls = getattr(decoder, name)
    setattr(decoder, name, VocabParallelLinear(
        cls.weight.detach()[rows].clone(), cls.bias.detach()[rows].clone(),
        rows.start, vocab_size, grid))
