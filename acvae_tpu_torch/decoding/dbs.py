"""Batched diverse beam search (counterpart of
``acvae_tpu/decoding/dbs.py:34-186``).

The reference's per-clip DBS (``models/word_model.py:297-394``) for all clips
at once:

* ``bdash = beam_size // group_size`` beams a group; group g starts at
  global step g, so its local position is ``t - g``.
* Hamming diversity penalty (``add_diversity``, word_model.py:298-312):
  group g's logprobs at local position p lose ``diversity_lambda`` times the
  count of each token the earlier groups hold at their position p, summed
  over their beams (a ``scatter_add_`` of exact integer counts).
* A double log-softmax with temperature, in float32 (word_model.py:351-352).
* Local step 0 expands row 0 only (``topk_lax_order``); later steps take
  ``beam_topk``, both in ``lax.top_k``'s tie order.
* A beam emitting ``<end>`` is recorded as done with its score over its
  local length, then killed with -1000; at the last local step every beam
  is recorded (word_model.py:375-382).
* Output: each group's done beams by score, all ``bdash`` of them with
  ``group_nbest``, else the best one (word_model.py:385-392).

The JAX package steps every group at every global step and freezes the
inactive ones; here an inactive group is not stepped at all, which gives the
same result with G·(G-1) fewer step calls.  Nothing is read back to the
host: the done store has one spare slot that takes the writes of beams that
did not end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from acvae_tpu_torch import END_IDX, START_IDX
from acvae_tpu_torch.decoding.beam import (_gather_beams, _leaf_device,
                                           beam_topk, topk_lax_order)


def dbs_bdash(beam_size: int, group_size: int) -> int:
    """Beams a group, checked before any state is sized (the reference
    floors sizes that do not divide, word_model.py:314)."""
    if group_size < 1:
        raise ValueError(f"dbs needs group_size >= 1, got {group_size}")
    bdash = beam_size // group_size
    if bdash < 1:
        raise ValueError(
            f"dbs needs beam_size >= group_size (got beam_size={beam_size}, "
            f"group_size={group_size} -> {bdash} beams per group); pass "
            "e.g. --beam_size=8 --group_size=4")
    return bdash


@dataclasses.dataclass(frozen=True)
class DBSConfig:
    beam_size: int
    group_size: int
    max_length: int
    diversity_lambda: float = 0.5
    temperature: float = 1.0
    group_nbest: bool = True
    start_idx: int = START_IDX
    end_idx: int = END_IDX


def diverse_beam_search(make_step_fn: Callable[[int], Any],
                        make_init_state: Callable[[], Any],
                        batch_size: int, cfg: DBSConfig
                        ) -> Dict[str, torch.Tensor]:
    """``make_step_fn(g)`` -> ``step_fn(state, words [N·bdash], t)`` ->
    ``(logits [N·bdash, V], state)``, with ``t`` the global step; each group
    has its own, so its noise can differ.  Returns ``{"seqs": [N, out, T]
    int64, "scores": [N, out] f32}``, out = ``group_size·bdash`` with
    ``group_nbest``, else ``group_size``; groups in order, each group's
    beams best first."""
    N, G, T = batch_size, cfg.group_size, cfg.max_length
    bdash = dbs_bdash(cfg.beam_size, G)
    CAP = bdash * T          # the most done beams a group can record
    step_fns = [make_step_fn(g) for g in range(G)]
    states = [make_init_state() for _ in range(G)]
    dev = _leaf_device(states[0])
    words = [torch.full((N * bdash,), cfg.start_idx, dtype=torch.long,
                        device=dev) for _ in range(G)]
    scores = [torch.zeros((N, bdash), device=dev) for _ in range(G)]
    seqs = [torch.full((N, bdash, T), cfg.end_idx, dtype=torch.long,
                       device=dev) for _ in range(G)]
    # slot CAP takes the writes of beams that did not end
    done_scores = [torch.full((N, CAP + 1), float("-inf"), device=dev)
                   for _ in range(G)]
    done_seqs = [torch.full((N, CAP + 1, T), cfg.end_idx, dtype=torch.long,
                            device=dev) for _ in range(G)]
    done_count = [torch.zeros((N, 1), dtype=torch.long, device=dev)
                  for _ in range(G)]
    ones = torch.ones((N, bdash), device=dev)
    for t in range(T + G - 1):
        for g in range(max(0, t - T + 1), min(G, t + 1)):
            lt = t - g
            logits, new_state = step_fns[g](states[g], words[g], t)
            V = logits.shape[-1]
            lp = F.log_softmax(logits.float(), dim=-1)
            lp = F.log_softmax(lp / cfg.temperature, dim=-1).view(N, bdash, V)
            if g > 0:
                change = torch.zeros((N, V), device=dev)
                for prev in range(g):
                    change.scatter_add_(1, seqs[prev][:, :, lt], ones)
                lp = lp - cfg.diversity_lambda * change[:, None, :]
            total = scores[g][:, :, None] + lp
            with record_function("beam_topk"):
                if lt == 0:
                    top_scores, next_words = topk_lax_order(total[:, 0], bdash)
                    prev_inds = torch.zeros((N, bdash), dtype=torch.long,
                                            device=dev)
                else:
                    top_scores, flat_idx = beam_topk(total, bdash)
                    prev_inds, next_words = flat_idx // V, flat_idx % V
            states[g] = _gather_beams(new_state, prev_inds, N, bdash)
            new_seqs = torch.gather(seqs[g], 1,
                                    prev_inds[:, :, None].expand(N, bdash, T))
            new_seqs[:, :, lt] = next_words
            words[g] = next_words.reshape(N * bdash)
            if lt == T - 1:    # the last local step records every beam
                is_end = torch.ones((N, bdash), dtype=torch.bool, device=dev)
            else:
                is_end = next_words == cfg.end_idx
            ends = is_end.long()
            slot = torch.where(is_end, done_count[g] + ends.cumsum(1) - ends,
                               CAP)
            done_scores[g].scatter_(1, slot, top_scores / (lt + 1))
            done_seqs[g].scatter_(1, slot[:, :, None].expand(N, bdash, T),
                                  new_seqs)
            done_count[g] = done_count[g] + ends.sum(1, keepdim=True)
            scores[g] = torch.where(is_end, top_scores - 1000.0, top_scores)
            seqs[g] = new_seqs
    ds = torch.stack([d[:, :CAP] for d in done_scores], dim=1)      # [N,G,CAP]
    dq = torch.stack([d[:, :CAP] for d in done_seqs], dim=1)        # [N,G,CAP,T]
    top = bdash if cfg.group_nbest else 1
    sel = torch.argsort(-ds, dim=-1, stable=True)[..., :top]
    out_seqs = torch.gather(dq, 2, sel[..., None].expand(N, G, top, T))
    return {"seqs": out_seqs.reshape(N, G * top, T),
            "scores": torch.gather(ds, 2, sel).reshape(N, G * top)}
