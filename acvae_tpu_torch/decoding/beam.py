"""Batched beam search (counterpart of ``acvae_tpu/decoding/beam.py:37-171``).

All instances and beams live in one flat ``[N*B]`` axis; reordering the
beams is a gather.  The search is a Python loop over ``T`` steps that never
reads a value back to the host, so the card runs it without a sync.

Reference semantics, as in the JAX package:

* ``first_step_row0=True`` (plain captioners, word_model.py:227-228): at
  t=0 only row 0's logprobs are expanded (all beams are identical).
  ``False`` (VAE models, vae_model.py:237): flat top-k from step 0.
* ``end_handling=True`` (word_model.py:240-251): a beam emitting ``<end>``
  is recorded as done and its score drops by 1000; once ``beam_size``
  beams have finished, that instance's search freezes.  ``False`` (the
  VAE flavour): no end handling, all steps run.

Top-k order is ``lax.top_k``'s: descending score, equal scores in
ascending flat index.  ``torch.topk`` does not promise that order, so
:func:`topk_lax_order` takes the operator of ``ops/cuda/topk_kernel.py``:
on the card its selection kernel, which gives the bits of a stable
descending sort cut to ``k``; on the CPU that sort.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from acvae_tpu_torch import END_IDX, START_IDX
from acvae_tpu_torch.ops.cuda import topk_kernel

# step_fn(state, words [NB], t) -> (logits [NB, V], new_state)
StepFn = Callable[[Any, torch.Tensor, int], Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int
    max_length: int
    start_idx: int = START_IDX
    end_idx: int = END_IDX
    first_step_row0: bool = False
    end_handling: bool = False


def topk_lax_order(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of ``x`` [N, M] in ``lax.top_k``'s order
    (ties to the lower index): the bits of a stable descending sort, cut to
    ``k``."""
    return topk_kernel.topk_rows(x.contiguous(), k)


def beam_topk(total: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the flattened (beam, vocab) axis of ``total`` [N, B, V]:
    ``(scores [N, k], flat_idx [N, k])``, identical (tie order included) to
    ``lax.top_k(total.reshape(N, B*V), k)``."""
    N, B, V = total.shape
    return topk_lax_order(total.reshape(N, B * V), k)


def _tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of nested tuples/lists."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaf_device(state) -> torch.device:
    """The device of the first tensor leaf of a nested tuple/list."""
    while isinstance(state, (tuple, list)):
        state = state[0]
    return state.device


def _gather_beams(state, prev_inds: torch.Tensor, N: int, B: int):
    """Reorder [N*B, ...] leaves along the beam axis by ``prev_inds`` [N, B]."""
    rows = (prev_inds + torch.arange(N, device=prev_inds.device)[:, None] * B
            ).reshape(N * B)
    return _tree_map(lambda leaf: leaf.index_select(0, rows), state)


def _freeze(old, new, stopped: torch.Tensor, B: int):
    """Keep ``old`` wherever ``stopped`` [N] is True (leaves have leading N*B)."""
    s = stopped.repeat_interleave(B)
    return _tree_map(
        lambda o, n: torch.where(s.view((-1,) + (1,) * (n.ndim - 1)), o, n),
        old, new)


def batched_beam_search(step_fn: StepFn, init_state: Any, batch_size: int,
                        cfg: BeamConfig) -> Dict[str, torch.Tensor]:
    """Run beam search for all instances at once.

    ``init_state``: nested tuple of tensors with leading dim N*B (already
    replicated per beam), e.g. ``(dec_h, (h, c), last_z)``.  Returns
    ``{"seqs": [N, B, T] int64, "scores": [N, B] f32}``, beams in score
    order (beam 0 = best live beam).  Score math is float32."""
    N, B, T = batch_size, cfg.beam_size, cfg.max_length
    dev = _leaf_device(init_state)
    state = init_state
    words = torch.full((N * B,), cfg.start_idx, dtype=torch.long, device=dev)
    scores = torch.zeros((N, B), device=dev)
    seqs = torch.full((N, B, T), cfg.end_idx, dtype=torch.long, device=dev)
    done = torch.zeros((N,), dtype=torch.long, device=dev)
    stopped = torch.zeros((N,), dtype=torch.bool, device=dev)
    for t in range(T):
        logits, new_state = step_fn(state, words, t)
        V = logits.shape[-1]
        logprobs = F.log_softmax(logits.float(), dim=-1).view(N, B, V)
        total = scores[:, :, None] + logprobs
        with record_function("beam_topk"):
            if t == 0 and cfg.first_step_row0:
                top_scores, next_words = topk_lax_order(total[:, 0], B)
                prev_inds = torch.zeros((N, B), dtype=torch.long, device=dev)
            else:
                top_scores, flat_idx = beam_topk(total, B)
                prev_inds = flat_idx // V
                next_words = flat_idx % V
        new_state = _gather_beams(new_state, prev_inds, N, B)
        new_seqs = torch.gather(seqs, 1, prev_inds[:, :, None].expand(N, B, T))
        new_seqs[:, :, t] = next_words
        new_words = next_words.reshape(N * B)
        if not cfg.end_handling:
            # nothing ever stops: the freeze below would keep every new value
            state, seqs, scores, words = new_state, new_seqs, top_scores, new_words
            continue
        is_end = next_words == cfg.end_idx
        new_done = done + is_end.sum(dim=1)
        new_scores = torch.where(is_end, top_scores - 1000.0, top_scores)
        state = _freeze(state, new_state, stopped, B)
        seqs = torch.where(stopped[:, None, None], seqs, new_seqs)
        scores = torch.where(stopped[:, None], scores, new_scores)
        words = torch.where(stopped.repeat_interleave(B), words, new_words)
        done = torch.where(stopped, done, new_done)
        stopped = stopped | (done >= B)
    return {"seqs": seqs, "scores": scores}
