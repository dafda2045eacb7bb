"""Ensemble decoding: probability-averaged greedy and beam search across
models (counterpart of ``acvae_tpu/decoding/ensemble.py:22-120``, the
reference's ``BaseRunner.ensemble``, base_runner.py:397-694).

Every member steps over the shared flat [N(·B)] word axis with its own
state and prior noise; the next-word distribution is the mean of the
members' softmax outputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from acvae_tpu_torch import END_IDX, START_IDX
from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.decoding.beam import (BeamConfig, StepFn, _leaf_device,
                                           batched_beam_search)


def _mean_logprobs(logits_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """log of the members' mean probability (base_runner.py:520-530 averages
    probabilities, not logits)."""
    probs = sum(torch.softmax(l, dim=-1) for l in logits_list)
    return torch.log(probs / len(logits_list) + 1e-12)


def _combined_step(step_fns: List[StepFn]) -> StepFn:
    """One step of every member: (log mean probability, member states)."""
    def step_fn(states, words, t):
        logits_list, new_states = [], []
        for fn, state in zip(step_fns, states):
            logits_m, s_m = fn(state, words, t)
            logits_list.append(logits_m)
            new_states.append(s_m)
        return _mean_logprobs(logits_list), tuple(new_states)
    return step_fn


def ensemble_greedy(step_fns: List[StepFn], init_states: List[Any],
                    batch_size: int, max_length: int,
                    start_idx: int = START_IDX, end_idx: int = END_IDX
                    ) -> Dict[str, torch.Tensor]:
    """Probability-averaged greedy decode; after a clip's first ``<end>``
    every later word is ``<end>``.  Returns ``{"seqs": [N, T]}``."""
    step = _combined_step(step_fns)
    states = tuple(init_states)
    dev = _leaf_device(states)
    words = torch.full((batch_size,), start_idx, dtype=torch.long, device=dev)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    seqs = []
    for t in range(max_length):
        logprobs, states = step(states, words, t)
        words = torch.where(finished, end_idx, torch.argmax(logprobs, dim=-1))
        finished = finished | (words == end_idx)
        seqs.append(words)
    return {"seqs": torch.stack(seqs, dim=1)}


def ensemble_beam(step_fns: List[StepFn], init_states: List[Any],
                  batch_size: int, cfg: BeamConfig) -> Dict[str, torch.Tensor]:
    """Probability-averaged batched beam search over the shared engine: the
    combined step hands the log mean probability in as its logits (the
    engine's log-softmax only subtracts the ~V·1e-12 row constant) and
    carries the member states as one tuple."""
    return batched_beam_search(_combined_step(step_fns), tuple(init_states),
                               batch_size, cfg)


STEP_API = ("encode", "decode_ctx", "init_decode_state", "decode_step_api")


def check_step_api(members: Sequence[Any]) -> None:
    """Every member must have the step-decode API (the JAX service's guard,
    ``acvae_tpu/serve.py:241-246``)."""
    for model in members:
        for api in STEP_API:
            if not hasattr(model, api):
                raise ValueError(
                    f"ensemble decoding needs the step-decode API ({api}); "
                    f"{type(model).__name__} lacks it")


def ensemble_decode(members: List[Any], feats: torch.Tensor,
                    feat_lens: torch.Tensor, decode_method: str = "beam",
                    beam_size: int = 3, max_length: int = 20,
                    eps: Optional[List[torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """Ensemble decode over models that have the step-decode API
    (``encode``, ``decode_ctx``, ``init_decode_state``,
    ``decode_step_api``).  Each member encodes on its own and draws its own
    prior noise: ``eps[m]`` [T, N·B, E], drawn from ``generator`` where not
    given."""
    check_step_api(members)
    N, dev = feats.shape[0], feats.device
    B = beam_size if decode_method == "beam" else 1
    NB = N * B
    step_fns: List[StepFn] = []
    init_states = []
    with torch.inference_mode():
        for m, model in enumerate(members):
            ctx = model.decode_ctx(model.encode(feats, feat_lens, train=False))
            e = (eps[m] if eps is not None else pstate.randn(
                (max_length, NB, model.decoder.embed_size), generator, dev,
                row_axis=1)).to(dev)

            def fn(state, words, t, model=model, ctx=ctx, e=e):
                return model.decode_step_api(ctx, state, words, e[t])
            step_fns.append(fn)
            init_states.append(model.init_decode_state(NB, dev))
        if decode_method == "beam":
            # the reference's ensemble beam (base_runner.py:681-684): row 0
            # only at t=0, no end handling
            cfg = BeamConfig(beam_size=B, max_length=max_length,
                             first_step_row0=True, end_handling=False)
            return ensemble_beam(step_fns, init_states, N, cfg)
        return ensemble_greedy(step_fns, init_states, N, max_length)

