"""Shared pieces of the caption models (counterpart of
``acvae_tpu/models/common.py:22-37`` and of what every family of
``acvae_tpu/models/{vae,captioner,trans_vae}.py`` repeats: the decode-method
check, the encoder->decoder ``ln`` adapter and the arity dispatch)."""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn as nn

from acvae_tpu_torch import END_IDX, MAX_LENGTH, START_IDX
from acvae_tpu_torch.ops.amp import promoted_linear

DECODE_METHODS = ("greedy", "gumbel", "sample", "beam", "dbs")


def grad_optional(fn):
    """Run ``fn`` without autograd unless it is called with ``grad=True``:
    ``forced_decode`` scores given words for inspection, and the SCST replay
    differentiates the same log-probabilities."""
    @functools.wraps(fn)
    def wrapper(*args, grad: bool = False, **kwargs):
        with torch.set_grad_enabled(grad):
            return fn(*args, **kwargs)
    return wrapper


def check_decode_method(family: str, method: str) -> None:
    """Fail fast, naming the caller, on an unknown decode method."""
    if method not in DECODE_METHODS:
        raise ValueError(
            f"{family} does not support decode_method={method!r}; "
            f"supported: {', '.join(DECODE_METHODS)}")


def eps_stack(steps: int, rows: int, dim: int,
              generator: Optional[torch.Generator] = None, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """[steps, rows, dim] standard normals: one prior-noise slab per step,
    drawn in float32 and then cast, so a bf16 decode sees the same draws
    rounded."""
    return torch.randn((steps, rows, dim), generator=generator,
                       device=device).to(dtype)


def stack_steps(ys: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """Per-step outputs -> [N, T, ...] ([K, T, N, E] for a GMM prior's
    per-step [K, N, E] moments, as the JAX scan lays them out)."""
    return {k: torch.stack(v, dim=1) for k, v in ys.items()}


def forced_logprob(logits: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The float32 log-probability of ``words`` [N] under ``logits``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, words[:, None].long())[:, 0]


class CaptionModel(nn.Module):
    """Encoder, decoder and, when their embed sizes differ, the ``ln``
    adapter (a Linear with xavier-uniform weights and zero bias,
    vae_model.py:30-32) that maps the encoder memory to the decoder's size.

    ``bf16_decode`` says whether the family decodes with bf16 parameters
    (``ops/amp.py``): the families the JAX package's bf16 tests cover."""
    start_idx = START_IDX
    end_idx = END_IDX
    bf16_decode = True

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 max_length: int = MAX_LENGTH, device=None):
        super().__init__()
        self.encoder, self.decoder, self.max_length = encoder, decoder, max_length
        self.ln = None
        if encoder.embed_size != decoder.embed_size:
            self.ln = nn.Linear(encoder.embed_size, decoder.embed_size,
                                device=device)
            nn.init.xavier_uniform_(self.ln.weight)
            nn.init.zeros_(self.ln.bias)

    def encode(self, feats, feat_lens, train: bool = False):
        """The encoder dict, its ``audio_embeds`` in the decoder's size (the
        encoder's own kept as ``audio_embeds_raw`` when ``ln`` maps them)."""
        return self.apply_ln(self.encoder(feats, feat_lens, train=train))

    def apply_ln(self, encoded):
        if self.ln is None:
            return encoded
        return dict(encoded, audio_embeds_raw=encoded["audio_embeds"],
                    audio_embeds=promoted_linear(encoded["audio_embeds"],
                                                 self.ln))

    def forward(self, feats, feat_lens, caps=None, cap_lens=None, **kwargs):
        """The reference's arity dispatch (vae_model.py:57-86): with captions
        the train forward, without them the inference forward."""
        if caps is not None:
            return self.train_forward(feats, feat_lens, caps, cap_lens, **kwargs)
        return self.inference_forward(feats, feat_lens, **kwargs)
