"""bf16 decode: a model whose float parameters are cast for the decode
(counterpart of ``acvae_tpu/ops/amp.py:33-61``).

``cast_floats_for_decode`` returns a copy of the model whose float
parameters are in ``dtype``; the buffers (BatchNorm's running statistics)
stay float32, as the JAX package keeps ``batch_stats``.  The decode state
then follows the parameter dtype (``state_dtype`` of the decoder), and the
modules compute in the promoted dtype of their inputs and parameters, as
flax's layers do.  Score math stays float32: the beam and DBS engines and
``sample_next_word`` log-softmax the logits in float32.

A bf16 decode is not token-identical to the float32 one (near-ties in the
top-k flip); the float32 default is unchanged by this module.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Optional

import torch
import torch.nn as nn


def cast_floats_for_decode(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` with every float parameter cast to ``dtype`` and
    every buffer left as it is.  A family whose ``bf16_decode`` is false
    (the JAX package's bf16 tests leave it out: the GMM prior, SimpleVAE)
    raises."""
    if not model.bf16_decode:
        raise ValueError(f"decode_dtype={dtype} is not supported for this "
                         f"{type(model).__name__} (the bf16 decode covers the "
                         f"Normal-prior VAEs, TransVAEModel, Seq2SeqAttnModel "
                         f"and TransformerModel; not a GMM prior or "
                         f"SimpleVAEModel)")
    out = copy.deepcopy(model)
    for p in out.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return out


def resolve_decode_dtype(conf_value: Any = None) -> Optional[torch.dtype]:
    """The decode dtype named by ``conf_value``, else by the
    ``ACVAE_DECODE_DTYPE`` environment variable; None (keep float32, the
    exact default) for neither or ``float32``."""
    v = conf_value if conf_value not in (None, "") else \
        os.environ.get("ACVAE_DECODE_DTYPE", "")
    if not v or str(v) == "float32":
        return None
    dt = getattr(torch, str(v), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"decode dtype must be a float dtype name, got {v!r}")
    return dt


def promoted_linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin(x)`` in the promoted dtype of ``x`` and the layer's weight, as a
    flax ``Dense`` without a dtype computes (float32 whenever either is)."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    return nn.functional.linear(
        x.to(dt), lin.weight.to(dt),
        None if lin.bias is None else lin.bias.to(dt))
