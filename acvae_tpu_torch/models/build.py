"""Config -> model (counterpart of ``acvae_tpu/models/build.py:55-104``).

Only the flagship family is ported: ``Hybrid_VAEModel`` with a Cnn10
encoder, ``PosteriorRNN_hybrid``, ``PriorRNN`` and
``VAERNNBahdanauAttnDecoder``.  Any other name raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.decoders import VAERNNBahdanauAttnDecoder
from acvae_tpu_torch.models.encoders import Cnn10
from acvae_tpu_torch.models.latent import PosteriorRNNHybrid, PriorRNN
from acvae_tpu_torch.models.vae import VAECaptionModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _require(what: str, got: Any, want: Any) -> None:
    if got != want:
        raise NotImplementedError(f"{what}={got!r} is not ported (only {want!r})")


def build_model(conf: Dict[str, Any], vocab_size: int, data_dim: int,
                device=DEFAULT_DEVICE) -> VAECaptionModel:
    """Build the flagship Hybrid AC-VAE named by ``conf`` on ``device``."""
    model_args = dict(conf.get("model_args", {}))
    _require("model", conf.get("model", "Hybrid_VAEModel"), "Hybrid_VAEModel")
    _require("encodermodel", conf.get("encodermodel", "Cnn10"), "Cnn10")
    _require("decoder", conf.get("decoder", "VAERNNBahdanauAttnDecoder"),
             "VAERNNBahdanauAttnDecoder")
    _require("posterior_model",
             model_args.get("posterior_model", "PosteriorRNN_hybrid"),
             "PosteriorRNN_hybrid")
    _require("prior_model", model_args.get("prior_model", "PriorRNN"),
             "PriorRNN")

    enc_args = dict(conf.get("encoder_args", {}))
    enc_args["dtype"] = _DTYPES[enc_args.get("dtype", "float32")]
    encoder = Cnn10(inputdim=data_dim, device=device, **enc_args)
    dec_args = dict(conf.get("decoder_args", {}))
    embed = dec_args.setdefault("embed_size", encoder.embed_size)
    decoder = VAERNNBahdanauAttnDecoder(vocab_size, enc_mem_size=embed,
                                        device=device, **dec_args)
    qnet = PosteriorRNNHybrid(vocab_size, word_dim=embed, embed_size=embed,
                              device=device,
                              **model_args.get("posterior_args", {}))
    pnet = PriorRNN(vocab_size, word_dim=embed, audiofeats_size=embed,
                    embed_size=embed, device=device,
                    **model_args.get("prior_args", {}))
    return VAECaptionModel(encoder, decoder, qnet, pnet,
                           global_constraint=True, device=device)
