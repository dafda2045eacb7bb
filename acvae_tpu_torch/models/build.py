"""Config -> model (counterpart of ``acvae_tpu/models/build.py:55-104``).

The reference's model names: ``Hybrid_VAEModel`` and ``VAEModel``
(``VAECaptionModel``), ``SimpleVAEModel``, ``TransVAEModel``,
``Seq2SeqAttnModel`` (``AttnCaptionModel``) and ``TransformerModel``, each
with its default posterior.  The encoder is Cnn10 (the others are ROADMAP
A16); the decoders and latents are those of ``models/decoders.py`` and
``models/latent.py``.  The decoder's memory size is its embed size; when
the encoder's differs, the model's ``ln`` adapter maps it.  Any other name
raises NotImplementedError.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.captioner import AttnCaptionModel, TransformerCaptionModel
from acvae_tpu_torch.models.decoders import DECODERS
from acvae_tpu_torch.models.encoders import Cnn10
from acvae_tpu_torch.models.latent import (GMMPriorRNN, PosteriorRNN,
                                           PosteriorRNNHybrid, PosteriorSentence,
                                           PriorRNN)
from acvae_tpu_torch.models.trans_vae import TransVAECaptionModel
from acvae_tpu_torch.models.vae import SimpleVAECaptionModel, VAECaptionModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LATENTS = {c.__name__: c for c in (PosteriorRNN, PosteriorSentence, PriorRNN,
                                   GMMPriorRNN)}
LATENTS["PosteriorRNN_hybrid"] = PosteriorRNNHybrid
# the constructor arguments a latent takes; the reference passes others
# (rnn_type, ...) through **kwargs, and the JAX package drops them too
_LATENT_ARGS = {"vocab_size", "word_dim", "embed_size", "hidden_size",
                "audiofeats_size", "gmm_kernel"}
MODELS = ("Hybrid_VAEModel", "VAEModel", "SimpleVAEModel", "TransVAEModel",
          "Seq2SeqAttnModel", "TransformerModel")


def _build_latent(name: str, args: Dict[str, Any], vocab_size: int,
                  embed: int, device, audiofeats_size: Optional[int] = None):
    if name not in LATENTS:
        raise NotImplementedError(f"latent {name!r} is not ported (the JAX "
                                  f"package registers {sorted(LATENTS)})")
    cls = LATENTS[name]
    kwargs = dict(word_dim=embed, embed_size=embed, **args)
    if audiofeats_size is not None:
        kwargs.setdefault("audiofeats_size", audiofeats_size)
    params = inspect.signature(cls).parameters
    kwargs = {k: v for k, v in kwargs.items()
              if k in _LATENT_ARGS and k in params}
    return cls(vocab_size, device=device, **kwargs)


def build_model(conf: Dict[str, Any], vocab_size: int, data_dim: int,
                device=DEFAULT_DEVICE):
    """Build the caption model named by ``conf['model']`` on ``device``."""
    name = conf.get("model", "Hybrid_VAEModel")
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported: the port builds {', '.join(MODELS)} "
            f"(the CaptionSentenceModel head of configs/sentence.yaml is "
            f"ROADMAP A17 part 2)")
    if conf.get("encodermodel", "Cnn10") != "Cnn10":
        raise NotImplementedError(f"encodermodel={conf['encodermodel']!r} is "
                                  f"not ported (only 'Cnn10'; ROADMAP A16)")
    dec_name = conf.get("decoder", "VAERNNBahdanauAttnDecoder")
    if dec_name not in DECODERS:
        raise NotImplementedError(f"decoder {dec_name!r} is not ported (the JAX "
                                  f"package registers {sorted(DECODERS)})")
    model_args = dict(conf.get("model_args", {}))

    enc_args = dict(conf.get("encoder_args", {}))
    enc_args["dtype"] = _DTYPES[enc_args.get("dtype", "float32")]
    encoder = Cnn10(inputdim=data_dim, device=device, **enc_args)
    dec_args = dict(conf.get("decoder_args", {}))
    embed = dec_args.setdefault("embed_size", encoder.embed_size)
    decoder = DECODERS[dec_name](vocab_size, enc_mem_size=embed, device=device,
                                 **dec_args)

    def latent(key, default, **kw):
        return _build_latent(model_args.get(key, default),
                             model_args.get(key.replace("model", "args"), {}),
                             vocab_size, embed, device, **kw)

    if name in ("VAEModel", "Hybrid_VAEModel", "TransVAEModel"):
        hybrid = name == "Hybrid_VAEModel"
        qnet = latent("posterior_model",
                      "PosteriorRNN_hybrid" if hybrid else "PosteriorRNN")
        pnet = latent("prior_model", "PriorRNN", audiofeats_size=embed)
        if name == "TransVAEModel":
            return TransVAECaptionModel(encoder, decoder, qnet, pnet,
                                        device=device)
        return VAECaptionModel(encoder, decoder, qnet, pnet,
                               global_constraint=hybrid, device=device)
    if name == "SimpleVAEModel":
        return SimpleVAECaptionModel(
            encoder, decoder, latent("posterior_model", "PosteriorSentence"),
            device=device)
    cls = AttnCaptionModel if name == "Seq2SeqAttnModel" else TransformerCaptionModel
    # the JAX package passes model_args to the captioner as its fields
    return cls(encoder, decoder, device=device, **model_args)
