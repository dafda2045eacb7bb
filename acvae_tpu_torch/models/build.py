"""Config -> model (counterpart of ``acvae_tpu/models/build.py:55-104``).

The reference's model names: ``Hybrid_VAEModel`` and ``VAEModel``
(``VAECaptionModel``), ``SimpleVAEModel``, ``TransVAEModel``,
``Seq2SeqAttnModel`` (``AttnCaptionModel``) and ``TransformerModel``, each
with its default posterior.  The encoder is any of ``models/encoders.py``'s
``ENCODERS`` by the JAX package's name (the composites' ``trunk``/``crnn``/
``cnn`` given as dicts with a ``name``); the decoders and latents are those
of ``models/decoders.py`` and ``models/latent.py``.  The decoder's memory size is its embed size; when
the encoder's differs, the model's ``ln`` adapter maps it.  Any other name
raises NotImplementedError.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.captioner import AttnCaptionModel, TransformerCaptionModel
from acvae_tpu_torch.models.decoders import DECODERS
from acvae_tpu_torch.models.encoders import build_encoder
from acvae_tpu_torch.models.latent import (GMMPriorRNN, PosteriorRNN,
                                           PosteriorRNNHybrid, PosteriorSentence,
                                           PriorRNN)
from acvae_tpu_torch.models.trans_vae import TransVAECaptionModel
from acvae_tpu_torch.models.vae import SimpleVAECaptionModel, VAECaptionModel

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
            f"Seq2SeqAttnModel with model_args.seq_output_size)")
    dec_name = conf.get("decoder", "VAERNNBahdanauAttnDecoder")
    if dec_name not in DECODERS:
        raise NotImplementedError(f"decoder {dec_name!r} is not ported (the JAX "
                                  f"package registers {sorted(DECODERS)})")
    model_args = dict(conf.get("model_args", {}))

    encoder = build_encoder(conf.get("encodermodel", "Cnn10"),
                            conf.get("encoder_args", {}), data_dim, device)
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
    # (Seq2SeqAttnModel's seq_output_size: the CaptionSentenceModel head)
    return cls(encoder, decoder, device=device, **model_args)
