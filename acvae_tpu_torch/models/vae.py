"""The Hybrid AC-VAE caption model (counterpart of
``acvae_tpu/models/vae.py:61-113, 115-169, 216-300``).

``VAECaptionModel(global_constraint=True)`` is the reference's
``Hybrid_VAEModel`` (vae_model.py:674-1048): a per-timestep latent-word VAE
with an autoregressive prior and the utterance-level global head.  The
teacher-forced pass is a Python loop over T = L-1 steps; each step is one
prior step and one decoder step (:meth:`_step_pair`, the plain branch of the
JAX package).

Noise: ``train_forward`` takes its draws in ``noise`` — ``q_eps`` [N,T,E],
``p_eps`` [T,N,E], ``ss_coins`` [T] and ``dis_coins`` [T] (bool) — and draws
whatever is missing from ``generator``.  The coins are per *timestep*, as in
the reference; the carried ``last_z`` is always the prior sample
(vae_model.py:192).

Inference (counterpart of ``acvae_tpu/models/vae.py:305-395, 436-469``):
``inference_forward`` encodes and decodes under ``torch.inference_mode``
with BatchNorm on its running statistics and no dropout.  ``beam_search``
draws a prior z per beam (eps [T, N·B, E], row ``n·B+b`` is beam ``b`` of
clip ``n``; the beam gathers reorder the state, never the noise), takes flat
top-k from step 0 and has no end handling.  ``stepwise_decode`` is the
greedy / gumbel / sample decode with the reference's finished mask.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from acvae_tpu_torch import END_IDX, MAX_LENGTH, START_IDX
from acvae_tpu_torch.decoding.beam import BeamConfig, batched_beam_search
from acvae_tpu_torch.decoding.sampling import sample_next_word
from acvae_tpu_torch.models.common import eps_stack
from acvae_tpu_torch.ops.masked import length_mask, max_with_lens, mean_with_lens

_DECODE_METHODS = ("greedy", "gumbel", "sample", "beam", "dbs")


def _check_decode_method(family: str, method: str) -> None:
    """Fail fast, naming the caller, on an unknown decode method."""
    if method not in _DECODE_METHODS:
        raise ValueError(
            f"{family} does not support decode_method={method!r}; "
            f"supported: {', '.join(_DECODE_METHODS)}")


class VAECaptionModel(nn.Module):
    start_idx = START_IDX
    end_idx = END_IDX

    def __init__(self, encoder: nn.Module, decoder: nn.Module, qnet: nn.Module,
                 pnet: nn.Module, global_constraint: bool = True,
                 max_length: int = MAX_LENGTH, device=None):
        super().__init__()
        self.max_length = max_length
        if encoder.embed_size != decoder.embed_size:
            raise NotImplementedError("the encoder->decoder `ln` adapter is not "
                                      "ported: encoder and decoder embed sizes "
                                      "must match")
        self.encoder, self.decoder, self.qnet, self.pnet = (encoder, decoder,
                                                            qnet, pnet)
        self.global_constraint = global_constraint
        if global_constraint:
            # Hybrid_VAEModel.mean_log_out (vae_model.py:693) over the
            # mean+max pooled decoder hiddens
            self.mean_log_out = nn.Linear(decoder.hidden_size,
                                          2 * decoder.embed_size, device=device)
            nn.init.xavier_uniform_(self.mean_log_out.weight)
            nn.init.zeros_(self.mean_log_out.bias)

    def encode(self, feats, feat_lens, train: bool = False):
        return self.encoder(feats, feat_lens, train=train)

    def _prep_ctx(self, encoded):
        enc_mem = encoded["audio_embeds"].float()
        enc_mask = length_mask(encoded["audio_embeds_lens"], enc_mem.shape[1])
        return (enc_mem, enc_mask, self.pnet.project_enc(enc_mem),
                self.decoder.project_enc(enc_mem))

    def _step_pair(self, word, dec_h, p_state, last_z, eps_t, z_fn,
                   enc_mem, enc_mask, p_proj, d_proj, train=False):
        """One prior step + one decoder step (vae_model.py:116-139);
        ``z_fn(p) -> z`` picks the decoder's latent."""
        p = self.pnet.step(word, enc_mem, p_proj, enc_mask, p_state, last_z,
                           eps_t)
        d = self.decoder.step(word, dec_h, enc_mem, d_proj, enc_mask, z_fn(p),
                              train=train)
        return p, d

    def forward(self, feats, feat_lens, caps=None, cap_lens=None, **kwargs):
        """The reference's arity dispatch (vae_model.py:57-86): with captions
        the train forward, without them the inference forward."""
        if caps is not None:
            return self.train_forward(feats, feat_lens, caps, cap_lens, **kwargs)
        return self.inference_forward(feats, feat_lens, **kwargs)

    def train_forward(self, feats, feat_lens, caps, cap_lens,
                      ss_ratio: float = 1.0, dis_ratio: float = 0.0,
                      train: bool = True, noise: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """Teacher-forced pass; caps [N, L] (``<start> .. <end> <pad>..``).
        Returns per-step logits / outputs / p stats [N, T, ·] (T = L-1), the
        q stats, and ``p_means_utt`` for the global constraint."""
        N, L = caps.shape
        T = L - 1
        E = self.decoder.embed_size
        dev = caps.device
        noise = noise or {}
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train)
        enc_mem, enc_mask, p_proj, d_proj = self._prep_ctx(encoded)

        q_eps = noise.get("q_eps")
        if q_eps is None:
            q_eps = torch.randn((N, T, E), generator=generator, device=dev)
        with record_function("posterior"):
            qnetout = self.qnet(caps, cap_lens, q_eps.to(dev))
        ss_coins = noise.get("ss_coins")
        if ss_coins is None:
            ss_coins = torch.rand((T,), generator=generator, device=dev) < ss_ratio
        dis_coins = noise.get("dis_coins")
        if dis_coins is None:
            dis_coins = ((torch.rand((T,), generator=generator, device=dev)
                          <= dis_ratio) & (dis_ratio > 0))
        p_eps = noise.get("p_eps")
        if p_eps is None:
            p_eps = eps_stack(T, N, E, generator, dev)
        ss_coins, dis_coins = ss_coins.to(dev), dis_coins.to(dev)
        p_eps = p_eps.to(dev)

        dec_h = self.decoder.init_state(N, dev)
        p_state = self.pnet.init_state(N, dev)
        last_z = torch.zeros((N, E), device=dev)
        prev_word = torch.full((N,), START_IDX, dtype=torch.long, device=dev)
        ys = {k: [] for k in ("logits", "output", "p_means", "p_logs", "p_z",
                              "seqs")}
        with record_function("decode_loop"):
            for t in range(T):
                word = torch.where(ss_coins[t], caps[:, t].long(), prev_word)
                q_z_t = qnetout["q_z"][:, t]
                p, d = self._step_pair(
                    word, dec_h, p_state, last_z, p_eps[t],
                    lambda p: torch.where(dis_coins[t], p["z"], q_z_t),
                    enc_mem, enc_mask, p_proj, d_proj, train=train)
                w_t, _ = sample_next_word(d["logits"], "greedy")
                dec_h, p_state, last_z, prev_word = (d["state"], p["state"],
                                                     p["z"], w_t)
                for k, v in (("logits", d["logits"]), ("output", d["output"]),
                             ("p_means", p["mean"]), ("p_logs", p["log"]),
                             ("p_z", p["z"]), ("seqs", w_t)):
                    ys[k].append(v)
        output = {k: torch.stack(v, dim=1) for k, v in ys.items()}
        output.update(qnetout)
        output["audio_embeds"] = enc_mem
        output["audio_embeds_lens"] = encoded["audio_embeds_lens"]
        if self.global_constraint:
            # Hybrid_VAEModel.stepwise_forward tail (vae_model.py:722-730)
            hidden = (mean_with_lens(output["output"], cap_lens - 1)
                      + max_with_lens(output["output"], cap_lens - 1))
            output["p_means_utt"] = self.mean_log_out(hidden)
        return output

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def inference_forward(self, feats, feat_lens, decode_method: str = "greedy",
                          max_length: Optional[int] = None, beam_size: int = 3,
                          temp: float = 1.0, eps: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, Any]:
        _check_decode_method("VAECaptionModel", decode_method)
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train=False)
        return self.inference_from_encoded(
            encoded, decode_method=decode_method, max_length=max_length,
            beam_size=beam_size, temp=temp, eps=eps, gumbel=gumbel,
            generator=generator)

    @torch.inference_mode()
    def inference_from_encoded(self, encoded, decode_method: str = "greedy",
                               max_length: Optional[int] = None,
                               beam_size: int = 3, temp: float = 1.0,
                               eps: Optional[torch.Tensor] = None,
                               gumbel: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Dict[str, Any]:
        """Decode from a precomputed encoder dict.  ``eps`` is the prior
        noise ([T, N·B, E] for beam, [T, N, E] otherwise) and ``gumbel``
        the per-step Gumbel draws [T, N, V] of ``gumbel``/``sample``; what
        is not given is drawn from ``generator``."""
        _check_decode_method("VAECaptionModel", decode_method)
        max_length = max_length or self.max_length
        if decode_method == "dbs":
            raise NotImplementedError("diverse beam search is not ported "
                                      "(ROADMAP A14)")
        if decode_method == "beam":
            return self.beam_search(encoded, max_length, beam_size, eps=eps,
                                    generator=generator)
        return self.stepwise_decode(encoded, decode_method, max_length, temp,
                                    eps=eps, gumbel=gumbel, generator=generator)

    def _prior_noise(self, eps, steps: int, rows: int, generator, dev):
        if eps is None:
            eps = eps_stack(steps, rows, self.decoder.embed_size, generator, dev)
        return eps.to(dev)

    def stepwise_decode(self, encoded, method: str, max_length: int,
                        temp: float = 1.0, eps: Optional[torch.Tensor] = None,
                        gumbel: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, Any]:
        """Greedy / sampled autoregressive decode; after a clip's first
        ``<end>`` every later word is ``<end>`` (vae_model.py:44-54).
        Returns per-step outputs [N, T, ...]."""
        enc_mem, enc_mask, p_proj, d_proj = self._prep_ctx(encoded)
        N, dev = enc_mem.shape[0], enc_mem.device
        eps = self._prior_noise(eps, max_length, N, generator, dev)
        dec_h, p_state, last_z = self.init_decode_state(N, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)
        ys = {k: [] for k in ("logits", "output", "p_means", "p_logs", "p_z",
                              "seqs", "sampled_logprobs")}
        with record_function("decode_loop"):
            for t in range(max_length):
                p, d = self._step_pair(word, dec_h, p_state, last_z, eps[t],
                                       lambda p: p["z"], enc_mem, enc_mask,
                                       p_proj, d_proj)
                w_t, lp_t = sample_next_word(
                    d["logits"], method, temp,
                    gumbel=None if gumbel is None else gumbel[t],
                    generator=generator)
                w_t = torch.where(finished, self.end_idx, w_t)
                finished = finished | (w_t == self.end_idx)
                dec_h, p_state, last_z, word = d["state"], p["state"], p["z"], w_t
                for k, v in (("logits", d["logits"]), ("output", d["output"]),
                             ("p_means", p["mean"]), ("p_logs", p["log"]),
                             ("p_z", p["z"]), ("seqs", w_t),
                             ("sampled_logprobs", lp_t)):
                    ys[k].append(v)
        return {k: torch.stack(v, dim=1) for k, v in ys.items()}

    def beam_search(self, encoded, max_length: int, beam_size: int,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
        """VAE-flavour beam search (vae_model.py:220-312): a prior z per
        beam, flat top-k from step 0, no end handling; top beam first.
        The attention memories stay per clip [N, S, ·]: the attention folds
        the beam axis out of the [N·B] queries."""
        enc_mem, enc_mask, p_proj, d_proj = self._prep_ctx(encoded)
        N, B, dev = enc_mem.shape[0], beam_size, enc_mem.device
        eps = self._prior_noise(eps, max_length, N * B, generator, dev)

        def step_fn(state, words, t):
            dec_h, p_state, last_z = state
            p, d = self._step_pair(words, dec_h, p_state, last_z, eps[t],
                                   lambda p: p["z"], enc_mem, enc_mask,
                                   p_proj, d_proj)
            return d["logits"], (d["state"], p["state"], p["z"])

        cfg = BeamConfig(beam_size=B, max_length=max_length,
                         start_idx=self.start_idx, end_idx=self.end_idx,
                         first_step_row0=False, end_handling=False)
        with record_function("decode_loop"):
            return batched_beam_search(step_fn, self.init_decode_state(N * B, dev),
                                       N, cfg)

    # ------------------------------------------------------------------ #
    # externally driven per-step decode (the ensemble API)
    # ------------------------------------------------------------------ #
    def decode_ctx(self, encoded):
        """Per-utterance decode context (enc_mem, mask, attention
        projections) for externally driven stepping."""
        return self._prep_ctx(encoded)

    def init_decode_state(self, batch: int, device=None):
        """(decoder GRU state, prior LSTM (h, c), last_z), all zeros."""
        return (self.decoder.init_state(batch, device),
                self.pnet.init_state(batch, device),
                torch.zeros((batch, self.decoder.embed_size), device=device))

    def decode_step_api(self, ctx, state, words, eps_t):
        """One decode step driven from outside: (logits, new state)."""
        enc_mem, enc_mask, p_proj, d_proj = ctx
        dec_h, p_state, last_z = state
        p, d = self._step_pair(words, dec_h, p_state, last_z, eps_t,
                               lambda p: p["z"], enc_mem, enc_mask, p_proj,
                               d_proj)
        return d["logits"], (d["state"], p["state"], p["z"])
