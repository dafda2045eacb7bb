"""The transformer-decoder AC-VAE (counterpart of
``acvae_tpu/models/trans_vae.py:31-346``, the reference's pyc-only
``TransVAEModel``).

The autoregressive prior (``PriorRNN`` or ``GMMPriorRNN``) steps as in the
RNN VAE.  The decoder is a :class:`VAETransformerDecoder` that each step
runs over the whole [N, T] word buffer and [N, T, E] latent buffer, the
positions past the current one counted as padding, and reads the logits at
the current position (``_decoder_logits``).  That is O(T²) work by design:
it is what the JAX package computes.

Noise is as in ``models/vae.py``: ``q_eps`` [N, T, E], ``p_eps`` [T, N, E]
and the coins in ``train_forward``'s ``noise``; ``eps`` [T, N(·B), E] for
the stepwise and beam decodes and [G, T+G-1, N·bdash, E] for dbs.  In dbs
group g writes the buffers at its local position ``t - g`` and reads the
prior noise of the global step, ``eps[g, t]`` (trans_vae.py:185-199); the
engine (``decoding/dbs.py``) steps a group only while it is active, where
``t - g`` lies in [0, T-1], so the JAX package's clip never binds.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from acvae_tpu_torch import MAX_LENGTH
from acvae_tpu_torch.decoding.beam import BeamConfig, batched_beam_search
from acvae_tpu_torch.decoding.dbs import DBSConfig, dbs_bdash, diverse_beam_search
from acvae_tpu_torch.decoding.sampling import sample_next_word
from acvae_tpu_torch.models.common import (CaptionModel, check_decode_method,
                                           grad_optional,
                                           eps_stack, forced_logprob,
                                           stack_steps)
from acvae_tpu_torch.ops.masked import length_mask


class TransVAECaptionModel(CaptionModel):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, qnet: nn.Module,
                 pnet: nn.Module, max_length: int = MAX_LENGTH, device=None):
        super().__init__(encoder, decoder, max_length, device)
        self.qnet, self.pnet = qnet, pnet
        self.bf16_decode = not hasattr(pnet, "gmm_kernel")

    def _dtype(self) -> torch.dtype:
        """The decode's dtype: the prior's parameters' (``ops/amp.py``)."""
        return self.pnet.network.weight_hh.dtype

    def _prep(self, encoded):
        """(memory, lengths, attention mask, the prior's projection)."""
        enc_mem = encoded["audio_embeds"].to(self._dtype())
        lens = encoded["audio_embeds_lens"]
        return (enc_mem, lens, length_mask(lens, enc_mem.shape[1]),
                self.pnet.project_enc(enc_mem))

    def _decoder_logits(self, words_buf, z_buf, t: int, enc_mem, lens,
                        train: bool = False):
        """The decoder over the buffers with positions past ``t`` padded:
        (logits, output) at position t."""
        pad = (torch.arange(words_buf.shape[1], device=words_buf.device)
               > t)[None].expand(words_buf.shape)
        out = self.decoder(words_buf, enc_mem, lens, pad, z_buf, train=train,
                           at=t)
        return out["logits"], out["output"]

    def _init_buffers(self, rows: int, T: int, dev):
        return (torch.full((rows, T), self.start_idx, dtype=torch.long,
                           device=dev),
                torch.zeros((rows, T, self.decoder.embed_size),
                            dtype=self._dtype(), device=dev))

    @staticmethod
    def _write(words_buf, z_buf, pos: int, words, z):
        """The buffers with ``words``/``z`` at ``pos`` (new tensors: the beam
        engines may still hold the old ones)."""
        words_buf, z_buf = words_buf.clone(), z_buf.clone()
        words_buf[:, pos] = words
        z_buf[:, pos] = z
        return words_buf, z_buf

    def train_forward(self, feats, feat_lens, caps, cap_lens,
                      ss_ratio: float = 1.0, dis_ratio: float = 0.0,
                      train: bool = True, noise: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        N, L = caps.shape
        T, E, dev, dt = L - 1, self.decoder.embed_size, caps.device, self._dtype()
        noise = noise or {}
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train)
        enc_mem, lens, enc_mask, p_proj = self._prep(encoded)
        q_eps = noise.get("q_eps")
        if q_eps is None:
            q_eps = torch.randn((N, T, E), generator=generator, device=dev)
        with record_function("posterior"):
            qnetout = self.qnet(caps, cap_lens, q_eps.to(dev, dt))
        ss_coins = noise.get("ss_coins")
        if ss_coins is None:
            ss_coins = torch.rand((T,), generator=generator, device=dev) < ss_ratio
        dis_coins = noise.get("dis_coins")
        if dis_coins is None:
            dis_coins = ((torch.rand((T,), generator=generator, device=dev)
                          <= dis_ratio) & (dis_ratio > 0))
        p_eps = noise.get("p_eps")
        if p_eps is None:
            p_eps = eps_stack(T, N, E, generator, dev, dt)
        ss_coins, dis_coins, p_eps = (ss_coins.to(dev), dis_coins.to(dev),
                                      p_eps.to(dev, dt))
        p_state = self.pnet.init_state(N, dev, dt)
        last_z = torch.zeros((N, E), dtype=dt, device=dev)
        words_buf, z_buf = self._init_buffers(N, T, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        ys = {k: [] for k in ("logits", "output", "p_means", "p_logs", "p_z",
                              "seqs")}
        with record_function("decode_loop"):
            for t in range(T):
                word = torch.where(ss_coins[t], caps[:, t].long(), word)
                p = self.pnet.step(word, enc_mem, p_proj, enc_mask, p_state,
                                   last_z, p_eps[t])
                z = torch.where(dis_coins[t], p["z"], qnetout["q_z"][:, t])
                words_buf, z_buf = self._write(words_buf, z_buf, t, word, z)
                logits, out = self._decoder_logits(words_buf, z_buf, t, enc_mem,
                                                   lens, train)
                p_state, last_z = p["state"], p["z"]
                word = sample_next_word(logits, "greedy")[0]
                for k, v in (("logits", logits), ("output", out),
                             ("p_means", p["mean"]), ("p_logs", p["log"]),
                             ("p_z", p["z"]), ("seqs", word)):
                    ys[k].append(v)
        output = stack_steps(ys)
        if output["p_means"].ndim == 4:
            # GMM prior: [K, T, N, E] -> [K, N, T, E], as models/vae.py
            output["p_means"] = output["p_means"].transpose(1, 2)
            output["p_logs"] = output["p_logs"].transpose(1, 2)
            output["p_mixture_logits"] = self.pnet.mixture_logits
        output.update(qnetout)
        return output

    @torch.inference_mode()
    def inference_forward(self, feats, feat_lens, decode_method: str = "greedy",
                          max_length: Optional[int] = None, beam_size: int = 3,
                          temp: float = 1.0, eps: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          **dbs_kwargs) -> Dict[str, Any]:
        check_decode_method("TransVAECaptionModel", decode_method)
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train=False)
        return self._decode(encoded, decode_method, max_length, beam_size,
                            temp, eps, gumbel, generator, **dbs_kwargs)

    def _decode(self, encoded, decode_method, max_length=None, beam_size=3,
                temp=1.0, eps=None, gumbel=None, generator=None, **dbs_kwargs):
        max_length = max_length or self.max_length
        with record_function("decode_loop"):
            if decode_method == "beam":
                return self.beam_search(encoded, max_length, beam_size, eps,
                                        generator)
            if decode_method == "dbs":
                return self.diverse_beam_search(encoded, max_length, beam_size,
                                                eps=eps, generator=generator,
                                                **dbs_kwargs)
            return self.stepwise_decode(encoded, decode_method, max_length,
                                        temp, eps, gumbel, generator)

    def _noise(self, eps, steps, rows, generator, dev):
        if eps is None:
            eps = eps_stack(steps, rows, self.decoder.embed_size, generator, dev)
        return eps.to(dev, self._dtype())

    def _rollout(self, encoded, T, eps, pick):
        """The stepwise decode's loop: ``pick(t, logits)`` gives the next
        word and what to record at step t."""
        enc_mem, lens, enc_mask, p_proj = self._prep(encoded)
        N, dev = enc_mem.shape[0], enc_mem.device
        p_state = self.pnet.init_state(N, dev, self._dtype())
        last_z = torch.zeros((N, self.decoder.embed_size), dtype=self._dtype(),
                             device=dev)
        words_buf, z_buf = self._init_buffers(N, T, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        ys = {}
        for t in range(T):
            p = self.pnet.step(word, enc_mem, p_proj, enc_mask, p_state,
                               last_z, eps[t])
            words_buf, z_buf = self._write(words_buf, z_buf, t, word, p["z"])
            logits, out = self._decoder_logits(words_buf, z_buf, t, enc_mem, lens)
            word, rec = pick(t, logits)
            p_state, last_z = p["state"], p["z"]
            for k, v in dict(rec, logits=logits, output=out, p_means=p["mean"],
                             p_logs=p["log"], p_z=p["z"]).items():
                ys.setdefault(k, []).append(v)
        return stack_steps(ys)

    def stepwise_decode(self, encoded, method: str, max_length: int,
                        temp: float = 1.0, eps=None, gumbel=None,
                        generator=None):
        N, dev = encoded["audio_embeds"].shape[0], encoded["audio_embeds"].device
        eps = self._noise(eps, max_length, N, generator, dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)

        def pick(t, logits):
            nonlocal finished
            w_t, lp_t = sample_next_word(
                logits, method, temp,
                gumbel=None if gumbel is None else gumbel[t], generator=generator)
            w_t = torch.where(finished, self.end_idx, w_t)
            finished = finished | (w_t == self.end_idx)
            return w_t, {"seqs": w_t, "sampled_logprobs": lp_t}
        return self._rollout(encoded, max_length, eps, pick)

    @grad_optional
    def forced_decode(self, feats, feat_lens, given_seqs: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """The log-probabilities of ``given_seqs`` [N, T] fed as the words,
        with the prior noise ``eps`` [T, N, E] of the rollout."""
        encoded = self.encode(feats, feat_lens)
        N, T = given_seqs.shape
        dev = encoded["audio_embeds"].device
        given = given_seqs.to(dev).long()
        eps = self._noise(eps, T, N, generator, dev)
        out = self._rollout(encoded, T, eps, lambda t, logits: (
            given[:, t], {"sampled_logprobs": forced_logprob(logits,
                                                               given[:, t])}))
        return {"sampled_logprobs": out["sampled_logprobs"], "seqs": given_seqs}

    def _beam_step(self, enc, rep, eps_of, local):
        """A beam step: the prior on the clip-level memory (its attention
        folds the beam axis), the decoder on the memory repeated ``rep``
        times a clip; words and z go in at ``local(t)``."""
        enc_mem, lens, enc_mask, p_proj = enc
        mem_r = enc_mem.repeat_interleave(rep, dim=0)
        lens_r = lens.repeat_interleave(rep, dim=0)

        def step_fn(state, words, t):
            p_state, last_z, words_buf, z_buf = state
            pos = local(t)
            p = self.pnet.step(words, enc_mem, p_proj, enc_mask, p_state,
                               last_z, eps_of(t))
            words_buf, z_buf = self._write(words_buf, z_buf, pos, words, p["z"])
            logits, _ = self._decoder_logits(words_buf, z_buf, pos, mem_r,
                                             lens_r)
            return logits, (p["state"], p["z"], words_buf, z_buf)
        return step_fn

    def _init_state(self, rows, T, dev):
        return (self.pnet.init_state(rows, dev, self._dtype()),
                torch.zeros((rows, self.decoder.embed_size), dtype=self._dtype(),
                            device=dev)) + self._init_buffers(rows, T, dev)

    def beam_search(self, encoded, max_length: int, beam_size: int,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """VAE-flavour beam (flat top-k from step 0, no end handling), the
        buffers carried a beam; ``eps`` [T, N·B, E]."""
        enc = self._prep(encoded)
        N, dev = enc[0].shape[0], enc[0].device
        eps = self._noise(eps, max_length, N * beam_size, generator, dev)
        cfg = BeamConfig(beam_size=beam_size, max_length=max_length,
                         start_idx=self.start_idx, end_idx=self.end_idx)
        return batched_beam_search(
            self._beam_step(enc, beam_size, lambda t: eps[t], lambda t: t),
            self._init_state(N * beam_size, max_length, dev), N, cfg)

    def diverse_beam_search(self, encoded, max_length: int, beam_size: int,
                            group_size: int = 5, diversity_lambda: float = 0.5,
                            temperature: float = 1.0, group_nbest: bool = True,
                            eps: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
        """Group g: buffers at the local position t - g, prior noise
        ``eps[g, t]`` of the global step t."""
        enc = self._prep(encoded)
        N, dev = enc[0].shape[0], enc[0].device
        bdash = dbs_bdash(beam_size, group_size)
        steps = max_length + group_size - 1
        eps = (torch.stack([self._noise(None, steps, N * bdash, generator, dev)
                            for _ in range(group_size)])
               if eps is None else eps.to(dev, self._dtype()))
        cfg = DBSConfig(beam_size=beam_size, group_size=group_size,
                        max_length=max_length,
                        diversity_lambda=diversity_lambda,
                        temperature=temperature, group_nbest=group_nbest,
                        start_idx=self.start_idx, end_idx=self.end_idx)
        return diverse_beam_search(
            lambda g: self._beam_step(enc, bdash, lambda t: eps[g, t],
                                      lambda t: t - g),
            lambda: self._init_state(N * bdash, max_length, dev), N, cfg)
