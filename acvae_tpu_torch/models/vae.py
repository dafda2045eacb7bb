"""The AC-VAE caption models (counterpart of
``acvae_tpu/models/vae.py:61-514`` and ``:517-734``).

``VAECaptionModel`` is the reference's ``VAEModel`` (vae_model.py:12-364)
and, with ``global_constraint=True``, its ``Hybrid_VAEModel``
(vae_model.py:674-1048): a per-timestep latent-word VAE with an
autoregressive prior (``PriorRNN``, or the mixture ``GMMPriorRNN``).  The
teacher-forced pass is a Python loop over T = L-1 steps; each step is one
prior step and one decoder step (:meth:`_step_pair`, the plain branch of the
JAX package).  With a GMM prior the per-step moments are [K, N, E]; the
train forward lays them out [K, N, T, E] and returns ``p_mixture_logits``,
and every decode samples z from the selected component.

Noise: ``train_forward`` takes its draws in ``noise`` — ``q_eps`` [N,T,E],
``p_eps`` [T,N,E], ``ss_coins`` [T] and ``dis_coins`` [T] (bool) — and draws
whatever is missing from ``generator``.  The coins are per *timestep*, as in
the reference; the carried ``last_z`` is always the prior sample
(vae_model.py:192).

Inference (counterpart of ``acvae_tpu/models/vae.py:305-514``):
``inference_forward`` encodes and decodes under ``torch.inference_mode``
with BatchNorm on its running statistics and no dropout.  ``beam_search``
draws a prior z per beam (eps [T, N·B, E], row ``n·B+b`` is beam ``b`` of
clip ``n``; the beam gathers reorder the state, never the noise), takes flat
top-k from step 0 and has no end handling.  ``diverse_beam_search`` gives
each group its own prior noise, indexed by the global step (eps [G, T+G-1,
N·bdash, E]).  ``stepwise_decode`` is the greedy / gumbel / sample decode
with the reference's finished mask; ``forced_decode`` scores given words
with the same prior noise.  The decode state, the noise and the encoder
memory take the decoder's parameter dtype (``state_dtype``), so a model
cast by ``ops/amp.py::cast_floats_for_decode`` decodes in bf16.

``SimpleVAECaptionModel`` is the ``SimpleVAEModel`` ablation: one global z
a caption, the posterior's at train with the prior fixed at ``p_logs =
0.5``, and at eval ``z = eps·e^{0.5}`` from standard normal draws ``eps``:
[N, E] for greedy and sample, [N·B, E] for beam, [G, N·bdash, E] for dbs
(each group its own z a beam slot, held over the steps).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from acvae_tpu_torch import MAX_LENGTH, START_IDX
from acvae_tpu_torch.decoding.beam import BeamConfig, batched_beam_search
from acvae_tpu_torch.decoding.dbs import DBSConfig, dbs_bdash, diverse_beam_search
from acvae_tpu_torch.decoding.sampling import sample_next_word
from acvae_tpu_torch.models.common import (CaptionModel, check_decode_method,
                                           grad_optional,
                                           eps_stack, forced_logprob,
                                           stack_steps)
from acvae_tpu_torch.ops.masked import length_mask, max_with_lens, mean_with_lens
from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.train.profiling import mark_backward

# the eval prior's scale, e^{0.5·1} (vae_model.py:593-595), in float32
EVAL_Z_SCALE = float(torch.exp(torch.tensor(0.5)))


class VAECaptionModel(CaptionModel):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, qnet: nn.Module,
                 pnet: nn.Module, global_constraint: bool = True,
                 max_length: int = MAX_LENGTH, device=None):
        super().__init__(encoder, decoder, max_length, device)
        self.qnet, self.pnet = qnet, pnet
        self.global_constraint = global_constraint
        # the bf16 decode covers the Normal prior (the JAX package's tests)
        self.bf16_decode = not hasattr(pnet, "gmm_kernel")
        if global_constraint:
            # Hybrid_VAEModel.mean_log_out (vae_model.py:693) over the
            # mean+max pooled decoder hiddens
            self.mean_log_out = nn.Linear(decoder.hidden_size,
                                          2 * decoder.embed_size, device=device)
            nn.init.xavier_uniform_(self.mean_log_out.weight)
            nn.init.zeros_(self.mean_log_out.bias)

    def _prep_ctx(self, encoded):
        # the memory joins the decode's dtype; a bf16 encoder output upcasts
        # exactly in the float32 default
        enc_mem = encoded["audio_embeds"].to(self.decoder.state_dtype())
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
            encoded, ctx = mark_backward("encoder",
                                         (encoded, self._prep_ctx(encoded)))
        enc_mem, enc_mask, p_proj, d_proj = ctx

        q_eps = noise.get("q_eps")
        if q_eps is None:
            q_eps = pstate.randn((N, T, E), generator, dev)
        with record_function("posterior"):
            qnetout = mark_backward("posterior",
                                    self.qnet(caps, cap_lens, q_eps.to(dev)))
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
            output = mark_backward("decode_loop", stack_steps(ys))
        if output["p_means"].ndim == 4:
            # GMM prior: [K, T, N, E] -> the reference buffer layout
            # [K, N, T, E] (vae_model.py:100-101), with the mixture logits
            output["p_means"] = output["p_means"].transpose(1, 2)
            output["p_logs"] = output["p_logs"].transpose(1, 2)
            output["p_mixture_logits"] = self.pnet.mixture_logits
        output.update(qnetout)
        output["audio_embeds"] = encoded.get("audio_embeds_raw", enc_mem)
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
                          generator: Optional[torch.Generator] = None,
                          **dbs_kwargs) -> Dict[str, Any]:
        check_decode_method("VAECaptionModel", decode_method)
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train=False)
        return self.inference_from_encoded(
            encoded, decode_method=decode_method, max_length=max_length,
            beam_size=beam_size, temp=temp, eps=eps, gumbel=gumbel,
            generator=generator, **dbs_kwargs)

    @torch.inference_mode()
    def inference_from_encoded(self, encoded, decode_method: str = "greedy",
                               max_length: Optional[int] = None,
                               beam_size: int = 3, temp: float = 1.0,
                               eps: Optional[torch.Tensor] = None,
                               gumbel: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               apply_ln: bool = False,
                               **dbs_kwargs) -> Dict[str, Any]:
        """Decode from a precomputed encoder dict (``apply_ln`` runs the
        encoder->decoder adapter on a raw encoding, such as the int8
        encoder's).  ``eps`` is the prior
        noise ([T, N·B, E] for beam, [G, T+G-1, N·bdash, E] for dbs, [T, N,
        E] otherwise) and ``gumbel`` the per-step Gumbel draws [T, N, V] of
        ``gumbel``/``sample``; what is not given is drawn from
        ``generator``.  ``dbs_kwargs`` (``group_size``,
        ``diversity_lambda``, ``temperature``, ``group_nbest``) reach the
        dbs decode; the other methods ignore them, as the JAX package's
        do."""
        check_decode_method("VAECaptionModel", decode_method)
        max_length = max_length or self.max_length
        if apply_ln:
            encoded = self.apply_ln(encoded)
        if decode_method == "dbs":
            return self.diverse_beam_search(encoded, max_length, beam_size,
                                            eps=eps, generator=generator,
                                            **dbs_kwargs)
        if decode_method == "beam":
            return self.beam_search(encoded, max_length, beam_size, eps=eps,
                                    generator=generator)
        return self.stepwise_decode(encoded, decode_method, max_length, temp,
                                    eps=eps, gumbel=gumbel, generator=generator)

    def _prior_noise(self, eps, steps: int, rows: int, generator, dev):
        dt = self.decoder.state_dtype()
        if eps is None:
            eps = eps_stack(steps, rows, self.decoder.embed_size, generator,
                            dev, dt)
        return eps.to(dev, dt)

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
        return stack_steps(ys)

    @grad_optional
    def forced_decode(self, feats, feat_lens, given_seqs: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """Feed ``given_seqs`` [N, T] as the words and return their
        log-probabilities, with the prior noise ``eps`` [T, N, E] of the
        stepwise decode they replay (vae.py:397-434)."""
        encoded = self.encode(feats, feat_lens, train=False)
        enc_mem, enc_mask, p_proj, d_proj = self._prep_ctx(encoded)
        N, T = given_seqs.shape
        dev = enc_mem.device
        eps = self._prior_noise(eps, T, N, generator, dev)
        dec_h, p_state, last_z = self.init_decode_state(N, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        lps = []
        for t in range(T):
            p, d = self._step_pair(word, dec_h, p_state, last_z, eps[t],
                                   lambda p: p["z"], enc_mem, enc_mask,
                                   p_proj, d_proj)
            word = given_seqs[:, t].to(dev).long()
            lps.append(forced_logprob(d["logits"], word))
            dec_h, p_state, last_z = d["state"], p["state"], p["z"]
        return {"sampled_logprobs": torch.stack(lps, dim=1), "seqs": given_seqs}

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

    def diverse_beam_search(self, encoded, max_length: int, beam_size: int,
                            group_size: int = 5, diversity_lambda: float = 0.5,
                            temperature: float = 1.0, group_nbest: bool = True,
                            eps: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, Any]:
        """Diverse beam search (word_model.py:297-394 on the VAE's step):
        group g draws its prior z from ``eps[g]`` at the global step ``t``,
        so its local step 0 reads ``eps[g, g]``."""
        enc_mem, enc_mask, p_proj, d_proj = self._prep_ctx(encoded)
        N, dev = enc_mem.shape[0], enc_mem.device
        NB = N * dbs_bdash(beam_size, group_size)
        steps = max_length + group_size - 1
        eps = (torch.stack([self._prior_noise(None, steps, NB, generator, dev)
                            for _ in range(group_size)])
               if eps is None else eps.to(dev, self.decoder.state_dtype()))

        def make_step_fn(g):
            def step_fn(state, words, t):
                dec_h, p_state, last_z = state
                p, d = self._step_pair(words, dec_h, p_state, last_z, eps[g, t],
                                       lambda p: p["z"], enc_mem, enc_mask,
                                       p_proj, d_proj)
                return d["logits"], (d["state"], p["state"], p["z"])
            return step_fn

        cfg = DBSConfig(beam_size=beam_size, group_size=group_size,
                        max_length=max_length,
                        diversity_lambda=diversity_lambda,
                        temperature=temperature, group_nbest=group_nbest,
                        start_idx=self.start_idx, end_idx=self.end_idx)
        with record_function("decode_loop"):
            return diverse_beam_search(
                make_step_fn, lambda: self.init_decode_state(NB, dev), N, cfg)

    # ------------------------------------------------------------------ #
    # externally driven per-step decode (the ensemble API)
    # ------------------------------------------------------------------ #
    def decode_ctx(self, encoded):
        """Per-utterance decode context (enc_mem, mask, attention
        projections) for externally driven stepping."""
        return self._prep_ctx(encoded)

    def init_decode_state(self, batch: int, device=None):
        """(decoder GRU state, prior LSTM (h, c), last_z), all zeros, in the
        decoder's parameter dtype."""
        dt = self.decoder.state_dtype()
        return (self.decoder.init_state(batch, device, dt),
                self.pnet.init_state(batch, device, dt),
                torch.zeros((batch, self.decoder.embed_size), dtype=dt,
                            device=device))

    def decode_step_api(self, ctx, state, words, eps_t):
        """One decode step driven from outside: (logits, new state)."""
        enc_mem, enc_mask, p_proj, d_proj = ctx
        dec_h, p_state, last_z = state
        p, d = self._step_pair(words, dec_h, p_state, last_z, eps_t,
                               lambda p: p["z"], enc_mem, enc_mask, p_proj,
                               d_proj)
        return d["logits"], (d["state"], p["state"], p["z"])


class SimpleVAECaptionModel(CaptionModel):
    """SimpleVAEModel (vae_model.py:366-672): one global latent a caption,
    the same z at every decoder step."""
    bf16_decode = False

    def __init__(self, encoder: nn.Module, decoder: nn.Module, qnet: nn.Module,
                 max_length: int = MAX_LENGTH, device=None):
        super().__init__(encoder, decoder, max_length, device)
        self.qnet = qnet

    def _ctx(self, encoded):
        enc_mem = encoded["audio_embeds"].to(self.decoder.state_dtype())
        enc_mask = length_mask(encoded["audio_embeds_lens"], enc_mem.shape[1])
        return enc_mem, enc_mask, self.decoder.project_enc(enc_mem)

    def _decode_with_z(self, ctx, z, T: int, method: str = "greedy",
                       temp: float = 1.0, caps=None, ss_coins=None,
                       gumbel=None, generator=None, train: bool = False):
        """The decoder over T steps with z [N, E] at each; with ``caps`` the
        teacher word wherever ``ss_coins`` [T] holds, else the finished
        mask of the inference decode."""
        enc_mem, enc_mask, d_proj = ctx
        N, dev = enc_mem.shape[0], enc_mem.device
        z = z.to(self.decoder.state_dtype())
        h = self.decoder.init_state(N, dev, self.decoder.state_dtype())
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)
        ys = {k: [] for k in ("logits", "output", "seqs", "sampled_logprobs")}
        with record_function("decode_loop"):
            for t in range(T):
                if caps is not None:
                    word = torch.where(ss_coins[t], caps[:, t].long(), word)
                d = self.decoder.step(word, h, enc_mem, d_proj, enc_mask, z,
                                      train=train)
                w_t, lp_t = sample_next_word(
                    d["logits"], method, temp,
                    gumbel=None if gumbel is None else gumbel[t],
                    generator=generator)
                if caps is None:
                    w_t = torch.where(finished, self.end_idx, w_t)
                    finished = finished | (w_t == self.end_idx)
                h, word = d["state"], w_t
                for k, v in (("logits", d["logits"]), ("output", d["output"]),
                             ("seqs", w_t), ("sampled_logprobs", lp_t)):
                    ys[k].append(v)
            return mark_backward("decode_loop", stack_steps(ys))

    def train_forward(self, feats, feat_lens, caps, cap_lens,
                      ss_ratio: float = 1.0, dis_ratio: float = 0.0,
                      train: bool = True, noise: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """The posterior z at every step (vae_model.py:458-459); ``noise``:
        ``q_eps`` [N, E], ``p_eps`` [N, E], ``ss_coins`` [T]."""
        N, L = caps.shape
        E, dev = self.decoder.embed_size, caps.device
        noise = noise or {}
        draw = lambda k, shape: (noise[k] if k in noise else pstate.randn(  # noqa: E731
            shape, generator, dev)).to(dev)
        with record_function("encoder"):
            ctx = mark_backward("encoder", self._ctx(
                self.encode(feats, feat_lens, train)))
        with record_function("posterior"):
            qnetout = mark_backward("posterior", self.qnet(
                caps, cap_lens, draw("q_eps", (N, E))))
        ss_coins = noise.get("ss_coins")
        if ss_coins is None:
            ss_coins = torch.rand((L - 1,), generator=generator, device=dev) < ss_ratio
        out = self._decode_with_z(ctx, qnetout["q_z"], L - 1,
                                  caps=caps, ss_coins=ss_coins.to(dev),
                                  train=train)
        out.update(qnetout)
        # the fixed train prior (vae_model.py:491-494)
        out["p_means"] = torch.zeros((N, E), device=dev)
        out["p_logs"] = torch.full((N, E), 0.5, device=dev)
        out["p_z"] = draw("p_eps", (N, E)) * torch.exp(out["p_logs"] * 0.5)
        return out

    @torch.inference_mode()
    def inference_forward(self, feats, feat_lens, decode_method: str = "greedy",
                          max_length: Optional[int] = None, beam_size: int = 3,
                          temp: float = 1.0, eps: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          **dbs_kwargs) -> Dict[str, Any]:
        check_decode_method("SimpleVAECaptionModel", decode_method)
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train=False)
        return self._decode(encoded, decode_method, max_length, beam_size,
                            temp, eps, gumbel, generator, **dbs_kwargs)

    def _z(self, eps, shape, generator, dev):
        """The eval prior's z from standard normal draws ``eps``."""
        if eps is None:
            # [rows, E], or [G, rows, E] for dbs
            eps = pstate.randn(shape, generator, dev, row_axis=len(shape) - 2)
        return eps.to(dev).float() * EVAL_Z_SCALE

    def _decode(self, encoded, decode_method, max_length=None, beam_size=3,
                temp=1.0, eps=None, gumbel=None, generator=None,
                **dbs_kwargs):
        max_length = max_length or self.max_length
        ctx = self._ctx(encoded)
        enc_mem, enc_mask, d_proj = ctx
        N, E, dev = enc_mem.shape[0], self.decoder.embed_size, enc_mem.device
        dt = self.decoder.state_dtype()
        if decode_method == "beam":
            z = self._z(eps, (N * beam_size, E), generator, dev).to(dt)

            def step_fn(state, words, t):
                d = self.decoder.step(words, state, enc_mem, d_proj, enc_mask, z)
                return d["logits"], d["state"]
            cfg = BeamConfig(beam_size=beam_size, max_length=max_length,
                             start_idx=self.start_idx, end_idx=self.end_idx)
            with record_function("decode_loop"):
                return batched_beam_search(
                    step_fn, self.decoder.init_state(N * beam_size, dev, dt),
                    N, cfg)
        if decode_method == "dbs":
            dbs_kwargs.setdefault("group_size", 5)
            cfg = DBSConfig(beam_size=beam_size, max_length=max_length,
                            start_idx=self.start_idx, end_idx=self.end_idx,
                            **dbs_kwargs)
            NB = N * dbs_bdash(beam_size, cfg.group_size)
            zg = self._z(eps, (cfg.group_size, NB, E), generator, dev).to(dt)

            def make_step_fn(g):
                def step_fn(state, words, t):
                    d = self.decoder.step(words, state, enc_mem, d_proj,
                                          enc_mask, zg[g])
                    return d["logits"], d["state"]
                return step_fn
            with record_function("decode_loop"):
                return diverse_beam_search(
                    make_step_fn, lambda: self.decoder.init_state(NB, dev, dt),
                    N, cfg)
        return self._decode_with_z(ctx, self._z(eps, (N, E), generator, dev),
                                   max_length, decode_method, temp,
                                   gumbel=gumbel, generator=generator)

    @grad_optional
    def forced_decode(self, feats, feat_lens, given_seqs: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """Score ``given_seqs`` [N, T] under the global z of the eval prior
        from ``eps`` [N, E] (the rollout's draw)."""
        enc_mem, enc_mask, d_proj = self._ctx(self.encode(feats, feat_lens))
        N, T = given_seqs.shape
        dev = enc_mem.device
        z = self._z(eps, (N, self.decoder.embed_size), generator, dev).to(
            self.decoder.state_dtype())
        h = self.decoder.init_state(N, dev, self.decoder.state_dtype())
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        lps = []
        for t in range(T):
            d = self.decoder.step(word, h, enc_mem, d_proj, enc_mask, z)
            word = given_seqs[:, t].to(dev).long()
            lps.append(forced_logprob(d["logits"], word))
            h = d["state"]
        return {"sampled_logprobs": torch.stack(lps, dim=1), "seqs": given_seqs}
