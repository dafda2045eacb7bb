"""The plain (non-VAE) captioners (counterpart of
``acvae_tpu/models/captioner.py:31-436``).

* :class:`AttnCaptionModel` — ``Seq2SeqAttnModel`` (attn_model.py:49-126):
  an attention RNN decoder, trained stepwise with scheduled sampling (coins
  ``ss_coins`` [T] as tensors), decoded greedy / sampled, by the
  word_model-flavour beam (row 0 first, end handling; word_model.py:209-256)
  and by DBS, and stepped from outside by the ensemble (``decode_ctx``,
  ``init_decode_state``, ``decode_step_api``).
* :class:`TransformerCaptionModel` — ``TransformerModel``: one causal pass
  over the teacher-forced caption at train (``ss_ratio`` does not apply);
  each decode step runs the decoder over a fixed-size prefix buffer whose
  positions past the current one count as padding, and reads the logits at
  the current one (O(T²) work, as the JAX package computes it).  It has no
  step-decode API, so the ensemble refuses it, as the JAX service does.

Neither draws noise at inference except the Gumbel draws of ``gumbel`` /
``sample`` (``gumbel`` [T, N, V], or from ``generator``).
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
                                           forced_logprob, stack_steps)
from acvae_tpu_torch.models.encoders import _dense
from acvae_tpu_torch.ops.masked import length_mask, mean_with_lens
from acvae_tpu_torch.train.profiling import mark_backward


def _dbs_config(max_length, beam_size, model, **dbs_kwargs) -> DBSConfig:
    dbs_kwargs.setdefault("group_size", 5)
    return DBSConfig(beam_size=beam_size, max_length=max_length,
                     start_idx=model.start_idx, end_idx=model.end_idx,
                     **dbs_kwargs)


class _PlainCaptioner(CaptionModel):
    """Inference dispatch shared by the two captioners."""

    @torch.inference_mode()
    def inference_forward(self, feats, feat_lens, decode_method: str = "greedy",
                          max_length: Optional[int] = None, beam_size: int = 3,
                          temp: float = 1.0, gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          eps=None, **dbs_kwargs) -> Dict[str, Any]:
        """``eps`` is accepted and unused: these decoders draw no prior."""
        check_decode_method(type(self).__name__, decode_method)
        with record_function("encoder"):
            encoded = self.encode(feats, feat_lens, train=False)
        return self._decode(encoded, decode_method, max_length, beam_size,
                            temp, gumbel, generator, **dbs_kwargs)

    def _decode(self, encoded, decode_method, max_length=None, beam_size=3,
                temp=1.0, gumbel=None, generator=None, **dbs_kwargs):
        max_length = max_length or self.max_length
        with record_function("decode_loop"):
            if decode_method == "beam":
                return self.beam_search(encoded, max_length, beam_size)
            if decode_method == "dbs":
                return self.diverse_beam_search(encoded, max_length, beam_size,
                                                **dbs_kwargs)
            return self.stepwise_decode(encoded, decode_method, max_length,
                                        temp, gumbel, generator)


class AttnCaptionModel(_PlainCaptioner):
    """``seq_output_size`` adds the CaptionSentenceModel head
    (word_model.py:409-438): the train forward also returns ``seq_outputs``,
    the length-mean of the decoder outputs, projected by
    ``output_transform`` (flax's kaiming-uniform Dense) where the size
    differs from the decoder's ``hidden_size``."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 max_length: int = MAX_LENGTH,
                 seq_output_size: Optional[int] = None, device=None):
        super().__init__(encoder, decoder, max_length, device)
        self.seq_output_size = seq_output_size
        self.output_transform = None
        if seq_output_size is not None and seq_output_size != decoder.hidden_size:
            self.output_transform = _dense(decoder.hidden_size, seq_output_size,
                                           "kaiming_uniform", device)

    def _ctx(self, encoded):
        enc_mem = encoded["audio_embeds"].to(self.decoder.state_dtype())
        enc_mask = length_mask(encoded["audio_embeds_lens"], enc_mem.shape[1])
        return enc_mem, enc_mask, self.decoder.project_enc(enc_mem)

    def _step(self, ctx, state, words, train=False):
        enc_mem, enc_mask, d_proj = ctx
        return self.decoder.step(words, state, enc_mem, d_proj, enc_mask,
                                 train=train)

    def train_forward(self, feats, feat_lens, caps, cap_lens,
                      ss_ratio: float = 1.0, dis_ratio: float = 0.0,
                      train: bool = True, noise: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """Stepwise teacher forcing; the teacher word where ``ss_coins``
        [T] (from ``noise``, else drawn) holds, else the previous greedy
        word.  ``dis_ratio`` does not apply (no prior)."""
        N, L = caps.shape
        dev = caps.device
        with record_function("encoder"):
            ctx = mark_backward("encoder", self._ctx(
                self.encode(feats, feat_lens, train)))
        ss_coins = (noise or {}).get("ss_coins")
        if ss_coins is None:
            ss_coins = torch.rand((L - 1,), generator=generator, device=dev) < ss_ratio
        ss_coins = ss_coins.to(dev)
        h = self.init_decode_state(N, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        ys = {k: [] for k in ("logits", "output", "seqs")}
        with record_function("decode_loop"):
            for t in range(L - 1):
                word = torch.where(ss_coins[t], caps[:, t].long(), word)
                d = self._step(ctx, h, word, train)
                h, word = d["state"], sample_next_word(d["logits"], "greedy")[0]
                for k, v in (("logits", d["logits"]), ("output", d["output"]),
                             ("seqs", word)):
                    ys[k].append(v)
            out = mark_backward("decode_loop", stack_steps(ys))
        if self.seq_output_size is not None:
            # CaptionSentenceModel.train_process (word_model.py:421-427)
            seq = mean_with_lens(out["output"], cap_lens - 1)
            if self.output_transform is not None:
                seq = self.output_transform(seq)
            out["seq_outputs"] = seq
        return out

    def stepwise_decode(self, encoded, method: str, max_length: int,
                        temp: float = 1.0, gumbel=None, generator=None):
        ctx = self._ctx(encoded)
        N, dev = ctx[0].shape[0], ctx[0].device
        h = self.init_decode_state(N, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)
        ys = {k: [] for k in ("logits", "output", "seqs", "sampled_logprobs")}
        for t in range(max_length):
            d = self._step(ctx, h, word)
            w_t, lp_t = sample_next_word(
                d["logits"], method, temp,
                gumbel=None if gumbel is None else gumbel[t], generator=generator)
            word = torch.where(finished, self.end_idx, w_t)
            finished = finished | (word == self.end_idx)
            h = d["state"]
            for k, v in (("logits", d["logits"]), ("output", d["output"]),
                         ("seqs", word), ("sampled_logprobs", lp_t)):
                ys[k].append(v)
        return stack_steps(ys)

    @grad_optional
    def forced_decode(self, feats, feat_lens, given_seqs: torch.Tensor, **_
                      ) -> Dict[str, Any]:
        """The log-probabilities of ``given_seqs`` [N, T] fed as the words."""
        ctx = self._ctx(self.encode(feats, feat_lens))
        N, T = given_seqs.shape
        dev = ctx[0].device
        h = self.init_decode_state(N, dev)
        word = torch.full((N,), self.start_idx, dtype=torch.long, device=dev)
        lps = []
        for t in range(T):
            d = self._step(ctx, h, word)
            word = given_seqs[:, t].to(dev).long()
            lps.append(forced_logprob(d["logits"], word))
            h = d["state"]
        return {"sampled_logprobs": torch.stack(lps, dim=1), "seqs": given_seqs}

    # the ensemble's step-decode API
    def decode_ctx(self, encoded):
        return self._ctx(encoded)

    def init_decode_state(self, batch: int, device=None):
        return self.decoder.init_state(batch, device, self.decoder.state_dtype())

    def decode_step_api(self, ctx, state, words, eps_t=None):
        """One decode step driven from outside: (logits, new state)."""
        d = self._step(ctx, state, words)
        return d["logits"], d["state"]

    def beam_search(self, encoded, max_length: int, beam_size: int):
        """word_model-flavour beam: row 0 first, end handling."""
        ctx = self._ctx(encoded)
        N, dev = ctx[0].shape[0], ctx[0].device
        cfg = BeamConfig(beam_size=beam_size, max_length=max_length,
                         start_idx=self.start_idx, end_idx=self.end_idx,
                         first_step_row0=True, end_handling=True)
        return batched_beam_search(
            lambda state, words, t: self.decode_step_api(ctx, state, words),
            self.init_decode_state(N * beam_size, dev), N, cfg)

    def diverse_beam_search(self, encoded, max_length: int, beam_size: int,
                            **dbs_kwargs):
        ctx = self._ctx(encoded)
        N, dev = ctx[0].shape[0], ctx[0].device
        cfg = _dbs_config(max_length, beam_size, self, **dbs_kwargs)
        NB = N * dbs_bdash(beam_size, cfg.group_size)
        return diverse_beam_search(
            lambda g: lambda state, words, t: self.decode_step_api(ctx, state,
                                                                   words),
            lambda: self.init_decode_state(NB, dev), N, cfg)


class TransformerCaptionModel(_PlainCaptioner):
    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 max_length: int = MAX_LENGTH, device=None):
        super().__init__(encoder, decoder, max_length, device)

    def _mem(self, encoded):
        return (encoded["audio_embeds"].to(self.decoder.state_dtype()),
                encoded["audio_embeds_lens"])

    def train_forward(self, feats, feat_lens, caps, cap_lens,
                      ss_ratio: float = 1.0, dis_ratio: float = 0.0,
                      train: bool = True, noise: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
        """One causal pass: input caps[:, :-1], logits for caps[:, 1:]; the
        ratios and the noise do not apply."""
        with record_function("encoder"):
            encoded = mark_backward("encoder",
                                    self.encode(feats, feat_lens, train))
        words = caps[:, :-1].long()
        pad = ~length_mask(cap_lens - 1, words.shape[1])        # True = padded
        with record_function("decode_loop"):
            out = self.decoder(words, *self._mem(encoded), pad, train=train)
            return mark_backward("decode_loop", {"logits": out["logits"],
                                                 "output": out["output"]})

    def _prefix_logits(self, words_buf, t: int, mem):
        """The decoder over the prefix buffer [N, P], positions past ``t``
        counted as padding: (logits, output) at position t."""
        pad = (torch.arange(words_buf.shape[1], device=words_buf.device)
               > t)[None].expand(words_buf.shape)
        out = self.decoder(words_buf, *mem, pad, at=t)
        return out["logits"], out["output"]

    @grad_optional
    def forced_decode(self, feats, feat_lens, given_seqs: torch.Tensor, **_
                      ) -> Dict[str, Any]:
        """One causal pass over [<start>, given[:-1]] scoring ``given_seqs``
        at every position (the causal mask already hides the future, so
        this equals the stepwise rollout's logits)."""
        mem = self._mem(self.encode(feats, feat_lens))
        N = given_seqs.shape[0]
        dev = mem[0].device
        given = given_seqs.to(dev).long()
        words = torch.cat([torch.full((N, 1), self.start_idx, dtype=torch.long,
                                      device=dev), given[:, :-1]], dim=1)
        out = self.decoder(words, *mem, torch.zeros_like(words, dtype=torch.bool))
        lp = torch.log_softmax(out["logits"].float(), dim=-1)
        return {"sampled_logprobs": torch.gather(lp, -1, given[..., None])[..., 0],
                "seqs": given_seqs}

    def stepwise_decode(self, encoded, method: str, max_length: int,
                        temp: float = 1.0, gumbel=None, generator=None):
        mem = self._mem(encoded)
        N, dev = mem[0].shape[0], mem[0].device
        words_buf = torch.full((N, max_length + 1), self.start_idx,
                               dtype=torch.long, device=dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)
        ys = {k: [] for k in ("logits", "output", "seqs", "sampled_logprobs")}
        for t in range(max_length):
            logits, out = self._prefix_logits(words_buf, t, mem)
            w_t, lp_t = sample_next_word(
                logits, method, temp,
                gumbel=None if gumbel is None else gumbel[t], generator=generator)
            w_t = torch.where(finished, self.end_idx, w_t)
            finished = finished | (w_t == self.end_idx)
            words_buf[:, t + 1] = w_t
            for k, v in (("logits", logits), ("output", out), ("seqs", w_t),
                         ("sampled_logprobs", lp_t)):
                ys[k].append(v)
        return stack_steps(ys)

    def _buffer_step(self, mem, local):
        """A beam step over the prefix buffer: the words go in at the
        position ``local(t)`` and the logits come from there."""
        def step_fn(words_buf, words, t):
            pos = local(t)
            words_buf = words_buf.clone()
            words_buf[:, pos] = words
            return self._prefix_logits(words_buf, pos, mem)[0], words_buf
        return step_fn

    def _repeated(self, encoded, rows: int):
        return tuple(m.repeat_interleave(rows, dim=0) for m in self._mem(encoded))

    def beam_search(self, encoded, max_length: int, beam_size: int):
        """Row 0 first, end handling; the beam gathers permute whole prefix
        buffers; the memory is repeated a beam."""
        mem = self._repeated(encoded, beam_size)
        N, dev = encoded["audio_embeds"].shape[0], mem[0].device
        cfg = BeamConfig(beam_size=beam_size, max_length=max_length,
                         start_idx=self.start_idx, end_idx=self.end_idx,
                         first_step_row0=True, end_handling=True)
        init = torch.full((N * beam_size, max_length + 1), self.start_idx,
                          dtype=torch.long, device=dev)
        return batched_beam_search(
            self._buffer_step(mem, lambda t: t), init, N, cfg)

    def diverse_beam_search(self, encoded, max_length: int, beam_size: int,
                            **dbs_kwargs):
        """Group g at global step t decodes its local position t - g."""
        N = encoded["audio_embeds"].shape[0]
        cfg = _dbs_config(max_length, beam_size, self, **dbs_kwargs)
        NB = N * dbs_bdash(beam_size, cfg.group_size)
        mem = self._repeated(encoded, NB // N)
        return diverse_beam_search(
            lambda g: self._buffer_step(mem, lambda t: t - g),
            lambda: torch.full((NB, max_length + 1), self.start_idx,
                               dtype=torch.long, device=mem[0].device),
            N, cfg)
