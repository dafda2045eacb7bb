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
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from acvae_tpu_torch import START_IDX
from acvae_tpu_torch.models.common import eps_stack, greedy
from acvae_tpu_torch.ops.masked import length_mask, max_with_lens, mean_with_lens


class VAECaptionModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, qnet: nn.Module,
                 pnet: nn.Module, global_constraint: bool = True, device=None):
        super().__init__()
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
                w_t, _ = greedy(d["logits"])
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
