"""The stand-alone global sentence VAE (counterpart of
``acvae_tpu/models/global_vae.py``).

q(z | sentence): embedding -> BiGRU -> mean+max over the length ->
``context_to_mu`` / ``context_to_logvar``; a GRU decoder from
``h0 = tanh(z_to_state(z))`` whose every input is ``[emb(word); z]``, with
word dropout to ``<unk>`` on the teacher-forced inputs (ids below 4 are
never dropped); a standard N(0, 1) prior.  Pretrained on the caption corpus
by ``cli global_vae``; its weights warm-start a captioner through
``pretrained_global``.  Every draw is an input tensor: ``eps`` [N, E] and
the dropout ``coins`` [N, T] of the train forward, ``z`` [N, E] and the
Gumbel noise [T, N, V] of :meth:`GlobalSentenceVAE.inference`, each drawn
from ``generator`` when it is not given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from acvae_tpu_torch import END_IDX, MAX_LENGTH, START_IDX, UNK_IDX
from acvae_tpu_torch.decoding.sampling import sample_next_word
from acvae_tpu_torch.models.encoders import _dense
from acvae_tpu_torch.models.rnn import GRU, GRUCell
from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens


class GlobalSentenceVAE(nn.Module):
    start_idx, end_idx, unk_idx = START_IDX, END_IDX, UNK_IDX

    def __init__(self, vocab_size: int, word_dim: int = 512,
                 hidden_size: int = 512, latent_size: int = 512,
                 word_dropout: float = 0.3, device=None):
        super().__init__()
        self.latent_size, self.word_dropout = latent_size, word_dropout
        # torch's N(0, 1) init is flax nn.Embed's normal(1.0)
        self.word_embedding = nn.Embedding(vocab_size, word_dim, device=device)
        self.encoder_rnn = GRU(word_dim, hidden_size, bidirectional=True,
                               device=device)
        self.context_to_mu = _dense(2 * hidden_size, latent_size,
                                    "xavier_uniform", device)
        self.context_to_logvar = _dense(2 * hidden_size, latent_size,
                                        "xavier_uniform", device)
        self.z_to_state = _dense(latent_size, hidden_size, "xavier_uniform",
                                 device)
        self.decoder_cell = GRUCell(word_dim + latent_size, hidden_size,
                                    device=device)
        self.outputlayer = _dense(hidden_size, vocab_size, "kaiming_uniform",
                                  device)

    def encode(self, caps: torch.Tensor, cap_lens: torch.Tensor,
               eps: torch.Tensor):
        """(mu, logvar, z = mu + eps·exp(logvar/2))."""
        hidden, _ = self.encoder_rnn(self.word_embedding(caps.long()), cap_lens)
        context = mean_with_lens(hidden, cap_lens) + max_with_lens(hidden, cap_lens)
        mu = self.context_to_mu(context)
        logvar = self.context_to_logvar(context)
        return mu, logvar, mu + eps * torch.exp(0.5 * logvar)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor,
                train: bool = True, eps: Optional[torch.Tensor] = None,
                coins: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The teacher-forced reconstruction: ``logits`` [N, L-1, V],
        ``mu``, ``logvar``, ``z``.  With ``train``, an input word where
        ``coins`` [N, L-1] holds (``rand < word_dropout``) becomes
        ``<unk>``."""
        N, L = caps.shape
        T, dev = L - 1, caps.device
        if eps is None:
            eps = torch.randn((N, self.latent_size), generator=generator,
                              device=dev)
        mu, logvar, z = self.encode(caps, cap_lens, eps.to(dev))
        words_in = caps[:, :T].long()
        if train and self.word_dropout > 0:
            if coins is None:
                coins = torch.rand((N, T), generator=generator,
                                   device=dev) < self.word_dropout
            words_in = torch.where(coins.to(dev) & (words_in >= 4),
                                   self.unk_idx, words_in)
        emb = self.word_embedding(words_in)
        cell = self.decoder_cell
        gi = nn.functional.linear(
            torch.cat([emb, z[:, None, :].expand(N, T, self.latent_size)], -1),
            cell.weight_ih, cell.bias_ih)
        h = torch.tanh(self.z_to_state(z))
        outs = []
        for t in range(T):
            h = cell.recur(gi[:, t], h)
            outs.append(h)
        return {"logits": self.outputlayer(torch.stack(outs, dim=1)),
                "mu": mu, "logvar": logvar, "z": z}

    @torch.no_grad()
    def inference(self, batch: int, max_length: Optional[int] = None,
                  decode_method: str = "sample", temp: float = 1.0,
                  z: Optional[torch.Tensor] = None,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """Decode ``batch`` sentences from z ~ N(0, 1): ``seqs`` [N, T] and
        ``logits`` [N, T, V]; a finished row stays at ``<end>``."""
        T = max_length or MAX_LENGTH
        dev = self.z_to_state.weight.device
        if z is None:
            z = torch.randn((batch, self.latent_size), generator=generator,
                            device=dev)
        z = z.to(dev)
        h = torch.tanh(self.z_to_state(z))
        word = torch.full((batch,), self.start_idx, dtype=torch.long, device=dev)
        finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
        seqs, logits = [], []
        for t in range(T):
            h = self.decoder_cell(torch.cat([self.word_embedding(word), z], -1), h)
            lg = self.outputlayer(h)
            w_t, _ = sample_next_word(lg, decode_method, temp,
                                      gumbel=None if gumbel is None else gumbel[t],
                                      generator=generator)
            word = torch.where(finished, self.end_idx, w_t)
            finished = finished | (word == self.end_idx)
            seqs.append(word)
            logits.append(lg)
        return {"seqs": torch.stack(seqs, 1), "logits": torch.stack(logits, 1)}
