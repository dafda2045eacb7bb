"""Faults planted in the port's timed path, for the checks that must
catch them: the CPU tests (``tests/test_portbench_faults.py``) and, on the
card, ``readings.py --fault``, which reads the training cell's numbers
under each.  Each takes ``setattr`` (``monkeypatch.setattr`` in a test).

* ``state_unchanged``: a step returns its state unchanged (the decoder's
  step keeps its input state; the optimizer applies no update);
* ``half_batch``: half of the batch left out (the second half's encodings
  are copies of the first's; the losses' means are over the first half);
* ``token_altered``: a token altered where it is produced (the beam's top-k
  words, the train loop's fed-back argmax words, each moved by one);
* ``rows_altered`` (serving): the beam's top-k words moved by one in the
  last twelfth of the batch's clips only (42 of 512: 126 of 1,536 beam
  rows), as a fault confined to one tile of rows would.
"""
from __future__ import annotations

import torch


def _serve_state_unchanged(setattr):
    from acvae_tpu_torch.models import decoders
    real = decoders.VAERNNBahdanauAttnDecoder.step

    def step(self, word, state, *a, **k):
        return dict(real(self, word, state, *a, **k), state=state)
    setattr(decoders.VAERNNBahdanauAttnDecoder, "step", step)


def _serve_half_batch(setattr):
    from acvae_tpu_torch.models import common as mc
    real = mc.CaptionModel.apply_ln

    def apply_ln(self, encoded):
        out = real(self, encoded)
        e = out["audio_embeds"]
        h = e.shape[0] - e.shape[0] // 2
        return dict(out, audio_embeds=torch.cat([e[:h], e[:e.shape[0] - h]]))
    setattr(mc.CaptionModel, "apply_ln", apply_ln)


def _serve_token_altered(setattr):
    from acvae_tpu_torch.decoding import beam
    real = beam.beam_topk

    def beam_topk(total, k):
        s, idx = real(total, k)
        return s, (idx + 1) % (total.shape[1] * total.shape[2])
    setattr(beam, "beam_topk", beam_topk)


def _serve_rows_altered(setattr):
    from acvae_tpu_torch.decoding import beam
    real = beam.beam_topk

    def beam_topk(total, k):
        s, idx = real(total, k)
        n = max(1, total.shape[0] // 12)
        idx = idx.clone()
        idx[-n:] = (idx[-n:] + 1) % (total.shape[1] * total.shape[2])
        return s, idx
    setattr(beam, "beam_topk", beam_topk)


def _train_state_unchanged(setattr):
    from acvae_tpu_torch.train import optim
    setattr(optim.OptaxChain, "_apply", lambda self, grads: None)


def _train_half_batch(setattr):
    from acvae_tpu_torch.ops import losses
    real = losses._masked_mean

    def masked_mean(values, mask):
        if mask is not None:
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
        return real(values, mask)
    setattr(losses, "_masked_mean", masked_mean)


def _train_token_altered(setattr):
    from acvae_tpu_torch.models import vae
    real = vae.sample_next_word

    def sample_next_word(logits, *a, **k):
        w, lp = real(logits, *a, **k)
        return (w + 1) % logits.shape[-1], lp
    setattr(vae, "sample_next_word", sample_next_word)


FAULTS = {"serve": {"state_unchanged": _serve_state_unchanged,
                    "half_batch": _serve_half_batch,
                    "token_altered": _serve_token_altered,
                    "rows_altered": _serve_rows_altered},
          "train": {"state_unchanged": _train_state_unchanged,
                    "half_batch": _train_half_batch,
                    "token_altered": _train_token_altered}}
