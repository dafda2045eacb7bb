"""Faults planted in the port's timed path, for the checks that must
catch them: the CPU tests (``tests/test_portbench_faults.py``) and, on the
card, ``readings.py --fault``, which reads a cell's numbers under each.
Each takes ``setattr`` (``monkeypatch.setattr`` in a test).

Each driver declares the faults of its own timed path: its module exports
``FAULTS``, a dict from a fault's name to its planter, and :func:`table`
finds it from the driver's file (``drivers/<the mix's driver>.py``).  The
tables below are what the drivers of this directory draw from; a driver
of another model builds its own, from :data:`SERVING` (the faults every
beam-served model shares) and a ``state_unchanged`` that breaks its own
decoder's step.  A driver that declares no table has none: no table falls
back to another model's.  The faults of :data:`FAULTS` ``["ranks"]``
reach every driver by name.

* ``state_unchanged``: a step returns its state unchanged (the decoder's
  step keeps its input state; the optimizer applies no update);
* ``half_batch``: half of the batch left out (the second half's encodings
  are copies of the first's; the losses' means are over the first half);
* ``token_altered``: a token altered where it is produced (the beam's top-k
  words, the train loop's fed-back argmax words, each moved by one);
* ``rows_altered`` (serving): the beam's top-k words moved by one in the
  last twelfth of the batch's clips only (42 of 512: 126 of 1,536 beam
  rows), as a fault confined to one tile of rows would.

Data-parallel training (``train_dp4``) has the train faults and three
more:

* ``exchange_left_out``: the last rank keeps its own gradients; it joins
  the gradients' all-reduce (so no rank waits on it) but drops the sum;
* ``local_count``: the losses divide by this rank's count of tokens and
  rows, not the global batch's;
* ``bn_sync_left_out``: BatchNorm normalizes with each rank's own rows'
  statistics (no group to sum them over); the gradients are still summed.

``ranks``: a rank that fails in the window (the last rank's second window
step): ``rank_raises``, ``rank_killed`` (SIGKILL), ``rank_hangs``.  The run
must end with no result within the ranks' timeout.
"""
from __future__ import annotations

import os
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from portbench import common


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


def _dp_exchange_left_out(setattr):
    from acvae_tpu_torch.parallel import train as ptrain
    real = ptrain.Distributed.sync_grads

    def sync_grads(self, seq_split):
        if self.grid.rank != self.grid.world - 1:
            return real(self, seq_split)
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        own = [g.clone() for g in grads]
        real(self, seq_split)
        for g, o in zip(grads, own):
            g.copy_(o)
    setattr(ptrain.Distributed, "sync_grads", sync_grads)


def _dp_local_count(setattr):
    from acvae_tpu_torch.parallel import state
    setattr(state, "global_count", lambda x: x.sum())
    setattr(state, "batch_mean", lambda values: values.mean())


def _dp_bn_sync_left_out(setattr):
    from acvae_tpu_torch.parallel import state
    setattr(state, "bn_group", lambda: None)


def _rank_fails(how):
    def plant(setattr):
        from acvae_tpu_torch.train import trainer
        real = trainer.Trainer.step
        calls = [0]

        def step(self, *a, **k):
            calls[0] += 1
            g = self.parallel.grid if self.parallel else None
            if calls[0] == 5 and g is not None and g.rank == g.world - 1:
                if how == "raises":
                    raise RuntimeError("planted: this rank fails")
                if how == "killed":
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(3600)
            return real(self, *a, **k)
        setattr(trainer.Trainer, "step", step)
    return plant


SERVING = {"half_batch": _serve_half_batch,
           "token_altered": _serve_token_altered,
           "rows_altered": _serve_rows_altered}
FAULTS = {"serve": {"state_unchanged": _serve_state_unchanged, **SERVING},
          "train": {"state_unchanged": _train_state_unchanged,
                    "half_batch": _train_half_batch,
                    "token_altered": _train_token_altered}}
FAULTS["train_dp4"] = dict(FAULTS["train"], exchange_left_out=_dp_exchange_left_out,
                           local_count=_dp_local_count,
                           bn_sync_left_out=_dp_bn_sync_left_out)
FAULTS["ranks"] = {f"rank_{how}": _rank_fails(how)
                   for how in ("raises", "killed", "hangs")}


def table(driver, fault: Optional[str] = None) -> Dict[str, Callable]:
    """The planters of the driver whose file is ``driver``: the ``FAULTS``
    its module declares; for a ``fault`` of the ``ranks`` table that the
    driver does not declare, that table."""
    path = Path(driver)
    own = getattr(common.load_module(path), "FAULTS", None)
    if own is None:
        raise KeyError(f"the driver {path.stem!r} declares no FAULTS")
    if fault is None or fault in own:
        return own
    if fault in FAULTS["ranks"]:
        return FAULTS["ranks"]
    raise KeyError(f"the driver {path.stem!r} has no fault {fault!r}; "
                   f"it has {sorted(own)} and {sorted(FAULTS['ranks'])}")


def plant(driver, fault: str, setattr) -> None:
    """Plant ``fault`` of ``driver``'s table (:func:`table`)."""
    table(driver, fault)[fault](setattr)
