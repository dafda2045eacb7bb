"""The grid's side of a train step (``Trainer.distribute``).

* Placement: every rank starts from rank 0's weights (:func:`replicate`);
  with ``model`` > 1 the decoder's word embeddings and classifier become
  their vocab shards (``parallel/vocab.py``).
* The step: this rank's rows of the global draws (``parallel/state.py``'s
  :func:`row_shard`), its slice of mel time under sequence parallelism, the
  losses over the global batch (:func:`step_context`).
* The gradients: every rank's loss is its share of the global loss, so the
  gradient of the global loss is the sum over the ranks that hold other
  rows (``data_group``), and over every rank for the parameters the time
  shards compute partial gradients of.  The clip's norm counts each vocab
  shard once.
* Checkpoints keep the unsplit layout: :meth:`Distributed.full_state`
  gathers the vocab shards (and their optimizer moments) on every rank,
  :meth:`Distributed.local_state` slices a full one.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.collectives import _all_gather
from acvae_tpu_torch.parallel.mesh import Grid, replicate, shard_by_vocab
from acvae_tpu_torch.parallel.vocab import split_decoder

VOCAB_LEAVES = ("decoder.word_embeddings.weight", "decoder.classifier.weight",
                "decoder.classifier.bias", "decoder.outputlayer.weight",
                "decoder.outputlayer.bias")


class Distributed:
    """What a :class:`~acvae_tpu_torch.train.trainer.Trainer` does
    differently on ``grid``."""

    def __init__(self, grid: Grid, model: torch.nn.Module, vocab_size: int):
        self.grid, self.vocab_size = grid, vocab_size
        replicate(model)
        self.vocab_split = grid.model > 1
        self.split_names: List[str] = []
        if self.vocab_split:
            split_decoder(model.decoder, grid, vocab_size)
            names = dict(model.named_parameters())
            self.split_names = [k for k in VOCAB_LEAVES if k in names]
        enc = model.encoder
        self.seq_params = ({id(p) for p in enc.seq_split_params()}
                           if grid.seq and hasattr(enc, "seq_split_ok") else set())
        self.model = model

    # ------------------------------------------------------------ the step
    def seq_split(self, T: int) -> bool:
        """Whether this batch's mel time splits (else the encoder runs on
        the whole of it on every rank of the model axis)."""
        return bool(self.seq_params) and self.model.encoder.seq_split_ok(
            T, self.grid.model)

    def time_slice(self, feats: torch.Tensor) -> torch.Tensor:
        t = feats.shape[1] // self.grid.model
        return feats[:, self.grid.m * t:(self.grid.m + 1) * t]

    @contextlib.contextmanager
    def step(self, n_local: int, seq_split: bool):
        """The context of one step on ``n_local`` rows of the global batch."""
        g = self.grid
        with pstate.row_shard(n_local, n_local * g.data, g.d * n_local), \
                pstate.step_context(g, seq_split=seq_split,
                                    vocab_logits=self.vocab_split):
            yield

    def sync_grads(self, seq_split: bool) -> None:
        sum_partial_grads(self.model.parameters(), self.grid, self.seq_params,
                          seq_split)

    def split_params(self) -> List[torch.nn.Parameter]:
        names = dict(self.model.named_parameters())
        return [names[k] for k in self.split_names]

    # -------------------------------------------------------- checkpoints
    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(_all_gather(t.contiguous(), self.grid.model_group), 0)

    def full_state(self, state: Dict[str, Any], trainable: List[torch.Tensor]
                   ) -> Dict[str, Any]:
        """A trainer state (``Trainer.state``'s layout) with the vocab
        shards gathered; every rank of the model axis must call it."""
        if not self.vocab_split:
            return state
        dev = next(self.model.parameters()).device
        sd = dict(state["state_dict"])
        for k in self.split_names:
            sd[k] = self._gather(sd[k].to(dev)).cpu()
        opt = dict(state["optimizer"])
        ids = {id(p) for p in self.split_params()}
        opt["state"] = {i: ({k: self._gather(v.to(dev)).cpu() for k, v in st.items()}
                            if id(trainable[i]) in ids else st)
                        for i, st in opt["state"].items()}
        return dict(state, state_dict=sd, optimizer=opt)

    def local_state(self, state: Dict[str, Any], trainable: List[torch.Tensor]
                    ) -> Dict[str, Any]:
        """A full trainer state sliced to this rank's vocab shards."""
        if not self.vocab_split:
            return state
        V = self.vocab_size
        sd = shard_by_vocab(state["state_dict"], self.grid, V, self.split_names)
        opt = dict(state["optimizer"])
        ids = {id(p) for p in self.split_params()}
        opt["state"] = {i: (shard_by_vocab(st, self.grid, V)
                            if id(trainable[i]) in ids else st)
                        for i, st in opt["state"].items()}
        return dict(state, state_dict=sd, optimizer=opt)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's unsplit ``state_dict`` (on this rank's device)."""
        sd = dict(self.model.state_dict())
        for k in self.split_names:
            sd[k] = self._gather(sd[k])
        return sd


@torch.no_grad()
def sum_partial_grads(params, grid: Grid, seq_params, seq_split: bool) -> None:
    """Sum the gradients of ``params`` over the ranks they are partial on:
    the ranks of other rows, and every rank for the parameters (ids in
    ``seq_params``) the time shards of a split step compute parts of; one
    all-reduce a group, the grads flattened."""
    by_group: Dict[Any, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is None:
            continue
        group = (grid.world_group if seq_split and id(p) in seq_params
                 else grid.data_group)
        size = grid.world if group is grid.world_group else grid.data
        if size > 1:
            by_group.setdefault(group, []).append(p.grad)
    for group, grads in by_group.items():
        flat = torch.cat([t.reshape(-1).float() for t in grads])
        dist.all_reduce(flat, group=group)
        i = 0
        for t in grads:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def eval_model(trainer, cache: dict):
    """The unsplit model to validate with: ``trainer.model`` itself unless
    its vocab is split, else a plain copy (built once into ``cache``)
    loaded with the gathered weights; every rank must call it."""
    par = trainer.parallel
    if par is None or not par.vocab_split:
        return trainer.model
    if "model" not in cache:
        from acvae_tpu_torch.models.build import build_model
        cache["model"] = build_model(trainer.conf, par.vocab_size,
                                     trainer.data_dim, device=trainer.device)
    cache["model"].load_state_dict(par.full_state_dict(), strict=True)
    return cache["model"]
