"""The parallel train step held against the unsplit one: one call on every
rank of a :class:`~acvae_tpu_torch.parallel.pool.RankPool`
(:func:`train_step_case`).

The tests and ``chip_smoke.py`` hold a DP, TP or SP step to the
single-process step on the same weights and draws, and an encoder's split
train forward and backward to its unsplit one (:func:`encoder_split_case`).
No module of the package imports this one.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.collectives import _all_gather
from acvae_tpu_torch.parallel.mesh import (make_mesh_2d, pad_to_multiple,
                                           shard_batch)
from acvae_tpu_torch.parallel.train import sum_partial_grads


@contextlib.contextmanager
def dropout_off(off: bool = True):
    """Every ``F.dropout`` the identity while it is open (the encoders
    that hard-code their rates included), when ``off``."""
    if not off:
        yield
        return
    kept = F.dropout
    F.dropout = lambda x, p=0.5, training=True, inplace=False: x
    try:
        yield
    finally:
        F.dropout = kept


def _cpu(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def state_on_cpu(x):
    """A copy of ``x`` (a tensor, or dicts, lists and tuples of them) with
    every tensor on the CPU: a snapshot that holds no memory of the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: state_on_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(state_on_cpu(v) for v in x)
    return copy.deepcopy(x)


def errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
           rtol: float, atol: float) -> Dict[str, Any]:
    """``got`` against ``want`` (a tensor missing from ``got`` counts as
    zeros): ``worst``, the largest ``|got - want| / (atol + rtol·|want|)``
    (above 1 is outside that tolerance), at tensor ``at``; ``max_abs``; and
    ``rel``, the largest ``‖got - want‖ / ‖want‖`` of a tensor, at
    ``rel_at`` (a zero ``want`` reads 0 if ``got`` is zero too, else
    inf); ``rel_top``, the three largest as (tensor, rel)."""
    out = {"worst": 0.0, "at": None, "max_abs": 0.0, "rel": 0.0, "rel_at": None}
    rels = []
    for k, b in want.items():
        b = b.double()
        a = got[k].double().to(b.device) if k in got else torch.zeros_like(b)
        d = (a - b).abs()
        if not d.numel():
            continue
        r = float((d / (atol + rtol * b.abs())).max())
        if r > out["worst"]:
            out["worst"], out["at"] = r, k
        out["max_abs"] = max(out["max_abs"], float(d.max()))
        nd, nb = float(d.norm()), float(b.norm())
        rel = nd / nb if nb else (0.0 if nd == 0 else float("inf"))
        rels.append((rel, k))
        if rel > out["rel"]:
            out["rel"], out["rel_at"] = rel, k
    out["rel_top"] = [(k, r) for r, k in sorted(rels, reverse=True)[:3]]
    return out


def train_step_case(conf: Dict[str, Any], vocab_size: int, data_dim: int,
                    state_dict, batch: Dict[str, Any], model_parallel: int = 1,
                    seq: bool = False, draws=None, noise=None,
                    iteration: int = 1, epoch: int = 1, total_iters: int = 100,
                    warmup: int = 0, ratios: Optional[Dict[str, float]] = None,
                    reference: Optional[str] = None, dropout: bool = True,
                    bn64: bool = False,
                    device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """One train step (timed; after ``warmup`` steps from the same state,
    which is then restored) of a rank of the pool's group on a ``(world /
    model_parallel, model_parallel)`` grid, from ``state_dict`` (or the
    file it was saved to) on the global ``batch`` (padded to the data
    ranks here) with its global ``draws``/``noise``.

    Every rank returns its metrics, its step's ms, the ``time_warp_1d``
    launches it made and, on a card, ``peak_bytes``: the most memory it
    held in the timed step above what it held on entry (weights, optimizer
    state, gradients and the step's activations; the start weights, the
    copies of the state and ``placed`` are kept on the CPU).  Rank 0 also
    returns, in the unsplit layout, the
    gradients before the optimizer, the weights after the step and
    ``placed`` (the weights as placed, gathered again); or, given the file
    of a ``reference`` (``{"grads": ..., "weights": ...}`` of the unsplit
    step from ``state_dict``), their :func:`errors` against it:
    ``grad_err`` (elementwise at rtol 1e-3 / atol 2e-6),
    ``grad_err_averaged`` (the same for the gradients divided by the ranks
    they are summed over, as a step that averaged them would have them)
    and ``update_err`` (the step's change of every weight against the
    unsplit step's).  ``ratios`` fixes ``ss_ratio``/``dis_ratio``/
    ``kl_weight``; ``dropout=False`` turns every dropout off, ``bn64``
    computes BatchNorm in float64 (:func:`batchnorm_float64`)."""
    from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d
    from acvae_tpu_torch.train.trainer import Trainer
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
    grid = make_mesh_2d(model_parallel)
    grid.seq = seq
    trainer = Trainer(conf, vocab_size, data_dim, device=device,
                      total_iters=total_iters)
    trainer.model.load_state_dict(state_dict, strict=True)
    trainer.distribute(grid)
    if ratios is not None:
        trainer.ratios = lambda it, ep: dict(ratios)
    par = trainer.parallel
    placed = state_on_cpu(par.full_state_dict())
    local = shard_batch(pad_to_multiple(batch, grid.local_data), grid)
    launches = time_warp_1d.launches
    with dropout_off(not dropout), batchnorm_float64(bn64):
        if warmup:
            start = state_on_cpu(trainer.state())
            for _ in range(warmup):
                trainer.step(local, iteration, epoch, draws=draws, noise=noise)
            trainer.load_state(start)
            del start
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        m = trainer.step(local, iteration, epoch, draws=draws, noise=noise)
        if cuda:
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
    split = par.seq_split(batch["feats"].shape[1])
    out = {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
           "launches": time_warp_1d.launches - launches,
           "peak_bytes": (torch.cuda.max_memory_allocated(device) - base
                          if cuda else None),
           "vocab_rows": par.model.decoder.word_embeddings.weight.shape[0],
           "seq_split": split}
    params = dict(trainer.model.named_parameters())
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    for k in par.split_names:
        grads[k] = par._gather(grads[k])
    weights = par.full_state_dict()
    if grid.rank == 0 and reference is not None:
        ref = torch.load(reference, map_location=device, weights_only=True)
        summed_over = {k: grid.world if split and id(params[k]) in par.seq_params
                       else grid.data for k in grads}
        out["grad_err"] = errors(grads, ref["grads"], 1e-3, 2e-6)
        out["grad_err_averaged"] = errors(
            {k: g / summed_over[k] for k, g in grads.items()}, ref["grads"],
            1e-3, 2e-6)
        start = {k: v.to(device) for k, v in state_dict.items()}
        floats = [k for k, v in ref["weights"].items() if v.is_floating_point()]
        out["update_err"] = errors(
            {k: weights[k] - placed[k].to(weights[k].device) for k in floats},
            {k: ref["weights"][k] - start[k] for k in floats}, 1e-3, 1e-8)
    elif grid.rank == 0:
        out["grads"] = {k: _cpu(v) for k, v in grads.items()}
        out["weights"] = {k: _cpu(v) for k, v in weights.items()}
        out["placed"] = placed
    return out


@contextlib.contextmanager
def batchnorm_float64(on: bool = True):
    """Every train-mode BatchNorm's statistics and normalization in float64
    while it is open (in a split step its two sums all-reduced in float64),
    when ``on``: a step without float32 BatchNorm's rounding, which a
    split reorders.  The running statistics update as they do in float32."""
    if not on:
        yield
        return
    import torch.distributed as dist

    from acvae_tpu_torch.models import encoders
    from acvae_tpu_torch.parallel.collectives import all_reduce_sum
    kept = encoders.BatchNorm.forward

    def forward(self, x, train, axis=1, dtype=None):
        if not train:
            return kept(self, x, train, axis, dtype)
        shape = [1] * x.ndim
        shape[axis] = -1
        xd = x.double()
        red = [d for d in range(x.ndim) if d != axis]
        sums = torch.stack([xd.sum(dim=red), (xd * xd).sum(dim=red)])
        count = xd.numel() // xd.shape[axis]
        group = pstate.bn_group()
        if group is not None:
            sums = all_reduce_sum(sums, group)
            count *= dist.get_world_size(group)
        mean = sums[0] / count
        var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.double()
        y = ((xd - mean.view(shape)) * mul.view(shape)
             + self.bias.double().view(shape))
        return y.to(dtype or x.dtype)
    encoders.BatchNorm.forward = forward
    try:
        yield
    finally:
        encoders.BatchNorm.forward = kept


@contextlib.contextmanager
def halo_backward_dropped():
    """A planted fault while it is open: the halo exchange's backward
    returns zeros (the neighbours' edge gradients lost), which a split's
    gradient check must catch."""
    from acvae_tpu_torch.parallel import collectives
    kept = collectives._Halo.backward

    def backward(ctx, g_prev, g_next):
        shape = list(ctx.edge_shape)
        shape[ctx.dim] = ctx.T
        return (torch.zeros(shape, dtype=g_prev.dtype, device=g_prev.device),
                None, None, None, None, None)
    collectives._Halo.backward = staticmethod(backward)
    try:
        yield
    finally:
        collectives._Halo.backward = kept


@contextlib.contextmanager
def kv_gathered_replicated():
    """A planted fault while it is open: the split transformers gather their
    keys and values with ``gather_replicated`` (each frame's gradient only
    from its own rank's queries), which a split's gradient check must
    catch."""
    from acvae_tpu_torch.models import encoders
    from acvae_tpu_torch.parallel.collectives import gather_replicated
    kept = encoders.gather_split
    encoders.gather_split = gather_replicated
    try:
        yield
    finally:
        encoders.gather_split = kept


FAULTS = {"halo_dropped": halo_backward_dropped,
          "kv_replicated": kv_gathered_replicated}


def halo_case(x, prev: int, nxt: int, probe_prev, probe_next,
              model_parallel: int, device: str = DEFAULT_DEVICE
              ) -> Dict[str, Any]:
    """``halo_exchange`` of this rank's slice of the global ``x`` [N, C,
    T, F] (time split over the model ranks of a ``(world /
    model_parallel, model_parallel)`` grid), ``prev`` and ``nxt`` frames
    wide, ``-1`` at the outer edges, and the backward of ``Σ before·
    probe_prev[m] + Σ after·probe_next[m]`` (the probes [model, N, C,
    width, F]).  Returns the model index, the halos and the slice's
    gradient."""
    from acvae_tpu_torch.parallel.collectives import halo_exchange
    grid = make_mesh_2d(model_parallel)
    t = np.shape(x)[2] // grid.model
    xs = torch.as_tensor(np.asarray(x)[:, :, grid.m * t:(grid.m + 1) * t],
                         device=device).requires_grad_(True)
    before, after = halo_exchange(xs, 2, grid.model_group, prev, nxt, -1.0)
    loss = ((before * torch.as_tensor(probe_prev[grid.m], device=device)).sum()
            + (after * torch.as_tensor(probe_next[grid.m], device=device)).sum())
    loss.backward()
    return {"m": grid.m, "before": _cpu(before), "after": _cpu(after),
            "grad": _cpu(xs.grad)}


def encoder_split_case(name: str, args: Dict[str, Any], data_dim: int,
                       state_dict, feats, lens, probe: Dict[str, Any],
                       model_parallel: int = 2, seq: bool = True,
                       fault: Optional[str] = None,
                       device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """The train-mode forward of encoder ``name`` (``build_encoder(name,
    args, data_dim)``, weights ``state_dict``, dropouts off) on a rank of
    a ``(world / model_parallel, model_parallel)`` grid: this rank's rows
    of the global ``feats`` [N, T, F] / ``lens``, and with ``seq`` its slice
    of time where the encoder's ``seq_split_ok`` allows; then the backward
    of ``Σ audio_embeds·probe["embeds"] + Σ audio_embeds_pooled·
    probe["pooled"]`` over its rows, the gradients summed as a train step
    sums them (``sum_partial_grads``).  Rank 0 returns the outputs of every
    row (gathered over the data ranks), the gradients, the state dict after
    the forward (BatchNorm's running statistics) and ``seq_split``.
    ``fault`` plants one of :data:`FAULTS` over the forward and backward."""
    from acvae_tpu_torch.models.encoders import build_encoder
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location=device,
                                weights_only=True)
    grid = make_mesh_2d(model_parallel)
    enc = build_encoder(name, args, data_dim, device=device)
    enc.load_state_dict(state_dict, strict=True)
    T = np.shape(feats)[1]
    split = seq and hasattr(enc, "seq_split_ok") and enc.seq_split_ok(
        T, grid.model)
    local = shard_batch(pad_to_multiple({
        "feats": np.asarray(feats), "lens": np.asarray(lens),
        "embeds": np.asarray(probe["embeds"]),
        "pooled": np.asarray(probe["pooled"])}, grid.local_data), grid)
    x, n = (torch.as_tensor(local[k], device=device) for k in ("feats", "lens"))
    if split:
        t = T // grid.model
        x = x[:, grid.m * t:(grid.m + 1) * t]
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        with pstate.step_context(grid, seq_split=split), dropout_off():
            out = enc(x, n, train=True)
        loss = ((out["audio_embeds"] * torch.as_tensor(local["embeds"],
                                                       device=device)).sum()
                + (out["audio_embeds_pooled"] * torch.as_tensor(
                    local["pooled"], device=device)).sum())
        loss.backward()
    seq_params = {id(p) for p in enc.seq_split_params()} if split else set()
    sum_partial_grads(enc.parameters(), grid, seq_params, split)
    rows = {k: torch.cat(_all_gather(v.detach(), grid.data_group))
            if grid.data > 1 else v.detach() for k, v in out.items()}
    result = {"seq_split": split}
    if grid.rank == 0:
        result["outputs"] = {k: v.cpu() for k, v in rows.items()}
        result["grads"] = {k: p.grad.cpu() for k, p in enc.named_parameters()
                           if p.grad is not None}
        result["state"] = {k: v.detach().cpu()
                           for k, v in enc.state_dict().items()}
    return result
