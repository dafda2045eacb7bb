"""The parallel train step held against the unsplit one: one call on every
rank of a :class:`~acvae_tpu_torch.parallel.pool.RankPool`
(:func:`train_step_case`).

The tests and ``chip_smoke.py`` hold a DP, TP or SP step to the
single-process step on the same weights and draws.  No module of the
package imports this one.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.parallel.mesh import (make_mesh_2d, pad_to_multiple,
                                           shard_batch)


def _cpu(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


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
                    reference: Optional[str] = None,
                    device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """One train step (timed; after ``warmup`` steps from the same state,
    which is then restored) of a rank of the pool's group on a ``(world /
    model_parallel, model_parallel)`` grid, from ``state_dict`` (or the
    file it was saved to) on the global ``batch`` (padded to the data
    ranks here) with its global ``draws``/``noise``.

    Every rank returns its metrics, its step's ms and the ``time_warp_1d``
    launches it made.  Rank 0 also returns, in the unsplit layout, the
    gradients before the optimizer, the weights after the step and
    ``placed`` (the weights as placed, gathered again); or, given the file
    of a ``reference`` (``{"grads": ..., "weights": ...}`` of the unsplit
    step from ``state_dict``), their :func:`errors` against it:
    ``grad_err`` (elementwise at rtol 1e-3 / atol 2e-6),
    ``grad_err_averaged`` (the same for the gradients divided by the ranks
    they are summed over, as a step that averaged them would have them)
    and ``update_err`` (the step's change of every weight against the
    unsplit step's).  ``ratios`` fixes ``ss_ratio``/``dis_ratio``/
    ``kl_weight``."""
    from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d
    from acvae_tpu_torch.train.trainer import Trainer
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location=device,
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
    placed = {k: v.clone() for k, v in par.full_state_dict().items()}
    local = shard_batch(pad_to_multiple(batch, grid.local_data), grid)
    launches = time_warp_1d.launches
    if warmup:   # a copy: on the CPU the state holds the live tensors
        start = copy.deepcopy(trainer.state())
        for _ in range(warmup):
            trainer.step(local, iteration, epoch, draws=draws, noise=noise)
        trainer.load_state(start)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    m = trainer.step(local, iteration, epoch, draws=draws, noise=noise)
    if cuda:
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    split = par.seq_split(batch["feats"].shape[1])
    out = {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
           "launches": time_warp_1d.launches - launches,
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
            {k: weights[k] - placed[k] for k in floats},
            {k: ref["weights"][k] - start[k] for k in floats}, 1e-3, 1e-8)
    elif grid.rank == 0:
        out["grads"] = {k: _cpu(v) for k, v in grads.items()}
        out["weights"] = {k: _cpu(v) for k, v in weights.items()}
        out["placed"] = {k: _cpu(v) for k, v in placed.items()}
    return out
