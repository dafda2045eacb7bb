"""Data-parallel training: the recipe's train step on a grid of data R ×
model 1 (``Trainer.distribute``), one rank a card, R the cell's chips.

Every rank draws the same pool from the seed, each batch the global one of
``batch`` rows a rank (``batch × R`` in all), and feeds the trainer its
rows (``shard_batch``) with the global batch's draws and noise, which the
trainer slices itself.  Rank ``r`` seeds its global generator (the
dropouts') before a checked step with ``rank_seeds(seed, R)[r]``.  The
rest is ``drivers/train.py``'s: ``run.py``'s process is rank 0 and keeps
the window's clock; before each unit it orders the other ranks
(``common.Ranks``) to run theirs, so every unit of the window and the
trace is one step on all R cards.

Correctness: the reference follows the global batch on rank 0's card, its
BatchNorm over all rows, each rank's chunk of rows convolved and dropped
out as that rank did (``reference/train.py``, ``rngs``), so the loss is the
global one and its gradient the sum of the ranks'.  The same six numbers
as ``drivers/train.py``, and ``rank_drift``: the largest relative
difference of any parameter between a rank and rank 0 after the window
and the trace, ‖p_r − p_0‖ / ‖p_0‖ by tensor.  The ranks apply the same
update to the same summed gradient, so it reads 0.  The control is
``drivers/train.py``'s: the decode side's matmul operands in bfloat16.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from portbench import common, faults

train = common.load_module(Path(__file__).resolve().parent / "train.py")
FAULTS = faults.FAULTS["train_dp4"]


def rank_seeds(seed: int, world: int) -> List[int]:
    """The global generator's seed of each rank for a step seeded ``seed``."""
    return [common.seed_of(seed, 1000 + r) for r in range(world)]


class Cell(train.Cell):
    def __init__(self, conf: Dict, mix: Dict, seed: int, device: str = "cuda", *,
                 ranks):
        super().__init__(conf, mix, seed, device)
        self.ranks, self.world = ranks, ranks.world
        self.unit_s: List[float] = []

    # --------------------------------------------------- drivers/train.py's hooks
    def _place(self) -> None:
        from acvae_tpu_torch.parallel.mesh import make_mesh_2d
        self.grid = make_mesh_2d(1)
        self.trainer.distribute(self.grid)

    def _feed(self, batch: Dict) -> Dict:
        from acvae_tpu_torch.parallel.mesh import shard_batch
        return shard_batch(batch, self.grid)

    def _seed_dropout(self, seed: int) -> None:
        super()._seed_dropout(rank_seeds(seed, self.world)[self.ranks.rank])

    # ------------------------------------------------------------- the orders
    def setup(self) -> None:
        if self.ranks.rank == 0:
            self.ranks.order(common.CELL, self.seed)
        super().setup()

    def _advance(self, checked: bool) -> None:
        if self.ranks.rank == 0:
            self.ranks.order(common.UNIT)
        t0 = time.perf_counter()
        super()._advance(checked)
        self.unit_s.append(time.perf_counter() - t0)

    def follow_unit(self) -> None:
        """A follower's unit: the one rank 0 runs (the same window step is
        checked on every rank)."""
        self._advance(self.done - self.mix["checked_steps"] == self.check_at)

    def trace(self, units: int, out_dir):
        if self.ranks.rank == 0:
            self.ranks.order(common.TRACE, units)
        return common.profile_units(lambda i: train.Cell._advance(self, False),
                                    units, out_dir, start=self.ranks.barrier)

    @torch.no_grad()
    def _drift(self) -> float:
        """max over tensors of ‖p_r − p_0‖ / ‖p_0‖, over every rank r."""
        mine = [p.detach().float() for _, p in self.trainer.model.named_parameters()]
        flat = torch.cat([p.reshape(-1) for p in mine])
        dist.broadcast(flat, 0)
        zero = flat.split([p.numel() for p in mine])
        rel = torch.stack([(p.reshape(-1) - z).norm() / torch.clamp_min(z.norm(), 1e-30)
                           for p, z in zip(mine, zero)]).max().reshape(1)
        dist.all_reduce(rel, op=dist.ReduceOp.MAX)
        return float(rel)

    def collect(self) -> Dict:
        if self.ranks.rank == 0:
            self.ranks.order(common.COLLECT)
        drift = self._drift()
        out = super().collect()
        unit_s = float(np.mean(self.unit_s)) if self.unit_s else 0.0
        if self.ranks.rank:
            return {"unit_s": unit_s}
        ms = [1e3 * s for s in [unit_s] + [a["unit_s"] for a in self.ranks.results()]]
        print(f"portbench: window step ms by rank {ms}", file=sys.stderr)
        return dict(out, rank_drift=drift)

    def judge(self, s: Dict, control: bool = False) -> Dict[str, float]:
        def ranked(step):
            return dict(step, rngs=rank_seeds(step["rng"], self.world))
        s = dict(s, steps=[ranked(st) for st in s["steps"]],
                 win=dict(s["win"], step=ranked(s["win"]["step"])))
        # the reference in the program's place has one copy of the weights
        return dict(super().judge(s, control),
                    rank_drift=0.0 if control else s["rank_drift"])
