"""Learning-rate and recipe schedules (counterpart of
``acvae_tpu/train/schedules.py:32-57`` and ``acvae_tpu/train/trainer.py:402-488``).

Schedules map the optimizer step (0 for the first update) to a learning
rate; the reference counts from 1, so ``it = step + 1``.  With gradient
accumulation the step counts applied updates, not micro-batches.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def exponential_decay_schedule(base_lr: float, total_iters: int, final_lr: float,
                               warmup_iters: int = 3000,
                               linear_warmup: bool = False) -> Schedule:
    """``ExponentialDecayScheduler`` (lr_scheduler.py:5-36): warmup
    coefficient × exponential decay from base_lr to final_lr.

    When ``warmup_iters >= total_iters`` the reference formula explodes (the
    exponent turns positive); the warmup then shrinks to 10% of the run, as
    in the JAX package."""
    if warmup_iters >= total_iters:
        warmup_iters = max(1, total_iters // 10)

    def schedule(step: int) -> float:
        it = step + 1
        warmup = min(it / warmup_iters, 1.0)
        decay = math.exp(((it - warmup_iters) / total_iters)
                         * math.log(final_lr / base_lr))
        if linear_warmup and it <= warmup_iters:
            return warmup * base_lr
        return warmup * base_lr * decay
    return schedule


def build_schedule(name: str, base_lr: float, total_iters: int,
                   **kwargs) -> Schedule:
    """The named schedule.  ``ReduceLROnPlateau`` is an epoch scheduler
    stepped with the validation score (``train/optim.py``); under it the
    learning rate is the constant ``base_lr`` (acvae_tpu/cli/main.py:251-252),
    and its ``scheduler_args`` are the plateau's, not the schedule's."""
    if name == "ExponentialDecayScheduler":
        kwargs.setdefault("total_iters", max(1, total_iters))
        return exponential_decay_schedule(base_lr, **kwargs)
    if name in ("constant", "ReduceLROnPlateau"):
        return lambda step: base_lr
    raise NotImplementedError(f"scheduler {name!r} is not ported")


def ss_ratio_at(iteration: int, ss0: float, mode: str, total_iters: int,
                final_ss_ratio: float = 0.7) -> float:
    """Scheduled-sampling ratio after ``iteration`` per-iteration decays
    (pytorch_runner_vae.py:110-116), in closed form."""
    if mode == "exponential":
        return ss0 * 0.01 ** (iteration / total_iters)
    if mode == "linear":
        return ss0 - iteration * (1.0 - final_ss_ratio) / total_iters
    return ss0


def dis_ratio_for_epoch(epoch: int, epochs: int, freeze_epoch: int,
                        final_ratio: float) -> float:
    """Prior-grounding ramp (pytorch_runner_vae.py:118-122): 0 until
    freeze_epoch, then linear to final_ratio."""
    if epoch <= freeze_epoch:
        return 0.0
    return final_ratio * float(epoch - freeze_epoch) / (epochs - freeze_epoch)


def kl_weight_for_epoch(epoch: int, epochs: int, beta: float) -> float:
    """KL annealing (pytorch_runner_vae.py:286): max(0.5, epoch/epochs · β)."""
    return max(0.5, float(epoch) / epochs * beta)


def kl_weight_schedule(epoch: int, epochs: int, beta: float,
                       mode: str = "reference", cycles: int = 4,
                       ramp: float = 0.5, floor: float = 0.0) -> float:
    """The KL weight of ``epoch`` under the ``kl_anneal`` config key:

    * ``reference``: ``max(0.5, epoch/epochs · β)``, the reference's;
    * ``linear``: ``max(floor, epoch/epochs · β)``;
    * ``cyclical``: ``cycles`` equal cycles, each ramping linearly from
      ``floor`` to β over its first ``ramp`` fraction, then holding β;
    * ``constant``: β."""
    if mode == "reference":
        return kl_weight_for_epoch(epoch, epochs, beta)
    if mode == "linear":
        return max(floor, float(epoch) / epochs * beta)
    if mode == "constant":
        return float(beta)
    if mode == "cyclical":
        period = max(1, -(-epochs // max(1, int(cycles))))  # ceil
        tau = ((epoch - 1) % period) / period
        frac = min(1.0, tau / max(ramp, 1e-8))
        return floor + (beta - floor) * frac
    raise ValueError(f"unknown kl_anneal mode {mode!r} "
                     f"(reference|linear|cyclical|constant)")


def parse_kl_anneal(raw) -> dict:
    """The ``kl_anneal`` value checked up front: a mapping over mode,
    cycles, ramp and floor (absent: the reference schedule)."""
    raw = raw or {}
    if not isinstance(raw, dict):
        raise ValueError(
            f"kl_anneal must be a mapping with keys mode/cycles/ramp/floor,"
            f" got {raw!r} — e.g. kl_anneal: {{mode: linear, floor: 0.0}}")
    unknown = set(raw) - {"mode", "cycles", "ramp", "floor"}
    if unknown:
        raise ValueError(f"unknown kl_anneal key(s) {sorted(unknown)}; "
                         f"allowed: mode, cycles, ramp, floor")
    return dict(raw)


def kl_weight_for(anneal: dict, epoch: int, epochs: int, beta: float) -> float:
    """:func:`kl_weight_schedule` with a parsed ``kl_anneal`` mapping's
    values at the JAX CLI's defaults (acvae_tpu/cli/main.py:520-531)."""
    return kl_weight_schedule(epoch, epochs, beta,
                              mode=anneal.get("mode", "reference"),
                              cycles=int(anneal.get("cycles", 4)),
                              ramp=float(anneal.get("ramp", 0.5)),
                              floor=float(anneal.get("floor", 0.0)))
