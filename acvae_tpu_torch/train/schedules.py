"""Learning-rate and recipe schedules (counterpart of
``acvae_tpu/train/schedules.py:31-97`` and ``acvae_tpu/train/trainer.py:402-488``).

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


def noam_schedule(base_lr: float, model_size: int = 512,
                  warmup_iters: int = 3000) -> Schedule:
    """``NoamScheduler`` (lr_scheduler.py:39-56): inverse-square-root decay
    after a linear warmup, scaled so that the peak is ``base_lr``."""
    factor = base_lr / (model_size ** -0.5 * warmup_iters ** -0.5)

    def schedule(step: int) -> float:
        it = step + 1.0
        return factor * model_size ** -0.5 * min(it ** -0.5,
                                                 it * warmup_iters ** -1.5)
    return schedule


def warmup_linear_schedule(base_lr: float, warmup_steps: int, gamma: float,
                           update_epoch: int) -> Schedule:
    """``WarmupLinearSchedule`` (lr_scheduler.py:58-85): a linear warmup,
    then ``base_lr`` times ``gamma`` once more every ``update_epoch``
    steps."""
    def schedule(step: int) -> float:
        it = step + 1
        if it < warmup_steps:
            return it / warmup_steps * base_lr
        return base_lr * gamma ** ((it - warmup_steps) // update_epoch)
    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, t_total: int,
                           cycles: float = 0.5) -> Schedule:
    """``WarmupCosineSchedule`` (runners/schedule.py:5-22): a linear warmup,
    then ``cycles`` cosine periods over the remaining ``t_total`` steps,
    floored at 0."""
    def schedule(step: int) -> float:
        it = step + 1.0
        if it < warmup_steps:
            return base_lr * it / max(1.0, warmup_steps)
        progress = (it - warmup_steps) / max(1.0, t_total - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * cycles * 2.0 * progress)))
    return schedule


# the registered schedules (acvae_tpu/train/schedules.py:31-97)
SCHEDULES = {"ExponentialDecayScheduler": exponential_decay_schedule,
             "NoamScheduler": noam_schedule,
             "WarmupLinearSchedule": warmup_linear_schedule,
             "WarmupCosineSchedule": warmup_cosine_schedule,
             "constant": lambda base_lr: lambda step: base_lr}


def build_schedule(name: str, base_lr: float, **kwargs) -> Schedule:
    """The named schedule with its ``scheduler_args``.  Any other name (an
    epoch scheduler such as ``ReduceLROnPlateau``, stepped with the
    validation score in ``train/optim.py``) trains at the constant
    ``base_lr``, its arguments not the schedule's
    (acvae_tpu/cli/main.py:249-252)."""
    if name in SCHEDULES:
        return SCHEDULES[name](base_lr, **kwargs)
    return lambda step: base_lr


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
