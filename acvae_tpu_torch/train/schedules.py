"""Learning-rate and recipe schedules (counterpart of
``acvae_tpu/train/schedules.py:32-57`` and ``acvae_tpu/train/trainer.py:402-436``).

Schedules map the optimizer step (0 for the first update) to a learning
rate; the reference counts from 1, so ``it = step + 1``.
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
    if name == "ExponentialDecayScheduler":
        kwargs.setdefault("total_iters", max(1, total_iters))
        return exponential_decay_schedule(base_lr, **kwargs)
    if name == "constant":
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
