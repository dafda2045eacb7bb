"""The flagship train step (counterpart of ``acvae_tpu/train/trainer.py:127-181,
184-384`` and the per-iteration bookkeeping of ``acvae_tpu/cli/main.py:523-553``).

One step: on-device SpecAugment (the time warp runs the CUDA kernel) ->
teacher-forced forward -> label-smoothed CE over valid tokens
+ kl_weight · masked Normal KL + α · MSE global constraint -> global-norm
clip -> Adam at the scheduled learning rate.  BatchNorm statistics update
during the forward, flax-style.  Each phase is a ``record_function`` range
(augment / forward / backward / optimizer) that a torch.profiler trace
reads; the ranges cost nothing when no profiler runs.  The augment runs before the loss and
gradients are taken with respect to parameters only, so the warp needs no
backward.

The clip is optax's ``clip_by_global_norm``: scale by ``max/‖g‖`` when
``‖g‖ >= max``, with no epsilon (``clip_grad_norm_`` adds 1e-6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.ops.losses import (label_smoothing_loss, normal_kl_loss,
                                        normal_kl_per_dim, cross_entropy)
from acvae_tpu_torch.ops.masked import length_mask
from acvae_tpu_torch.ops.specaug import build_augment
from acvae_tpu_torch.train.schedules import (build_schedule,
                                             dis_ratio_for_epoch,
                                             kl_weight_for_epoch, ss_ratio_at)

# config keys of branches of the JAX train loop that this port leaves out;
# setting any of them raises instead of being silently ignored
UNPORTED_KEYS = ("adverse_loss", "embedding_loss", "free_bits", "use_aug_prob",
                 "kl_anneal", "accum_steps", "distributed", "pretrained_encoder",
                 "pretrained_word_embedding", "freeze_word_embedding")


def compute_loss(model, batch: Dict[str, torch.Tensor], ss_ratio: float,
                 dis_ratio: float, kl_weight: float, alpha: Optional[float],
                 smoothing: Optional[float] = 0.1, kl_mask: str = "valid",
                 noise: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
    """Forward + the flagship loss mix; returns (loss, metrics).

    ``smoothing=None`` uses plain CE.  ``kl_mask`` is "valid" (mask the KL
    to real tokens) or "reference" (mean over padded positions too)."""
    caps, cap_lens = batch["caps"], batch["cap_lens"]
    out = model.train_forward(batch["feats"], batch["feat_lens"], caps,
                              cap_lens, ss_ratio=ss_ratio, dis_ratio=dis_ratio,
                              train=True, noise=noise, generator=generator)
    mask = length_mask(cap_lens - 1, caps.shape[1] - 1)
    targets = caps[:, 1:]
    if smoothing is None:
        ce = cross_entropy(out["logits"], targets, mask)
    else:
        ce = label_smoothing_loss(out["logits"], targets, smoothing, mask)
    km = mask if kl_mask == "valid" else None
    q_m, q_l, p_m, p_l = (out["q_means"], out["q_logs"], out["p_means"],
                          out["p_logs"])
    kl = normal_kl_loss(q_m, q_l, p_m, p_l, km)
    with torch.no_grad():
        kl_d = normal_kl_per_dim(q_m, q_l, p_m, p_l, km)
        qp_sq = torch.mean((q_m - p_m) ** 2, dim=-1)
        if km is None:
            qp_mse = qp_sq.mean()
        else:
            kmf = km.to(qp_sq.dtype)
            qp_mse = torch.sum(qp_sq * kmf) / torch.clamp_min(kmf.sum(), 1.0)
    loss = ce + kl_weight * kl
    metrics = {"ce": ce, "kl": kl, "active_units": (kl_d > 0.01).float().sum(),
               "kl_dim_max": kl_d.max(), "qp_mse": qp_mse}
    if alpha is not None:
        g = torch.mean((out["q_means_utt"] - out["p_means_utt"]) ** 2)
        loss = loss + alpha * g
        metrics["global"] = g
    metrics["loss"] = loss
    metrics["ntokens"] = mask.sum()
    return loss, metrics


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def apply_gradients(optimizer: torch.optim.Optimizer, lr: float,
                    max_grad_norm: Optional[float]) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of the optimizer's
    parameters (in place; skipped when ``max_grad_norm`` is falsy), then one
    optimizer step at ``lr``.  Returns the pre-clip global norm."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_grad_norm:
        scale = torch.where(norm < max_grad_norm, 1.0, max_grad_norm / norm)
        for g in grads:
            g.mul_(scale)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


class Trainer:
    """Builds the flagship model, Adam, the LR schedule and the augment from
    ``conf``; :meth:`step` runs one train step.

    ``total_iters`` (iterations per epoch × epochs, as the JAX CLI works it
    out from the loader) drives the LR decay and the scheduled-sampling
    decay; no config holds it, so it is a required argument."""

    def __init__(self, conf: Dict[str, Any], vocab_size: int, data_dim: int,
                 device=DEFAULT_DEVICE, *, total_iters: int):
        for key in UNPORTED_KEYS:
            if conf.get(key):
                raise NotImplementedError(f"config key {key!r} is not ported")
        if conf.get("optimizer", "Adam") != "Adam":
            raise NotImplementedError(f"optimizer {conf['optimizer']!r} is not "
                                      f"ported (only Adam)")
        if conf.get("global_loss", "MSE") != "MSE":
            raise NotImplementedError("only global_loss: MSE is ported")
        self.conf = conf
        self.device = torch.device(device)
        seed = int(conf.get("seed", 1))
        # seeded initial weights without touching the caller's global RNG
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(seed)
            self.model = build_model(conf, vocab_size, data_dim,
                                     device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 2)
        self.total_iters = int(total_iters)
        opt_args = dict(conf.get("optimizer_args", {}))
        base_lr = opt_args.pop("lr", 5e-4)
        if opt_args:
            raise NotImplementedError(f"optimizer_args {sorted(opt_args)} are "
                                      f"not ported")
        self.schedule = build_schedule(conf.get("scheduler", "constant"),
                                       base_lr, self.total_iters,
                                       **conf.get("scheduler_args", {}))
        self.optimizer = make_optimizer(self.model.parameters(), base_lr)
        self.augment = None
        if conf.get("augments"):
            self.augment = build_augment(conf["augments"],
                                         crop_size=conf.get("crop_size", 992),
                                         **conf.get("augment_args", {}))

    def ratios(self, iteration: int, epoch: int) -> Dict[str, float]:
        """ss_ratio, dis_ratio and kl_weight for this iteration and epoch
        (cli/main.py:523-553, reference KL annealing)."""
        c = self.conf
        ss = c["ss_args"]
        return {
            "ss_ratio": ss_ratio_at(iteration, ss["ss_ratio"], ss["ss_mode"],
                                    self.total_iters,
                                    ss.get("final_ss_ratio", 0.7)),
            "dis_ratio": dis_ratio_for_epoch(
                epoch, c["epochs"], c["dis_ration"]["freeze_epoch"],
                c["dis_ration"]["final_ratio"]),
            "kl_weight": kl_weight_for_epoch(epoch, c["epochs"], c["beta"]),
        }

    def step(self, batch: Dict[str, Any], iteration: int, epoch: int,
             draws: Optional[Dict] = None,
             noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One train step on ``batch`` (``feats`` [N,T,F], ``feat_lens``,
        ``caps`` [N,L], ``cap_lens``; arrays or tensors).  ``draws`` /
        ``noise`` optionally fix the augment's and the model's random draws
        (the dropouts draw from torch's global generator).  Returns detached
        0-d metric tensors, left on the device."""
        c = self.conf
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        if self.augment is not None:
            with record_function("augment"):
                feats, lens = self.augment(batch["feats"], batch["feat_lens"],
                                           draws=draws, generator=self.generator)
            batch = dict(batch, feats=feats, feat_lens=lens)
        r = self.ratios(iteration, epoch)
        self.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            loss, metrics = compute_loss(
                self.model, batch, r["ss_ratio"], r["dis_ratio"],
                r["kl_weight"], c.get("alpha"),
                smoothing=c["smoothing"] if c.get("label_smoothing", True)
                else None,
                kl_mask=c.get("kl_mask", "valid"), noise=noise,
                generator=self.generator)
        with record_function("backward"):
            loss.backward()
        # iterations count from 1 (cli/main.py:548); the optimizer has
        # applied iteration-1 updates before this one
        lr = self.schedule(iteration - 1)
        with record_function("optimizer"):
            grad_norm = apply_gradients(self.optimizer, lr,
                                        c.get("max_grad_norm"))
        metrics["grad_norm"] = grad_norm
        metrics["lr"] = torch.tensor(lr)
        return {k: v.detach() for k, v in metrics.items()}
