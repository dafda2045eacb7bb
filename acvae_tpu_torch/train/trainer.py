"""The train step (counterpart of ``acvae_tpu/train/trainer.py:127-384``
and the per-iteration bookkeeping of ``acvae_tpu/cli/main.py:523-553``).

One step: on-device SpecAugment (the time warp runs the CUDA kernel) ->
teacher-forced forward -> label-smoothed CE over valid tokens, then by
family: nothing more for the plain captioners; + kl_weight · the mixture
bound (``gmm_kl_loss``) for a GMM prior; + kl_weight · the Normal KL
otherwise (masked to valid tokens, unmasked for SimpleVAE's one latent a
clip; with ``free_bits`` λ the KL becomes ``Σ_d max(KL_d, λ)`` and the
unfloored one is logged as ``kl_raw``); + α · the global constraint where
the model returns ``p_means_utt`` (``global_loss``: MSE of the utterance
means, or the Normal KL between their halves) -> ``train/optim.py``'s
chain (clip, coupled L2, the optimizer, the plateau's factor; freezing;
gradient accumulation).  BatchNorm statistics update during the forward,
flax-style, every micro-batch.  Each phase is a ``record_function`` range
(augment / forward / backward / optimizer) that a torch.profiler trace
reads; the ranges cost nothing when no profiler runs.  The augment runs
before the loss and gradients are taken with respect to parameters only,
so the warp needs no backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.ops.losses import (cross_entropy, gmm_kl_loss,
                                        label_smoothing_loss, normal_kl_loss,
                                        normal_kl_per_dim)
from acvae_tpu_torch.ops.masked import length_mask
from acvae_tpu_torch.ops.specaug import build_augment
from acvae_tpu_torch.train.optim import OptaxChain
from acvae_tpu_torch.train.schedules import (build_schedule,
                                             dis_ratio_for_epoch,
                                             kl_weight_for, parse_kl_anneal,
                                             ss_ratio_at)

# config keys of branches of the JAX train loop that this port leaves out,
# with the ROADMAP item each waits for; setting one raises instead of being
# silently ignored
UNPORTED_KEYS = {"adverse_loss": "A17 part 2", "embedding_loss": "A17 part 2",
                 "use_aug_prob": "A17 part 2", "distributed": "A19"}
# the schedule keys a recipe may leave out, at the JAX CLI's defaults
# (acvae_tpu/cli/main.py:45-55)
RATIO_DEFAULTS = {
    "beta": 0.5,
    "ss_args": {"ss_mode": "exponential", "ss_ratio": 1.0, "final_ss_ratio": 0.7},
    "dis_ration": {"freeze_epoch": 10, "final_ratio": 0.3},
}


def check_free_bits(conf: Dict[str, Any]) -> None:
    """``free_bits`` with a GMM prior raises the JAX package's ValueError
    (trainer.py:268-272), before any training starts."""
    if (conf.get("free_bits") is not None
            and conf.get("model_args", {}).get("prior_model") == "GMMPriorRNN"):
        raise ValueError(
            "free_bits requires a Normal prior (per-dim KL decomposition); the "
            "GMM mixture bound has none — unset free_bits for GMM-prior configs")


def compute_loss(model, batch: Dict[str, torch.Tensor], ss_ratio: float,
                 dis_ratio: float, kl_weight: float, alpha: Optional[float],
                 smoothing: Optional[float] = 0.1, kl_mask: str = "valid",
                 noise: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None,
                 global_loss: str = "MSE", free_bits: Optional[float] = None):
    """Forward + the family's loss mix; returns (loss, metrics).

    ``smoothing=None`` uses plain CE.  ``kl_mask`` is "valid" (mask the KL
    to real tokens) or "reference" (mean over padded positions too).  The
    posterior-collapse diagnostics (``active_units``, ``kl_dim_max``,
    ``qp_mse``) come with the Normal KL only; ``free_bits`` (Normal KL
    only) floors each dimension's batch-mean KL at λ.  ``global_loss`` other
    than "MSE" is the Normal KL between the utterance moments: the two
    halves of ``q_means_utt`` (or it and ``q_logs_utt``) against the halves
    of ``p_means_utt``."""
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
    metrics = {"ce": ce}
    loss = ce
    if "q_means" in out:
        km = mask if kl_mask == "valid" else None
        q_m, q_l, p_m, p_l = (out["q_means"], out["q_logs"], out["p_means"],
                              out["p_logs"])
        if q_m.ndim < 3:      # SimpleVAE: one latent a clip, unmasked
            km = None
        if p_m.ndim == q_m.ndim + 1:
            # GMM prior: the mixture upper bound with the prior's logits as
            # both weights, so the categorical term is zero
            c_p = out["p_mixture_logits"]
            kl = gmm_kl_loss(q_m, q_l, c_p, p_m, p_l, c_p, km)
        else:
            kl = normal_kl_loss(q_m, q_l, p_m, p_l, km)
            with torch.set_grad_enabled(free_bits is not None
                                        and torch.is_grad_enabled()):
                kl_d = normal_kl_per_dim(q_m, q_l, p_m, p_l, km)
            with torch.no_grad():
                qp_sq = torch.mean((q_m - p_m) ** 2, dim=-1)
                if km is None:
                    qp_mse = qp_sq.mean()
                else:
                    kmf = km.to(qp_sq.dtype)
                    qp_mse = torch.sum(qp_sq * kmf) / torch.clamp_min(kmf.sum(),
                                                                      1.0)
                metrics.update(active_units=(kl_d > 0.01).float().sum(),
                               kl_dim_max=kl_d.max(), qp_mse=qp_mse)
            if free_bits is not None:
                metrics["kl_raw"] = kl
                kl = torch.sum(torch.clamp_min(kl_d, free_bits))
        loss = loss + kl_weight * kl
        metrics["kl"] = kl
    if alpha is not None and "p_means_utt" in out:
        if global_loss == "MSE":
            g = torch.mean((out["q_means_utt"] - out["p_means_utt"]) ** 2)
        else:
            if out.get("q_logs_utt") is None:
                qm, ql = torch.chunk(out["q_means_utt"], 2, dim=-1)
            else:
                qm, ql = out["q_means_utt"], out["q_logs_utt"]
            pm, pl = torch.chunk(out["p_means_utt"], 2, dim=-1)
            g = normal_kl_loss(qm, ql, pm, pl)
        loss = loss + alpha * g
        metrics["global"] = g
    metrics["loss"] = loss
    metrics["ntokens"] = mask.sum()
    return loss, metrics


def frozen_paths(conf: Dict[str, Any]) -> Tuple[str, ...]:
    """The name fragments of the frozen parameters: ``freeze_word_embedding``
    freezes every word embedding, ``model_args.freeze_encoder`` the
    encoder (acvae_tpu/cli/main.py:264-276)."""
    frozen = []
    if conf.get("freeze_word_embedding"):
        frozen.append("word_embedding")
    if conf.get("model_args", {}).get("freeze_encoder"):
        frozen.append("encoder")
    return tuple(frozen)


def build_optimizer(conf: Dict[str, Any], named_params, total_iters: int
                    ) -> OptaxChain:
    """The recipe's optimizer chain: ``optimizer``, ``optimizer_args``
    (``lr`` the base rate), ``scheduler``/``scheduler_args``, the clip,
    the freezing and ``accum_steps``.  ``ExponentialDecayScheduler`` decays
    over the applied updates, ``total_iters // accum_steps``
    (acvae_tpu/cli/main.py:237-280)."""
    opt_args = dict(conf.get("optimizer_args", {}))
    base_lr = opt_args.pop("lr", 5e-4)
    accum = int(conf.get("accum_steps", 1) or 1)
    sched_args = dict(conf.get("scheduler_args", {}))
    name = conf.get("scheduler", "constant")
    if name == "ReduceLROnPlateau":
        sched_args = {}
    schedule = build_schedule(name, base_lr, max(1, int(total_iters) // accum),
                              **sched_args)
    return OptaxChain(named_params, conf.get("optimizer", "Adam"), schedule,
                      max_grad_norm=conf.get("max_grad_norm"),
                      frozen=frozen_paths(conf), accum_steps=accum, **opt_args)


class Trainer:
    """Builds the model, the optimizer chain, the LR schedule and the
    augment from ``conf``; :meth:`step` runs one train step on a
    micro-batch.

    ``total_iters`` (``len(train_loader) × epochs``, as the CLI works it
    out) drives the LR decay and the scheduled-sampling decay; no config
    holds it, so it is a required argument.  ``pretrained_word_embedding``
    is installed at init, before any ``pretrained*`` merge, as
    ``_init_state`` does.  :meth:`state` and :meth:`load_state` carry
    everything but the step count across a checkpoint, the optimizer's
    gradient accumulator included."""

    def __init__(self, conf: Dict[str, Any], vocab_size: int, data_dim: int,
                 device=DEFAULT_DEVICE, *, total_iters: int,
                 vocab: Optional[Any] = None):
        check_free_bits(conf)
        for key, item in UNPORTED_KEYS.items():
            if conf.get(key):
                raise NotImplementedError(f"config key {key!r} is not ported "
                                          f"(ROADMAP {item})")
        self.conf = conf
        self.kl_anneal = parse_kl_anneal(conf.get("kl_anneal"))
        self.device = torch.device(device)
        seed = int(conf.get("seed", 1))
        # seeded initial weights without touching the caller's global RNG
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(seed)
            self.model = build_model(conf, vocab_size, data_dim,
                                     device=self.device)
        if conf.get("pretrained_word_embedding"):
            from acvae_tpu_torch.train.pretrained import (load_word_embeddings,
                                                          set_embedding_param)
            set_embedding_param(self.model, load_word_embeddings(
                conf["pretrained_word_embedding"], vocab))
        self.generator = torch.Generator(self.device).manual_seed(seed + 2)
        self.total_iters = int(total_iters)
        self.optimizer = build_optimizer(conf, self.model.named_parameters(),
                                         self.total_iters)
        self.augment = None
        if conf.get("augments"):
            self.augment = build_augment(conf["augments"],
                                         crop_size=conf.get("crop_size", 992),
                                         **conf.get("augment_args", {}))

    def state(self) -> Dict[str, Any]:
        """What an exact resume needs besides the step count: the weights,
        the optimizer's state, and the states of the trainer's generator
        (augment and model noise) and of torch's global ones (the
        dropouts)."""
        rng = {"generator": self.generator.get_state(),
               "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"state_dict": {k: v.detach().cpu()
                               for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(), "rng": rng}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state` (tensors on the CPU, as ``torch.load(...,
        map_location="cpu")`` gives them); a missing or unexpected weight
        raises."""
        self.model.load_state_dict(state["state_dict"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        rng = state["rng"]
        self.generator.set_state(rng["generator"])
        torch.set_rng_state(rng["torch"])
        if self.device.type == "cuda" and "cuda" in rng:
            torch.cuda.set_rng_state(rng["cuda"], self.device)

    def ratios(self, iteration: int, epoch: int) -> Dict[str, float]:
        """ss_ratio, dis_ratio and kl_weight for this iteration and epoch
        (cli/main.py:520-553; ``kl_anneal`` picks the KL schedule)."""
        c = dict(RATIO_DEFAULTS, **self.conf)
        ss, dis = c["ss_args"], c["dis_ration"]
        return {
            "ss_ratio": ss_ratio_at(iteration, ss["ss_ratio"], ss["ss_mode"],
                                    self.total_iters,
                                    ss.get("final_ss_ratio", 0.7)),
            "dis_ratio": dis_ratio_for_epoch(
                epoch, c["epochs"], dis["freeze_epoch"], dis["final_ratio"]),
            "kl_weight": kl_weight_for(self.kl_anneal, epoch, c["epochs"],
                                       c["beta"]),
        }

    def step(self, batch: Dict[str, Any], iteration: int, epoch: int,
             draws: Optional[Dict] = None,
             noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One train step on the micro-batch ``batch`` (``feats`` [N,T,F],
        ``feat_lens``, ``caps`` [N,L], ``cap_lens``; arrays or tensors).
        ``draws`` / ``noise`` optionally fix the augment's and the model's
        random draws (the dropouts draw from torch's global generator).
        Returns detached 0-d metric tensors, left on the device; ``lr`` is
        the rate of the update this micro-batch goes into."""
        c = self.conf
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        if self.augment is not None:
            with record_function("augment"):
                feats, lens = self.augment(batch["feats"], batch["feat_lens"],
                                           draws=draws, generator=self.generator)
            batch = dict(batch, feats=feats, feat_lens=lens)
        r = self.ratios(iteration, epoch)
        self.optimizer.zero_grad()
        with record_function("forward"):
            loss, metrics = compute_loss(
                self.model, batch, r["ss_ratio"], r["dis_ratio"],
                r["kl_weight"], c.get("alpha"),
                smoothing=c["smoothing"] if c.get("label_smoothing", True)
                else None,
                kl_mask=c.get("kl_mask", "valid"), noise=noise,
                generator=self.generator,
                global_loss=c.get("global_loss", "MSE"),
                free_bits=c.get("free_bits"))
        with record_function("backward"):
            loss.backward()
        lr = self.optimizer.lr()
        with record_function("optimizer"):
            metrics["grad_norm"] = self.optimizer.step()
        metrics["lr"] = torch.tensor(lr)
        return {k: v.detach() for k, v in metrics.items()}
