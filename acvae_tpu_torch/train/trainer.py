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
means, or the Normal KL between their halves).  Three recipe terms apply
to any family: ``use_aug_prob`` (the batch's ``keep_mask`` drops augmented
captions from the CE, ``augment_loss``), ``embedding_loss`` (Cosine, MSE or
MAE of the sentence head's ``seq_outputs``, else of the mean+max pooled
decoder outputs, against the batch's ``cap_embeds``, times ``dec_par``) and
``adverse_loss`` (+ α · BCE(D(raw ``audio_embeds``, a straight-through
caption sample), 1) from a frozen discriminator that ``cli
train_discriminator`` trained; gradients reach the captioner through the
soft caption) -> ``train/optim.py``'s
chain (clip, coupled L2, the optimizer, the plateau's factor; freezing;
gradient accumulation).  BatchNorm statistics update during the forward,
flax-style, every micro-batch.  Each phase is a ``record_function`` range
(augment / forward / backward / optimizer; the adverse term is
``adverse`` inside ``forward``) that a torch.profiler trace reads; the ranges cost nothing when no profiler runs.  The augment runs
before the loss and gradients are taken with respect to parameters only,
so the warp needs no backward.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.losses.wrappers import (_sample_preds, augment_loss,
                                             bce_logits_loss)
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.ops.losses import (cross_entropy, gmm_kl_loss,
                                        label_smoothing_loss, normal_kl_loss,
                                        normal_kl_per_dim)
from acvae_tpu_torch.ops.masked import length_mask, max_with_lens, mean_with_lens
from acvae_tpu_torch.ops.specaug import build_augment
from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.train import Distributed
from acvae_tpu_torch.parallel.vocab import full_logits
from acvae_tpu_torch.train.optim import OptaxChain
from acvae_tpu_torch.train.profiling import mark_backward
from acvae_tpu_torch.train.schedules import (build_schedule,
                                             dis_ratio_for_epoch,
                                             kl_weight_for, parse_kl_anneal,
                                             ss_ratio_at)

# the schedule keys a recipe may leave out, at the JAX CLI's defaults
# (acvae_tpu/cli/main.py:45-55)
RATIO_DEFAULTS = {
    "beta": 0.5,
    "ss_args": {"ss_mode": "exponential", "ss_ratio": 1.0, "final_ss_ratio": 0.7},
    "dis_ration": {"freeze_epoch": 10, "final_ratio": 0.3},
}

# the row axis of each model noise of ``compute_loss``'s ``noise``
NOISE_ROW_AXIS = {"q_eps": 0, "p_eps": 1, "adv_gumbel": 0}


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
                 global_loss: str = "MSE", free_bits: Optional[float] = None,
                 embedding_loss: Optional[str] = None, dec_par: float = 1.0,
                 adversarial: Optional[Dict[str, Any]] = None):
    """Forward + the family's loss mix; returns (loss, metrics).

    ``smoothing=None`` uses plain CE.  ``kl_mask`` is "valid" (mask the KL
    to real tokens) or "reference" (mean over padded positions too).  The
    posterior-collapse diagnostics (``active_units``, ``kl_dim_max``,
    ``qp_mse``) come with the Normal KL only; ``free_bits`` (Normal KL
    only) floors each dimension's batch-mean KL at λ.  ``global_loss`` other
    than "MSE" is the Normal KL between the utterance moments: the two
    halves of ``q_means_utt`` (or it and ``q_logs_utt``) against the halves
    of ``p_means_utt``.  A ``keep_mask`` [N] in ``batch`` replaces the CE
    with ``augment_loss``; ``embedding_loss`` applies where the batch has
    ``cap_embeds``; ``adversarial`` (``dscrm``, a frozen DiscriminatorModel,
    ``alpha``, ``sample_method``) adds the adverse term, its Gumbel noise
    ``noise["adv_gumbel"]`` [N, L-1, V] or drawn from ``generator``."""
    caps, cap_lens = batch["caps"], batch["cap_lens"]
    out = model.train_forward(batch["feats"], batch["feat_lens"], caps,
                              cap_lens, ss_ratio=ss_ratio, dis_ratio=dis_ratio,
                              train=True, noise=noise, generator=generator)
    mask = length_mask(cap_lens - 1, caps.shape[1] - 1)
    targets = caps[:, 1:]
    keep = batch.get("keep_mask")
    if keep is not None:
        # AugmentLossWrapper (loss.py:72-94), the mask drawn on the host
        ce = augment_loss(full_logits(out["logits"]), targets, cap_lens - 1,
                          keep, smoothing or 0.0)
    elif smoothing is None:
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
                # the global per-dimension KL, on every rank of a step
                kl_d = pstate.shares_to_global(
                    normal_kl_per_dim(q_m, q_l, p_m, p_l, km))
            with torch.no_grad():
                qp_sq = torch.mean((q_m - p_m) ** 2, dim=-1)
                if km is None:
                    qp_mse = pstate.batch_mean(qp_sq)
                else:
                    kmf = km.to(qp_sq.dtype)
                    qp_mse = torch.sum(qp_sq * kmf) / torch.clamp_min(
                        pstate.global_count(kmf), 1.0)
                metrics.update(active_units=(kl_d > 0.01).float().sum(),
                               kl_dim_max=kl_d.max(), qp_mse=qp_mse)
            if free_bits is not None:
                metrics["kl_raw"] = kl
                kl = torch.sum(torch.clamp_min(kl_d, free_bits))
        # a free-bits KL is global already: each rank enters its share
        share = kl if free_bits is None else kl / pstate.data_extent()
        loss = loss + kl_weight * share
        metrics["kl"] = kl
    if embedding_loss and "cap_embeds" in batch:
        e_loss = _embedding_term(out, cap_lens, batch["cap_embeds"],
                                 embedding_loss)
        loss = loss + dec_par * e_loss
        metrics["embed"] = e_loss
    if adversarial is not None:
        with record_function("adverse"):
            adv = _adverse_term(out, cap_lens, adversarial, noise, generator)
        loss = loss + adversarial.get("alpha", 1.0) * adv
        metrics["adverse"] = adv
    if alpha is not None and "p_means_utt" in out:
        if global_loss == "MSE":
            g = pstate.batch_mean((out["q_means_utt"] - out["p_means_utt"]) ** 2)
        else:
            if out.get("q_logs_utt") is None:
                qm, ql = torch.chunk(out["q_means_utt"], 2, dim=-1)
            else:
                qm, ql = out["q_means_utt"], out["q_logs_utt"]
            pm, pl = torch.chunk(out["p_means_utt"], 2, dim=-1)
            g = normal_kl_loss(qm, ql, pm, pl)
        loss = loss + alpha * g
        metrics["global"] = g
    loss = mark_backward("loss", loss)
    metrics["loss"] = loss
    # the CE of an augment batch is over the kept tokens: weight by those
    metrics["ntokens"] = (mask.sum() if keep is None else
                          (mask.float() * keep.float()[:, None]).sum())
    # in a parallel step: the metrics of the global batch
    replicated = ("active_units", "kl_dim_max") + (
        ("kl",) if "kl_raw" in metrics else ())
    return loss, pstate.metrics_to_global(metrics, replicated)


def _embedding_term(out, cap_lens, target, kind: str) -> torch.Tensor:
    """The caption-embedding regression (pytorch_runner.py:104-113,
    324-333): the sentence head's ``seq_outputs``, else the mean+max pooled
    decoder outputs, against ``target`` by Cosine, MAE or MSE."""
    if "seq_outputs" in out:
        pooled = out["seq_outputs"]
    else:
        pooled = (mean_with_lens(out["output"], cap_lens - 1)
                  + max_with_lens(out["output"], cap_lens - 1))
    if pooled.shape[-1] != target.shape[-1]:
        raise ValueError(
            f"embedding_loss dimension mismatch: decoder pooled "
            f"output is {pooled.shape[-1]}-dim but the caption "
            f"embeddings are {target.shape[-1]}-dim; either match "
            f"decoder hidden_size to the embeddings or use a "
            f"model with seq_output_size={target.shape[-1]} "
            f"(the CaptionSentenceModel projection head, "
            f"word_model.py:409-438)")
    target = target.to(pooled.dtype)
    if kind == "Cosine":
        num = torch.sum(pooled * target, -1)
        den = torch.clamp_min(torch.linalg.norm(pooled, dim=-1)
                              * torch.linalg.norm(target, dim=-1), 1e-8)
        return pstate.batch_mean(1.0 - num / den)
    if kind == "MAE":
        return pstate.batch_mean(torch.abs(pooled - target))
    return pstate.batch_mean((pooled - target) ** 2)


def _adverse_term(out, cap_lens, adversarial, noise, generator) -> torch.Tensor:
    """AdverseLossWrapper's generator side (loss.py:279-319): BCE(D(the raw
    ``audio_embeds``, a caption sample), 1) under the frozen discriminator;
    the reference discards the combined loss when alpha > 0 (loss.py:
    311-315), here the terms compose."""
    if "audio_embeds" not in out:
        raise ValueError(
            "adverse_loss requires a model whose train forward "
            "exposes audio_embeds (the VAECaptionModel family)")
    method = adversarial.get("sample_method", "argmax")
    preds = _sample_preds(full_logits(out["logits"]), method,
                          (noise or {}).get("adv_gumbel"), generator)
    probs = adversarial["dscrm"]({"audio_feats": out["audio_embeds"],
                                  "feats_lens": out["audio_embeds_lens"],
                                  "caps": preds, "lens": cap_lens - 1})
    return bce_logits_loss(probs, torch.ones_like(probs))


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
    over the applied updates, ``total_iters // accum_steps``, unless its
    ``scheduler_args`` set ``total_iters`` (acvae_tpu/cli/main.py:237-280)."""
    opt_args = dict(conf.get("optimizer_args", {}))
    base_lr = opt_args.pop("lr", 5e-4)
    accum = int(conf.get("accum_steps", 1) or 1)
    sched_args = dict(conf.get("scheduler_args", {}))
    name = conf.get("scheduler", "constant")
    if name == "ExponentialDecayScheduler":
        sched_args.setdefault("total_iters", max(1, int(total_iters) // accum))
    schedule = build_schedule(name, base_lr, **sched_args)
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
        self.conf, self.vocab_size, self.data_dim = conf, vocab_size, data_dim
        self.parallel = None
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
        # adverse_loss: the frozen discriminator of `cli train_discriminator`
        # (acvae_tpu/cli/main.py:439-459)
        self.adversarial = None
        if conf.get("adverse_loss"):
            from acvae_tpu_torch.train.checkpoints import load_discriminator
            adv = dict(conf["adverse_loss"])
            dscrm = load_discriminator(adv.pop("discriminator"), vocab_size,
                                       adv.pop("checkpoint", "best"),
                                       self.device)
            self.adversarial = dict(adv, dscrm=dscrm)
        self.augment = None
        if conf.get("augments"):
            self.augment = build_augment(conf["augments"],
                                         crop_size=conf.get("crop_size", 992),
                                         **conf.get("augment_args", {}))

    def distribute(self, grid) -> None:
        """Train on ``grid`` (``parallel/mesh.py``) from now on: rank 0's
        weights on every rank, the vocab leaves split over ``model`` when it
        is above 1, the optimizer rebuilt over the placed parameters (call
        it before any step or :meth:`load_state`).  :meth:`step` then takes
        this rank's rows (``shard_batch``), with ``draws``/``noise`` those
        of the global batch."""
        self.parallel = Distributed(grid, self.model, self.vocab_size)
        self.optimizer = build_optimizer(self.conf, self.model.named_parameters(),
                                         self.total_iters)
        if self.parallel.vocab_split:
            self.optimizer.split_norm(self.parallel.split_params(),
                                      grid.model_group)

    def state(self) -> Dict[str, Any]:
        """What an exact resume needs besides the step count: the weights,
        the optimizer's state, and the states of the trainer's generator
        (augment and model noise) and of torch's global ones (the
        dropouts).  Distributed, the vocab shards are gathered: every rank
        of the model axis must call it."""
        rng = {"generator": self.generator.get_state(),
               "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        state = {"state_dict": {k: v.detach().cpu()
                                for k, v in self.model.state_dict().items()},
                 "optimizer": self.optimizer.state_dict(), "rng": rng}
        if self.parallel is not None:
            state = self.parallel.full_state(state, self.optimizer.trainable)
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state` (tensors on the CPU, as ``torch.load(...,
        map_location="cpu")`` gives them); a missing or unexpected weight
        raises.  Distributed, a full state is sliced to this rank's
        shards."""
        if self.parallel is not None:
            state = self.parallel.local_state(state, self.optimizer.trainable)
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
        ``feat_lens``, ``caps`` [N,L], ``cap_lens``, optionally ``keep_mask``
        [N] and ``cap_embeds`` [N,E]; arrays or tensors).
        ``draws`` / ``noise`` optionally fix the augment's and the model's
        random draws (the dropouts draw from torch's global generator).
        Returns detached 0-d metric tensors, left on the device; ``lr`` is
        the rate of the update this micro-batch goes into."""
        c = self.conf
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        par, split = self.parallel, False
        context = contextlib.nullcontext()
        if par is not None:
            split = par.seq_split(batch["feats"].shape[1])
            context = par.step(batch["caps"].shape[0], split)
        with context:
            # this rank's rows of the global batch's draws (on a grid)
            draws = pstate.take_rows_of(draws)
            if noise is not None:
                noise = {k: pstate.take_rows(v, NOISE_ROW_AXIS[k])
                         if k in NOISE_ROW_AXIS else v for k, v in noise.items()}
            if self.augment is not None:
                with record_function("augment"):
                    feats, lens = self.augment(batch["feats"],
                                               batch["feat_lens"], draws=draws,
                                               generator=self.generator)
                batch = dict(batch, feats=feats, feat_lens=lens)
            if split:   # this rank's slice of mel time, after the augment
                batch = dict(batch, feats=par.time_slice(batch["feats"]))
            return self._step(batch, iteration, epoch, noise, split)

    def _step(self, batch, iteration, epoch, noise, split):
        c = self.conf
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
                free_bits=c.get("free_bits"),
                embedding_loss=c.get("embedding_loss"),
                dec_par=c.get("dec_par", 1.0), adversarial=self.adversarial)
        with record_function("backward"):
            loss.backward()
            if self.parallel is not None:
                self.parallel.sync_grads(split)
        lr = self.optimizer.lr()
        with record_function("optimizer"):
            metrics["grad_norm"] = self.optimizer.step()
        metrics["lr"] = torch.tensor(lr)
        return {k: v.detach() for k, v in metrics.items()}
