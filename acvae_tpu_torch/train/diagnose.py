"""Posterior/latent diagnostics of a trained experiment (counterpart of
``acvae_tpu/train/diagnose.py:25-159``; the ``diagnose`` command).

A few shuffled batches go through the checkpoint's *training* forward
(dropouts live, BatchNorm in batch mode, teacher forcing) twice, with the
same draws: under the posterior z (``dis_ratio`` 0) and under the prior z
(``dis_ratio`` 1).  Reported: the per-dimension KL spectrum, the active
units (KL above 0.01 and 0.1 nat), prior↔posterior mean agreement, the
spread of the posterior means over valid positions, and the teacher-forced
CE under either z.  The JSON keys are the JAX package's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.data.dataset import CaptionDataset, CaptionLoader
from acvae_tpu_torch.data.vocab import Vocabulary, load_caption_info
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.ops.losses import (cross_entropy, normal_kl_loss,
                                        normal_kl_per_dim)
from acvae_tpu_torch.ops.masked import length_mask
from acvae_tpu_torch.train.checkpoints import load_weights


def _stats(model, b: Dict[str, torch.Tensor], dis_ratio: float, seed: int):
    """(kl_d, kl, ce, qp_mse, q_var) of one train forward whose draws (the
    model's noise and the dropouts) all come from ``seed``."""
    dev = b["feats"].device
    cuda = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed + 7)
        out = model.train_forward(b["feats"], b["feat_lens"], b["caps"],
                                  b["cap_lens"], ss_ratio=1.0,
                                  dis_ratio=dis_ratio, train=True,
                                  generator=torch.Generator(dev).manual_seed(seed))
    caps, cap_lens = b["caps"], b["cap_lens"]
    mask = length_mask(cap_lens - 1, caps.shape[1] - 1)
    ce = cross_entropy(out["logits"], caps[:, 1:], mask)
    if "q_means" not in out or out["p_means"].ndim == out["q_means"].ndim + 1:
        # plain captioner or GMM prior: CE only (no per-dim Normal KL)
        z = torch.zeros(())
        return torch.zeros((1,)), z, ce, z, z
    q_m, q_l, p_m, p_l = (out["q_means"], out["q_logs"], out["p_means"],
                          out["p_logs"])
    km = mask if q_m.ndim >= 3 else None
    kl_d = normal_kl_per_dim(q_m, q_l, p_m, p_l, km)
    kl = normal_kl_loss(q_m, q_l, p_m, p_l, km)
    qp = torch.mean((q_m - p_m) ** 2, dim=-1)
    if km is None:
        qp_mse = qp.mean()
        q_var = torch.mean(torch.var(q_m.reshape(-1, q_m.shape[-1]), dim=0,
                                     unbiased=False))
    else:
        mf = km.to(qp.dtype)
        qp_mse = torch.sum(qp * mf) / torch.clamp_min(mf.sum(), 1.0)
        # the spread over valid positions only: padded steps carry the
        # posterior of pad tokens
        w = mf[..., None]
        denom = torch.clamp_min(w.sum(), 1.0)
        mu = torch.sum(q_m * w, dim=(0, 1)) / denom
        q_var = torch.mean(torch.sum(w * (q_m - mu) ** 2, dim=(0, 1)) / denom)
    return kl_d, kl, ce, qp_mse, q_var


@torch.no_grad()
def diagnose_experiment(exp_dir: str, h5_csv: Optional[str] = None,
                        caption_file: Optional[str] = None, batches: int = 6,
                        batch_size: int = 32, checkpoint: str = "best",
                        seed: int = 0, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The diagnostics of ``<exp_dir>/<checkpoint>.pt`` over ``batches``
    batches of the caption file (every caption; the recipe's own files
    when not given), shuffled with ``seed``.  Batch i draws from seed
    100 + i under both z."""
    from acvae_tpu_torch.cli.main import _feature_source

    exp = Path(exp_dir)
    conf = json.loads((exp / "config.json").read_text())
    vocab = Vocabulary.load(str(exp / "vocab.pkl"))
    info = load_caption_info(caption_file or conf["caption_file"],
                             conf.get("zh", False))
    ds = CaptionDataset(**_feature_source(h5_csv or conf["h5_csv"]),
                        caption_info=info, vocabulary=vocab)
    loader = CaptionLoader(ds, batch_size, shuffle=True, seed=seed)
    device = torch.device(device)
    model = build_model(conf, len(vocab), ds.data_dim, device=device)
    load_weights(model, str(exp), checkpoint)

    acc: Dict[str, list] = {k: [] for k in ("kl_d", "kl", "ce_post", "ce_prior",
                                            "qp_mse", "q_var")}
    for i, batch in zip(range(batches), loader):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in batch.arrays().items()}
        kl_d, kl, ce_p, qp, qv = _stats(model, b, 0.0, 100 + i)
        ce_prior = _stats(model, b, 1.0, 100 + i)[2]
        acc["kl_d"].append(kl_d.float().cpu().numpy())
        for k, v in (("kl", kl), ("ce_post", ce_p), ("ce_prior", ce_prior),
                     ("qp_mse", qp), ("q_var", qv)):
            acc[k].append(float(v))

    kl_d = np.mean(np.stack(acc["kl_d"]), axis=0)
    spectrum = np.sort(kl_d)[::-1]
    res: Dict[str, Any] = {
        "exp": str(exp), "checkpoint": checkpoint,
        "n_batches": len(acc["kl"]),
        # the training forward (live dropouts, batch-mode BatchNorm): the
        # CEs are paired (both z share the draws), not inference-mode CEs
        "forward_mode": "train",
        "ce_posterior_z": round(float(np.mean(acc["ce_post"])), 4),
        "ce_prior_z": round(float(np.mean(acc["ce_prior"])), 4),
        "ce_prior_penalty": round(float(np.mean(acc["ce_prior"]))
                                  - float(np.mean(acc["ce_post"])), 4),
    }
    if kl_d.shape[0] > 1:
        res.update({
            "kl_total": round(float(np.mean(acc["kl"])), 4),
            "active_units_0.01": int(np.sum(kl_d > 0.01)),
            "active_units_0.1": int(np.sum(kl_d > 0.1)),
            "latent_dims": int(kl_d.shape[0]),
            "kl_dim_top8": [round(float(x), 4) for x in spectrum[:8]],
            "qp_mse": round(float(np.mean(acc["qp_mse"])), 5),
            "q_mean_var": round(float(np.mean(acc["q_var"])), 5),
        })
    return res
