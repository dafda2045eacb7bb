"""SCST / N-SCST fine-tuning (counterpart of ``acvae_tpu/train/scst.py:31-141``).

* **rollout**: a ``sample`` decode at ``temp``, plus a greedy baseline for
  plain SCST (``sample_n == 1``) or ``sample_n`` replicas a clip for
  N-SCST.  Every random draw of the sampled decode is made here and kept
  as a tensor: the prior noise ``eps`` (its shape the family's) and the
  per-step Gumbel draws that pick the words.
* **reward** (host): CIDEr of the decoded strings (``batch_cider``, the
  first hypothesis of a key scored when ``dedup``), minus the greedy
  baseline, or minus the leave-one-out mean of the clip's other samples.
* **replay**: ``forced_decode`` of the sampled words with the *same*
  ``eps`` reproduces the rollout's log-probabilities (the words are given,
  so the Gumbel draws are not needed again), then ``scst_loss``, its
  gradient and one update of the optimizer chain.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from acvae_tpu_torch import END_IDX
from acvae_tpu_torch.decoding.sampling import gumbel_noise
from acvae_tpu_torch.evaluation.coco import CiderScorer
from acvae_tpu_torch.models.common import eps_stack
from acvae_tpu_torch.models.trans_vae import TransVAECaptionModel
from acvae_tpu_torch.models.vae import SimpleVAECaptionModel, VAECaptionModel


def scst_loss(sampled_logprobs: torch.Tensor, sampled_seqs: torch.Tensor,
              reward: torch.Tensor, end_idx: int = END_IDX) -> torch.Tensor:
    """The policy-gradient loss (acvae_tpu/ops/losses.py:121-135): the
    mean over rows of ``-Σ_t logp_t · reward · mask_t``, the mask 1 at
    position 0 and where the previous word is not ``<end>``."""
    lp = sampled_logprobs
    prev_not_end = (sampled_seqs[:, :-1] != end_idx).to(lp.dtype)
    mask = torch.cat([torch.ones_like(lp[:, :1]), prev_not_end], dim=1)
    return torch.mean(torch.sum(-lp * reward[:, None].to(lp.dtype) * mask, dim=1))


def rollout_noise(model, rows: int, max_length: int,
                  generator: Optional[torch.Generator], device
                  ) -> Optional[torch.Tensor]:
    """The prior noise a stepwise decode of ``rows`` clips draws: [T, N, E]
    for the VAE families and TransVAE, SimpleVAE's [N, E], none for the
    plain captioners."""
    if isinstance(model, SimpleVAECaptionModel):
        return torch.randn((rows, model.decoder.embed_size), generator=generator,
                           device=device)
    if isinstance(model, (VAECaptionModel, TransVAECaptionModel)):
        return eps_stack(max_length, rows, model.decoder.embed_size, generator,
                         device)
    return None


def make_rollout(model, sample_n: int = 1, max_length: int = 20,
                 temp: float = 1.0) -> Callable:
    """``rollout(feats, feat_lens, generator)`` -> ``sampled_seqs`` [N·n, T],
    the rollout's ``sampled_logprobs``, its noise ``eps`` (None for the
    plain captioners) and, with ``sample_n == 1``, ``greedy_seqs`` [N, T]."""

    def rollout(feats, feat_lens, generator=None) -> Dict[str, Any]:
        if sample_n > 1:
            feats = feats.repeat_interleave(sample_n, dim=0)
            feat_lens = feat_lens.repeat_interleave(sample_n, dim=0)
        rows, dev = feats.shape[0], feats.device
        eps = rollout_noise(model, rows, max_length, generator, dev)
        vocab = model.decoder.word_embeddings.num_embeddings
        gumbel = gumbel_noise((max_length, rows, vocab), generator, dev)
        sampled = model.inference_forward(
            feats, feat_lens, decode_method="sample", max_length=max_length,
            temp=temp, eps=eps, gumbel=gumbel)
        # the decode ran in inference mode; the replay differentiates
        # through a lookup of these words
        out = {"sampled_seqs": sampled["seqs"].clone(),
               "sampled_logprobs": sampled["sampled_logprobs"].clone(),
               "eps": eps}
        if sample_n == 1:
            greedy = model.inference_forward(
                feats, feat_lens, decode_method="greedy", max_length=max_length,
                eps=rollout_noise(model, rows, max_length, generator, dev))
            out["greedy_seqs"] = greedy["seqs"]
        return out

    return rollout


def decode_strings(seqs: np.ndarray, vocabulary) -> List[str]:
    return [" ".join(vocabulary.decode(s)) for s in seqs]


def batch_cider(hyps: List[str], keys: List[str],
                key2refs: Dict[str, List[str]], dedup: bool = True
                ) -> np.ndarray:
    """Per-hypothesis CIDEr-D.  ``dedup``: only a key's first hypothesis is
    scored and its duplicates share that score; else each is scored."""
    gts, res, order = {}, {}, []
    for i, (h, k) in enumerate(zip(hyps, keys)):
        slot = k if dedup else f"{k}#{i}"
        if slot not in res:
            res[slot] = [h]
            gts[slot] = key2refs[k]
        order.append(slot)
    _, per = CiderScorer().compute_score(gts, res)
    slot2score = dict(zip(gts.keys(), per))
    return np.asarray([slot2score[s] for s in order], np.float32)


def scst_reward(sampled: np.ndarray, greedy: Optional[np.ndarray],
                keys: List[str], key2refs: Dict[str, List[str]],
                vocabulary, sample_n: int = 1) -> Dict[str, np.ndarray]:
    """The advantage of each sampled rollout (``reward``) and its CIDEr
    (``score``): against the greedy decode's CIDEr for SCST, against the
    mean of the clip's other samples for N-SCST."""
    if sample_n == 1:
        s = batch_cider(decode_strings(sampled, vocabulary), keys, key2refs)
        g = batch_cider(decode_strings(greedy, vocabulary), keys, key2refs)
        return {"reward": s - g, "score": s}
    keys_r = [k for k in keys for _ in range(sample_n)]
    s = batch_cider(decode_strings(sampled, vocabulary), keys_r, key2refs,
                    dedup=False).reshape(-1, sample_n)
    baseline = (s.sum(1, keepdims=True) - s) / (s.shape[1] - 1)
    return {"reward": (s - baseline).reshape(-1), "score": s.reshape(-1)}


def replay_loss(model, feats, feat_lens, sampled_seqs: torch.Tensor,
                reward: torch.Tensor, eps: Optional[torch.Tensor],
                sample_n: int = 1) -> torch.Tensor:
    """``scst_loss`` of the forced decode of the rollout's words under its
    own noise, differentiable in the model's parameters."""
    if sample_n > 1:
        feats = feats.repeat_interleave(sample_n, dim=0)
        feat_lens = feat_lens.repeat_interleave(sample_n, dim=0)
    out = model.forced_decode(feats, feat_lens, sampled_seqs, eps=eps, grad=True)
    return scst_loss(out["sampled_logprobs"], sampled_seqs, reward)


def scst_train_step(model, optimizer, rollout: Callable, feats, feat_lens,
                    keys: List[str], key2refs: Dict[str, List[str]], vocabulary,
                    generator: Optional[torch.Generator] = None,
                    sample_n: int = 1) -> Dict[str, float]:
    """One SCST iteration: rollout, host reward, replay and one update of
    ``optimizer`` (an ``OptaxChain`` over the model's parameters)."""
    out = rollout(feats, feat_lens, generator)
    sampled = out["sampled_seqs"].cpu().numpy()
    greedy = out["greedy_seqs"].cpu().numpy() if sample_n == 1 else None
    rs = scst_reward(sampled, greedy, keys, key2refs, vocabulary, sample_n)
    optimizer.zero_grad()
    loss = replay_loss(model, feats, feat_lens, out["sampled_seqs"],
                       torch.as_tensor(rs["reward"], device=feats.device),
                       out["eps"], sample_n)
    loss.backward()
    optimizer.step()
    return {"loss": float(loss.detach()), "reward": float(np.mean(rs["reward"])),
            "score": float(np.mean(rs["score"]))}
