"""Human / reference-caption upper bounds (counterpart of
``acvae_tpu/evaluation/human_eval.py:18-39``; the reference's
``utils/human_eval.py:13-118`` and ``utils/diverse_mutil_human.py``): each
reference caption scored leave-one-out against its siblings, the accuracy
and diversity that annotators reach on the dataset.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from acvae_tpu_torch.evaluation.coco import BleuScorer, CiderScorer, RougeScorer
from acvae_tpu_torch.evaluation.diversity import eval_div_stats


def human_scores(key2refs: Dict[str, List[str]]) -> Dict[str, float]:
    """Bleu_1, Bleu_4, ROUGE_L and CIDEr of each caption slot scored against
    the clip's other references, averaged over the slots."""
    n_caps = min(len(v) for v in key2refs.values())
    agg: Dict[str, List[float]] = {}
    for i in range(n_caps):
        gts = {k: v[:i] + v[i + 1:] for k, v in key2refs.items()}
        res = {k: [v[i]] for k, v in key2refs.items()}
        bleu, _ = BleuScorer(4).compute_score(gts, res)
        cider, _ = CiderScorer().compute_score(gts, res)
        rouge, _ = RougeScorer().compute_score(gts, res)
        for name, val in [("Bleu_1", bleu[0]), ("Bleu_4", bleu[3]),
                          ("ROUGE_L", rouge), ("CIDEr", cider)]:
            agg.setdefault(name, []).append(val)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def human_diversity(key2refs: Dict[str, List[str]]) -> Dict[str, float]:
    """The diversity suite over the reference captions themselves."""
    return eval_div_stats(key2refs)
