"""The port's experiment directory (the role of
``acvae_tpu/train/checkpoints.py:22-38, 226-275``).

An experiment dir holds ``config.json`` (the recipe, JSON rather than YAML
so that nothing needs PyYAML), ``vocab.pkl`` (the JAX package's pickle
format) and ``<name>.pt``, a ``torch.save`` of ``{"state_dict": ...}``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model


def save_experiment(exp_dir: str, model: torch.nn.Module, conf: Dict[str, Any],
                    vocab: Vocabulary, name: str = "best") -> Path:
    """Write ``config.json``, ``vocab.pkl`` and ``<name>.pt`` into
    ``exp_dir`` (created if missing); returns the weights' path."""
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    (exp / "config.json").write_text(json.dumps(conf, indent=1))
    vocab.save(str(exp / "vocab.pkl"))
    path = exp / f"{name}.pt"
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, path)
    return path


def load_experiment(exp_dir: str, name: str = "best", device=DEFAULT_DEVICE
                    ) -> Tuple[Dict[str, Any], Vocabulary, torch.nn.Module]:
    """(conf, vocab, model): the model built from ``config.json`` on
    ``device`` with the weights of ``<name>.pt``; a missing or unexpected
    key raises."""
    exp = Path(exp_dir)
    conf = json.loads((exp / "config.json").read_text())
    vocab = Vocabulary.load(str(exp / "vocab.pkl"))
    model = build_model(conf, len(vocab), int(conf.get("data_dim", 64)),
                        device=device)
    ckpt = torch.load(exp / f"{name}.pt", map_location=device,
                      weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return conf, vocab, model
