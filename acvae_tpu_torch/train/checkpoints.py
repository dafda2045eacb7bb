"""The port's experiment directory and its checkpoints (counterpart of
``acvae_tpu/train/checkpoints.py:22-154, 226-296``).

An experiment dir holds ``config.json`` (the recipe, JSON rather than YAML
so that nothing needs PyYAML), ``vocab.pkl`` (the JAX package's pickle
format) and ``<name>.pt``: a ``torch.save`` of ``{"state_dict": ...}``,
which training extends with ``optimizer``, ``step`` and ``rng`` (the
generators' states) so that ``--resume`` continues exactly.  ``best.pt``
is written when the validation score improves and ``last.pt`` every epoch;
``checkpoint_every_steps`` adds mid-epoch snapshots in two alternating
slots, ``step_0.pt`` and ``step_1.pt``, removed once ``last`` supersedes
them.  ``ckpt_steps.json`` records each checkpoint's step and the best
score.  :func:`resume_newest` restores the newest readable candidate;
:func:`average_checkpoints` writes the elementwise mean of several.
"""
from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model

_LOG = logging.getLogger("acvae_tpu_torch")


def _write_side_files(exp: Path, conf: Optional[Dict[str, Any]],
                      vocab: Optional[Vocabulary]) -> None:
    if conf is not None:
        (exp / "config.json").write_text(json.dumps(conf, indent=1))
    if vocab is not None:
        vocab.save(str(exp / "vocab.pkl"))


def _save(obj: Dict[str, Any], path: Path) -> None:
    """torch.save through a temporary file and a rename, so that a run
    stopped mid-write leaves the previous checkpoint whole."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_experiment(exp_dir: str, model: torch.nn.Module, conf: Dict[str, Any],
                    vocab: Vocabulary, name: str = "best") -> Path:
    """Write ``config.json``, ``vocab.pkl`` and ``<name>.pt`` (weights only)
    into ``exp_dir`` (created if missing); returns the weights' path."""
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    _write_side_files(exp, conf, vocab)
    path = exp / f"{name}.pt"
    _save({"state_dict": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}, path)
    return path


def save_checkpoint(exp_dir: str, name: str, trainer, step: int,
                    vocab: Optional[Vocabulary] = None,
                    conf: Optional[Dict[str, Any]] = None) -> Path:
    """``<name>.pt`` with the trainer's full state (weights, optimizer,
    generators) and ``step``; also ``vocab.pkl``/``config.json`` when
    given."""
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    _write_side_files(exp, conf, vocab)
    path = exp / f"{name}.pt"
    _save(dict(trainer.state(), step=int(step)), path)
    return path


def _resolve_checkpoint_path(exp_dir: str, name: str) -> Path:
    """``<name>.pt``; a run whose validation score never rose above its
    starting value wrote no ``best``, so ``best`` falls back to ``last``
    with a warning."""
    exp = Path(exp_dir)
    path = exp / f"{name}.pt"
    if name == "best" and not path.exists() and (exp / "last.pt").exists():
        _LOG.warning("no 'best' checkpoint in %s (validation never "
                     "improved); using 'last'", exp_dir)
        path = exp / "last.pt"
    return path


# resume candidates: the epoch-end ``last``, the two alternating mid-epoch
# slots, and the JAX package's legacy single ``step`` slot
RESUME_CANDIDATES = ("last", "step_0", "step_1", "step")


def resume_newest(exp_dir: str, trainer) -> Tuple[Optional[int], Optional[str]]:
    """Restore the newest readable checkpoint into ``trainer``: ``(step,
    name)``, or ``(None, None)`` when there is none
    (acvae_tpu/train/checkpoints.py:103-140).

    The candidates are tried in the order of their recorded step, ``last``
    first on a tie; one that cannot be read or restored is skipped with a
    warning, and the largest *restored* step wins: ``ckpt_steps.json`` can
    be stale either way after a crash between a save and its entry.  If no
    candidate can be read, it raises (a resume must not restart from
    scratch unnoticed)."""
    exp = Path(exp_dir)
    meta = read_ckpt_steps(exp_dir)
    avail = [n for n in RESUME_CANDIDATES if (exp / f"{n}.pt").exists()]
    if not avail:
        return None, None
    avail.sort(key=lambda n: (meta.get(n, -1), n == "last"), reverse=True)
    best, best_name, loaded = None, None, None
    for n in avail:
        try:
            ckpt = torch.load(exp / f"{n}.pt", map_location="cpu",
                              weights_only=True)
            trainer.load_state(ckpt)
            step = int(ckpt["step"])
        except Exception as e:  # a torn snapshot: try the older ones
            _LOG.warning("checkpoint %s/%s unrestorable (%s); trying older "
                         "ones", exp_dir, n, type(e).__name__)
            continue
        loaded = n
        if best is None or step > int(best["step"]):
            best, best_name = ckpt, n
    if best is None:
        raise RuntimeError(f"resume: the checkpoints {avail} in {exp_dir} "
                           f"could not be read")
    if loaded != best_name:
        trainer.load_state(best)
    return int(best["step"]), best_name


def average_checkpoints(exp_dir: str, names, output_name: str = "avg") -> Path:
    """``<output_name>.pt``: the elementwise mean of the weights and
    BatchNorm statistics of the named checkpoints (at least 2 distinct
    names; a missing one raises FileNotFoundError, with no best→last
    fallback).  Integer tensors are the newest checkpoint's; the step is
    the largest; the optimizer state is dropped (acvae_tpu/cli/main.py:
    1349-1389)."""
    exp = Path(exp_dir)
    name_list = [n.strip() for n in (names.split(",") if isinstance(names, str)
                                     else names) if n.strip()]
    if len(set(name_list)) < 2:
        raise ValueError(f"need >= 2 distinct checkpoint names, got "
                         f"{name_list}")
    missing = [n for n in name_list if not (exp / f"{n}.pt").exists()]
    if missing:
        # averaging `last` with itself would be a bogus artifact
        raise FileNotFoundError(f"checkpoint(s) {missing} not found in "
                                f"{exp_dir}")
    ckpts = [torch.load(exp / f"{n}.pt", map_location="cpu", weights_only=True)
             for n in name_list]
    steps = [int(c.get("step", 0)) for c in ckpts]
    newest = ckpts[steps.index(max(steps))]["state_dict"]
    avg = {}
    for k, v in newest.items():
        xs = [c["state_dict"][k] for c in ckpts]
        avg[k] = (sum(xs[1:], xs[0]) / len(xs) if v.is_floating_point()
                  else v.clone())
    path = exp / f"{output_name}.pt"
    _save({"state_dict": avg, "step": max(steps)}, path)
    return path


def _write_meta(exp_dir: str, steps: dict) -> None:
    """Atomic write (temporary file + rename): a torn ckpt_steps.json must
    not stop a resume."""
    path = os.path.join(exp_dir, "ckpt_steps.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(steps, f)
    os.replace(tmp, path)


def read_ckpt_steps(exp_dir: str) -> dict:
    """``ckpt_steps.json``; ``{}`` when it is missing or unreadable."""
    path = os.path.join(exp_dir, "ckpt_steps.json")
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        _LOG.warning("ckpt_steps.json in %s is unreadable; ignoring it",
                     exp_dir)
        return {}


def write_ckpt_step(exp_dir: str, name: str, step: int, **extra) -> None:
    """Record a checkpoint's step (and scalars such as the best score) in
    ``ckpt_steps.json``."""
    steps = read_ckpt_steps(exp_dir)
    steps[name] = int(step)
    steps.update(extra)
    _write_meta(exp_dir, steps)


def remove_checkpoint(exp_dir: str, name: str) -> None:
    """Delete ``<name>.pt`` and its ``ckpt_steps.json`` entry."""
    path = Path(exp_dir) / f"{name}.pt"
    if path.exists():
        path.unlink()
    steps = read_ckpt_steps(exp_dir)
    if name in steps:
        del steps[name]
        _write_meta(exp_dir, steps)


def criterion_improver(mode: str, initial: Optional[float] = None):
    """Closure tracking the best value (utils/train_util.py:117-131):
    ``inner(x)`` says whether x improves on it.  ``initial`` restores the
    best value on resume; ``inner.best`` exposes it."""
    if mode not in ("loss", "acc", "score"):
        raise ValueError(f"improvecriterion must be loss, acc or score, "
                         f"got {mode!r}")
    best = (float("inf") if mode == "loss" else 0.0) \
        if initial is None else float(initial)

    def inner(x: float) -> bool:
        nonlocal best
        improved = x < best if mode == "loss" else x > best
        if improved:
            best = x
        inner.best = best
        return improved

    inner.best = best
    return inner


def load_experiment(exp_dir: str, name: str = "best", device=DEFAULT_DEVICE
                    ) -> Tuple[Dict[str, Any], Vocabulary, torch.nn.Module]:
    """(conf, vocab, model): the model built from ``config.json`` on
    ``device`` with the weights of ``<name>.pt`` (``best`` falls back to
    ``last``); a missing or unexpected key raises."""
    exp = Path(exp_dir)
    conf = json.loads((exp / "config.json").read_text())
    vocab = Vocabulary.load(str(exp / "vocab.pkl"))
    model = build_model(conf, len(vocab), int(conf.get("data_dim", 64)),
                        device=device)
    load_weights(model, exp_dir, name)
    return conf, vocab, model


def load_weights(model: torch.nn.Module, exp_dir: str, name: str = "best") -> None:
    """Load the weights of ``<exp_dir>/<name>.pt`` (``best`` falls back to
    ``last``) into ``model``; a missing or unexpected key raises."""
    ckpt = torch.load(_resolve_checkpoint_path(exp_dir, name),
                      map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
