"""The port's experiment CLI (counterpart of ``acvae_tpu/cli/main.py``).

    python -m acvae_tpu_torch.cli make_synthetic <dir> [--rich] [--num_audios=N]
    python -m acvae_tpu_torch.cli build_vocab <text.json> <vocab.pkl>
    python -m acvae_tpu_torch.cli tokenize_caption <text.json> [<out.json>]
    python -m acvae_tpu_torch.cli train <config.yaml> [--key=value ...]
    python -m acvae_tpu_torch.cli evaluate <exp_dir> [--encoder_int8] [...]
    python -m acvae_tpu_torch.cli predict <exp_dir> <mels.csv> [--output=...]
    python -m acvae_tpu_torch.cli diversity <eval_output.json> [<text.json>]
    python -m acvae_tpu_torch.cli ensemble <exp_dir> <exp_dir> [...]
    python -m acvae_tpu_torch.cli human_eval <text.json>
    python -m acvae_tpu_torch.cli scst <exp_dir> [--sample_n=N] [--epochs=E]
    python -m acvae_tpu_torch.cli average_checkpoints <exp_dir> [--names=best,last]
    python -m acvae_tpu_torch.cli diagnose <exp_dir> [--batches=6]
    python -m acvae_tpu_torch.cli train_discriminator <config.yaml> [--mode=cap2cap]
    python -m acvae_tpu_torch.cli stage1 <text.json> <vocab.pkl> [--output_dir=...]
    python -m acvae_tpu_torch.cli stage1_test <stage1_dir> <text.json> <vocab.pkl>
    python -m acvae_tpu_torch.cli extract_embedding <stage1_dir> <text.json> <vocab.pkl> <out_dir>
    python -m acvae_tpu_torch.cli global_vae <text.json> <vocab.pkl> [--output_dir=...]
    python -m acvae_tpu_torch.cli export_embeddings <embedding_dir> <output_prefix>
    python -m acvae_tpu_torch.cli extract_sentence_embedding <text.json> <vocab.pkl> <source> <out_dir>
    python -m acvae_tpu_torch.cli export_model <exp_dir> [--encoder_int8] [--decode_dtype=bfloat16] [...]
    python -m acvae_tpu_torch.cli serve <exp_dir> | --exported=<export_dir> [--port=...]
    python -m acvae_tpu_torch.cli prepare_data <wav_dir> <mels.npz> <mels.csv> [--sr=32000]
    python -m acvae_tpu_torch.cli sweep <config.yaml> --param=beta --values=0.3,0.5 | --space=<yaml> [--mode=tpe]
    python -m acvae_tpu_torch.cli import_torch <best.pth> <config.yaml> <out_dir> <vocab.pkl>
    python -m acvae_tpu_torch.cli report_results <experiment_root> [--score_file=...]
    python -m acvae_tpu_torch.cli split_dataset <text.json> <output_prefix>
    python -m acvae_tpu_torch.cli concat_json <text.json> ... --output=<text.json>
    python -m acvae_tpu_torch.cli concat_csv <mels.csv> ... --output=<mels.csv>
    python -m acvae_tpu_torch.cli tsne <embedding_dir> ... [--output_prefix=tsne]
    python -m acvae_tpu_torch.cli doctor [--probe_timeout=120]

Any ``--key=value`` of ``train`` overrides the YAML, dotted keys reaching
nested mappings (``--ss_args.ss_mode=linear``); values are read as YAML
(``--augments=[timewarp,timemask]``).  Every command runs on ``cuda`` unless
``--device=cpu`` is given, and refuses to start without a card otherwise.
A feature manifest (``h5_csv``, ``eval_h5_csv``, ...) is the TSV of
``audio_id``/``hdf5_path`` or a kaldi ``.scp``/binary ``.ark`` table, read
into memory.

``train`` writes ``<outputpath>/<model>/<remark>_<beta>[_<alpha>]/seed_<N>/``
with ``train_caption.log`` (the epoch table), ``config.json``,
``metrics.jsonl`` (one line an epoch, the JAX package's keys), ``best.pt``
(when the validation CIDEr of a beam-3 decode improves), ``last.pt`` (every
epoch) and ``ckpt_steps.json``; ``--checkpoint_every_steps=k`` adds
mid-epoch snapshots (``step_0.pt``/``step_1.pt``), and ``--resume=true``
continues from the newest readable one.  The train keys of the JAX CLI work
as there: ``kl_anneal``, ``free_bits``, ``global_loss``, ``use_aug_prob``
(captions whose ``cap_id`` holds "aug" kept with that probability),
``embedding_path``/``embedding_scaler`` with ``embedding_loss`` and
``dec_par`` (configs/sentence.yaml), ``adverse_loss`` (a
``train_discriminator`` experiment as the frozen discriminator,
configs/adverse.yaml), the five
optimizers with their ``optimizer_args``, ``freeze_word_embedding``,
``model_args.freeze_encoder``, ``accum_steps``, ``ReduceLROnPlateau``, the
``pretrained*`` warm starts, ``fault_abort_step`` and ``profile_dir`` (a
torch.profiler trace of the run's first 15 steps).
``evaluate`` writes ``eval_output_<method>_<beam><suffix>.json`` and
``scores_<method>_<beam><suffix>.txt`` into the experiment dir; with
``--decode_method=dbs`` (``--group_size``, ``--diversity_lambda``,
``--temperature``, ``--group_nbest``) every output beam is a candidate, and
``--decode_dtype=bfloat16`` decodes with bf16 parameters (suffix
``_bfloat16``).  ``predict`` writes the DCASE CSV, ``diversity`` scores an
``eval_output`` JSON (Div1/Div2/gDiv1, mBLEU, SelfBLEU, Novelty against a
train corpus), ``ensemble`` decodes with the probability-averaged members
(``ensemble_scores.txt`` in the first member's dir) and ``human_eval``
scores the references leave-one-out.  ``scst`` fine-tunes an experiment
with self-critical sequence training into ``<exp>/scst_n<N>/``,
``average_checkpoints`` writes ``<output_name>.pt`` (the mean of the named
checkpoints) and ``diagnose`` prints the posterior-collapse diagnostics.
The auxiliary stack: ``train_discriminator`` (aud2cap or cap2cap),
``stage1`` (the GE2E caption embedder), ``stage1_test`` (its EER),
``extract_embedding`` (its per-caption tree for ``embedding_path``),
``extract_sentence_embedding`` (the tree from word vectors),
``export_embeddings`` (projector TSVs) and ``global_vae`` (the sentence VAE
that ``pretrained_global`` merges).
Deployment: ``export_model`` writes a ``torch.export`` decode artifact
(``export.py``; f32, ``--decode_dtype=bfloat16`` or ``--encoder_int8``),
``serve`` runs the HTTP server over an experiment or an artifact
(``serve.py``), ``prepare_data`` computes log-mels from wavs.
The rest: ``sweep`` trains a grid, random, TPE or anneal search of recipe
keys (``--assessor=median`` stops poor trials early, ``--isolate_trials``
runs each as its own ``train`` process on ``--device``), ``import_torch``
makes a port experiment of a reference-trained ``.pth``,
``report_results`` writes the mean ± std of the scores over ``seed_*``
dirs, ``split_dataset``/``concat_json``/``concat_csv`` split and join
corpus files, ``tsne`` plots embedding trees (scikit-learn and matplotlib)
and ``doctor`` checks the device in a bounded probe.
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import itertools
import json
import logging
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE, END_IDX, START_IDX
from acvae_tpu_torch.core.config import (Config, _coerce, _fix_yaml11_floats,
                                         load_config)
from acvae_tpu_torch.core.miniyaml import safe_load
from acvae_tpu_torch.data.dataset import (CaptionDataset, CaptionLoader,
                                          refs_of)
from acvae_tpu_torch.data.kaldi import read_mat_ark, read_mat_scp
from acvae_tpu_torch.data.vocab import (Vocabulary, build_vocab as _build_vocab,
                                        load_caption_info, tokenize)
from acvae_tpu_torch.decoding.ensemble import ensemble_decode
from acvae_tpu_torch.evaluation.coco import CiderScorer, score_captions
from acvae_tpu_torch.evaluation.diversity import (eval_div_stats, novelty,
                                                  self_bleu)
from acvae_tpu_torch.evaluation.human_eval import human_diversity, human_scores
from acvae_tpu_torch.losses.wrappers import augment_keep_mask
from acvae_tpu_torch.models.quant import (DEFAULT_INT8_SCHEME, int8_decode_fn,
                                          quant_encoder_for, scheme_kwargs)
from acvae_tpu_torch.ops.amp import cast_floats_for_decode, resolve_decode_dtype
from acvae_tpu_torch.train.checkpoints import (
    average_checkpoints as _average_checkpoints, criterion_improver,
    load_experiment, read_ckpt_steps, remove_checkpoint, resume_newest,
    save_checkpoint, write_ckpt_step)
from acvae_tpu_torch.train.optim import ReduceLROnPlateau
from acvae_tpu_torch.train.pretrained import apply_pretrained
from acvae_tpu_torch.train.profiling import Trace
from acvae_tpu_torch.train.trainer import RATIO_DEFAULTS, Trainer, check_free_bits

DEFAULTS = dict(
    seed=1, remark="tpu", epochs=25, batch_size=32, label_smoothing=True,
    smoothing=0.1, max_grad_norm=1.0, improvecriterion="score",
    train_percent=90.0, optimizer="Adam", optimizer_args={"lr": 5e-4},
    scheduler="ExponentialDecayScheduler",
    scheduler_args={"final_lr": 5e-7, "warmup_iters": 3000},
    zh=False, outputpath="experiments", kl_mask="valid",
    **RATIO_DEFAULTS,   # beta, ss_args, dis_ration
)

# train config keys of later ROADMAP items: setting one raises, naming it
# (max_inflight_steps, a lever of the TPU's asynchronous dispatch, is read
# and ignored; so is decode_dtype, which no train reads)
LATER_KEYS = {
    "distributed": "A19", "model_parallel": "A19", "sequence_parallel": "A19",
}
# the metrics averaged over an epoch into metrics.jsonl
DIAG_KEYS = ("kl", "kl_raw", "active_units", "kl_dim_max", "qp_mse",
             "grad_norm")
# a profile_dir trace covers this many steps (or the first epoch if shorter)
PROFILE_STEPS = 15


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP {item})")


def _refuse_later_items(conf: Dict[str, Any]) -> None:
    check_free_bits(conf)
    for key, item in LATER_KEYS.items():
        value = conf.get(key)
        if value not in (None, False, 0, "", {}, []) and not (
                key == "model_parallel" and value == 1):
            _later(f"config key {key!r}", item)


def _upload_dtype(conf: Dict[str, Any]) -> Optional[torch.dtype]:
    """The host dtype of the train batches' mels: None for float32, or
    bfloat16, which halves the upload (``upload_dtype``)."""
    up = str(conf.get("upload_dtype", "float32"))
    if up not in ("float32", "bfloat16"):
        raise ValueError(f"upload_dtype must be float32 or bfloat16, "
                         f"got {up!r}")
    return torch.bfloat16 if up == "bfloat16" else None


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA one needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA card and none "
                           f"is visible; pass --device=cpu to run on the CPU")
    return dev


def _setup_logger(logfile: Optional[str]) -> logging.Logger:
    logger = logging.getLogger("acvae_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[ %(levelname)s : %(asctime)s ] - %(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if logfile:
        handlers.append(logging.FileHandler(logfile))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def _read_manifest(path: str) -> Dict[str, str]:
    """The TSV of ``audio_id``/``hdf5_path`` columns (base_runner.py:41-47)."""
    with open(path, newline="") as f:
        return {row["audio_id"]: row["hdf5_path"]
                for row in csv.DictReader(f, delimiter="\t")}


def _feature_source(path: str) -> Dict[str, Dict[str, Any]]:
    """``CaptionDataset`` kwargs for a feature manifest
    (``acvae_tpu/cli/main.py:91-106``): a kaldi ``.scp`` or binary ``.ark``
    is read into an in-memory ``features`` dict; anything else is the TSV
    ``manifest``."""
    p = str(path)
    if p.endswith(".scp"):
        return {"features": dict(read_mat_scp(p))}
    if p.endswith(".ark"):
        return {"features": dict(read_mat_ark(p))}
    return {"manifest": _read_manifest(p)}


def _train_val_split(caption_info: List[dict], percent: float, seed: int):
    """Random clip-level split (base_runner.py:49-58)."""
    idx = np.arange(len(caption_info))
    rng = np.random.default_rng(seed)
    rng.shuffle(idx)
    n_train = int(len(idx) * percent / 100.0)
    return idx[:n_train].tolist(), idx[n_train:].tolist()


def _method_alias(method: Optional[str], decode_method: Optional[str],
                  default: str = "beam") -> str:
    """The reference's ``method`` flag (base_runner.py:199) as an alias of
    ``decode_method``; two explicit values that differ raise."""
    if method is None:
        return decode_method if decode_method is not None else default
    if decode_method is not None and method != decode_method:
        raise ValueError(
            f"conflicting flags: --decode_method={decode_method} vs "
            f"--method={method} (method is an alias; pass only one)")
    return method


def _write_scores(scores: Dict[str, Any], score_file) -> None:
    """Print and write the scores table (base_runner.py:295-320), with a
    note when METEOR/SPICE come from the native scorers."""
    native = scores.get("_native_scorers") or []
    with open(score_file, "w") as f:
        for name, val in scores.items():
            if name.startswith("_"):
                continue
            line = (f"{name}: {val:.3f}" if val is not None
                    else f"{name}: n/a (java scorer unavailable)")
            print(line)
            f.write(line + "\n")
        if native:
            note = ("# note: " + "/".join(native) + " computed by native "
                    "fallback scorers (no Java in this environment); these "
                    + ("and SPIDEr " if "SPICE" in native else "")
                    + "are NOT comparable to published pycocoevalcap numbers")
            print(note)
            f.write(note + "\n")


def _to_device(batch, device: torch.device,
               feats_dtype: Optional[torch.dtype] = None):
    """The loader's stage hook: the batch's arrays as tensors on
    ``device``, moved in the producer thread.  ``feats_dtype`` casts the
    mels on the host before the upload; on the card they are float32 again,
    the mels rounded to ``feats_dtype``."""
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    feats = (put(batch.feats) if feats_dtype is None else
             torch.from_numpy(batch.feats).to(feats_dtype).to(device).float())
    embeds = None if batch.cap_embeds is None else put(batch.cap_embeds)
    return dataclasses.replace(batch, feats=feats,
                               feat_lens=put(batch.feat_lens),
                               caps=put(batch.caps), cap_lens=put(batch.cap_lens),
                               cap_embeds=embeds)


def _build_dataloaders(conf: Config, vocab: Vocabulary):
    zh = conf.get("zh", False)
    if "train_h5_csv" in conf:
        train_src = _feature_source(conf["train_h5_csv"])
        val_src = _feature_source(conf["val_h5_csv"])
        train_info = load_caption_info(conf["train_caption_file"], zh)
        val_info = load_caption_info(conf["val_caption_file"], zh)
    else:
        train_src = val_src = _feature_source(conf["h5_csv"])
        info = load_caption_info(conf["caption_file"], zh)
        tr, va = _train_val_split(info, conf["train_percent"], conf["seed"])
        train_info, val_info = [info[i] for i in tr], [info[i] for i in va]
    # the validation set has no caption embeddings (they only enter the loss)
    train_ds = CaptionDataset(**train_src, caption_info=train_info,
                              vocabulary=vocab,
                              embedding_path=conf.get("embedding_path"),
                              embedding_scaler=conf.get("embedding_scaler", False))
    val_ds = CaptionDataset(**val_src, caption_info=val_info, vocabulary=vocab)
    bs = conf.get("dataloader_args", {}).get("batch_size", conf["batch_size"])
    train_loader = CaptionLoader(train_ds, bs, shuffle=True, seed=conf["seed"])
    val_loader = CaptionLoader(val_ds, bs, shuffle=False)
    return train_ds, val_ds, train_loader, val_loader


def _decode_loader(decode: Callable, loader: CaptionLoader, vocab: Vocabulary,
                   device: torch.device, num_candidates: int = 1,
                   every_beam: bool = False) -> List[Tuple[str, str]]:
    """(audio_id, caption) for every clip of ``loader`` in order, the top
    beam of a beam decode (every output beam with ``every_beam``);
    ``num_candidates`` replicas of each clip decode with their own prior
    noise."""
    out = []
    for batch in loader.prefetch(stage=partial(_to_device, device=device)):
        feats, lens, ids = batch.feats, batch.feat_lens, batch.audio_ids
        if num_candidates > 1:
            feats = feats.repeat_interleave(num_candidates, dim=0)
            lens = lens.repeat_interleave(num_candidates, dim=0)
            ids = [i for i in ids for _ in range(num_candidates)]
        seqs = decode(feats, lens)["seqs"].cpu().numpy()
        if seqs.ndim == 3 and every_beam:
            ids = [i for i in ids for _ in range(seqs.shape[1])]
            seqs = seqs.reshape(-1, seqs.shape[-1])
        elif seqs.ndim == 3:
            seqs = seqs[:, 0]
        out += [(aid, " ".join(vocab.decode(s))) for aid, s in zip(ids, seqs)]
    return out


def _validate(model, loader: CaptionLoader, vocab: Vocabulary,
              key2refs: Dict[str, List[str]], device: torch.device,
              seed: int, epoch: int, beam_size: int = 3) -> float:
    """CIDEr of a beam-3 decode of the validation set (the last decode of a
    clip counts); its prior noise comes from a generator of its own, seeded
    by the epoch, so validating leaves the training draws alone."""
    g = torch.Generator(device).manual_seed(seed + 1_000_000_000 + epoch)
    decode = partial(model.inference_forward, decode_method="beam",
                     beam_size=beam_size, generator=g)
    key2pred = {aid: [cap] for aid, cap in
                _decode_loader(decode, loader, vocab, device)}
    score, _ = CiderScorer().compute_score(key2refs, key2pred)
    return float(score)


def _experiment_dir(conf: Dict[str, Any]) -> Path:
    """``<outputpath>/<model>/<remark>_<beta>[_<alpha>]/seed_<N>``, the
    directory ``train`` writes for the merged config ``conf``."""
    remark = f"{conf['remark']}_{conf['beta']}"
    if "alpha" in conf:
        remark += f"_{conf['alpha']}"
    return (Path(conf["outputpath"]) / conf.get("model", "Hybrid_VAEModel")
            / remark / f"seed_{conf['seed']}")


# the running sweep trial's early-stop rule: ``sweep`` sets it around an
# in-process trial, and ``train`` asks it after each epoch's saves
_TRIAL_ASSESSOR = None


# ---------------------------------------------------------------------- #
def train(config: str, device=DEFAULT_DEVICE, **kwargs) -> str:
    """Train the recipe in ``config`` (``--key=value`` overrides); returns
    the experiment dir."""
    conf = Config(copy.deepcopy(DEFAULTS))
    conf.update(load_config(config, **kwargs))
    _refuse_later_items(conf)
    feats_dtype = _upload_dtype(conf)
    device = _device(device)
    seed = conf["seed"]
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    outputdir = _experiment_dir(conf)
    outputdir.mkdir(parents=True, exist_ok=True)
    logger = _setup_logger(str(outputdir / "train_caption.log"))
    logger.info(f"Storing files in: {outputdir}")
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                       if device.type == "cuda" else ""))

    vocab = Vocabulary.load(conf["vocab_file"])
    train_ds, _, train_loader, val_loader = _build_dataloaders(conf, vocab)
    conf["data_dim"] = train_ds.data_dim
    total_iters = len(train_loader) * conf["epochs"]
    conf["total_iters"] = total_iters
    val_key2refs = val_loader.refs()
    trainer = Trainer(conf, len(vocab), train_ds.data_dim, device=device,
                      total_iters=total_iters, vocab=vocab)
    apply_pretrained(conf, trainer.model, logger.info)
    if trainer.adversarial is not None:
        logger.info(f"adverse_loss: discriminator from "
                    f"{conf['adverse_loss']['discriminator']} "
                    f"(alpha={trainer.adversarial.get('alpha', 1.0)})")
    aug_prob = conf.get("use_aug_prob")
    plateau = None
    if conf.get("scheduler") == "ReduceLROnPlateau":
        # the epoch scheduler, stepped with the val score
        plateau = ReduceLROnPlateau(
            **{k: v for k, v in conf.get("scheduler_args", {}).items()
               if k in ("mode", "factor", "patience", "threshold")})

    start_epoch, skip_batches, resume_meta, iteration = 1, 0, {}, 0
    if conf.get("resume"):
        # the newest of `last` and the mid-epoch snapshots, by restored step;
        # a mid-epoch resume skips the epoch's consumed batches
        step, name = resume_newest(str(outputdir), trainer)
        if name is not None:
            resume_meta = read_ckpt_steps(str(outputdir))
            nb = max(len(train_loader), 1)
            iteration, start_epoch, skip_batches = step, step // nb + 1, step % nb
            if plateau is not None:
                plateau.load(resume_meta)
            logger.info(f"resumed from {outputdir}/{name} at step {step} → "
                        f"epoch {start_epoch}" + (
                            f" (skipping {skip_batches} consumed batches)"
                            if skip_batches else ""))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(f"{n_params} parameters in total")
    (outputdir / "config.json").write_text(json.dumps(conf, indent=1))
    improved = criterion_improver(conf["improvecriterion"],
                                  initial=resume_meta.get("best_score"))
    stage = partial(_to_device, device=device, feats_dtype=feats_dtype)
    ckpt_every = int(conf.get("checkpoint_every_steps", 0) or 0)
    fault_step = int(conf.get("fault_abort_step", 0) or 0)
    profile_dir, profile_start, prof = conf.get("profile_dir"), None, None
    logger.info("{:^10}\t{:^10}\t{:^10}".format("Epoch", "Train loss",
                                                 "Val score"))
    try:
        with open(outputdir / "metrics.jsonl", "a") as metrics_log:
            for epoch in range(start_epoch, conf["epochs"] + 1):
                epoch_t0 = time.perf_counter()
                train_loader.set_epoch(epoch)
                losses, ntokens, diags = [], [], {}
                # the step's metrics stay on the device; fetched once an epoch
                for batch in train_loader.prefetch(
                        skip_batches=skip_batches if epoch == start_epoch else 0,
                        stage=stage):
                    iteration += 1
                    if profile_dir and profile_start is None:
                        # this run's first step (a resume starts mid-count)
                        profile_start, prof = iteration, Trace(profile_dir)
                    arrays = batch.arrays()
                    if aug_prob is not None:
                        # per-iteration draws, so that a mid-epoch resume
                        # draws the masks of the uninterrupted run
                        arrays["keep_mask"] = augment_keep_mask(
                            batch.cap_ids, aug_prob, np.random.default_rng(
                                (seed + 9) * 1_000_003 + iteration)
                        ).astype(np.float32)
                    m = trainer.step(arrays, iteration, epoch)
                    if prof is not None and iteration >= (profile_start
                                                          + PROFILE_STEPS - 1):
                        prof = _stop_trace(prof, device)
                    losses.append(m["loss"])
                    ntokens.append(m["ntokens"])
                    for k in DIAG_KEYS:
                        if k in m:
                            diags.setdefault(k, []).append(m[k])
                    if ckpt_every and iteration % ckpt_every == 0:
                        # two alternating slots: the save in progress never
                        # destroys the only snapshot
                        slot = f"step_{(iteration // ckpt_every) % 2}"
                        save_checkpoint(str(outputdir), slot, trainer, iteration)
                        write_ckpt_step(str(outputdir), slot, iteration)
                    if fault_step and iteration >= fault_step:
                        raise SystemExit(f"fault_abort_step: injected failure "
                                         f"at step {iteration}")
                if prof is not None:   # a first epoch shorter than the window
                    prof = _stop_trace(prof, device)
                ratios = trainer.ratios(iteration, epoch)
                loss_vals = (torch.stack(losses).double().cpu().numpy()
                             if losses else np.zeros(0))
                ntok = (torch.stack(ntokens).double().cpu().numpy()
                        if ntokens else np.zeros(0))
                score = _validate(trainer.model, val_loader, vocab, val_key2refs,
                                  device, seed, epoch)
                if plateau is not None:
                    before = plateau.scale
                    trainer.optimizer.lr_scale = plateau.step(score)
                    if plateau.scale != before:
                        logger.info(f"ReduceLROnPlateau: lr scale -> "
                                    f"{plateau.scale:.3g}")
                train_loss = float(np.sum(loss_vals * ntok) / max(np.sum(ntok), 1))
                logger.info(f"{epoch:^10}\t{train_loss:^10.3g}\t{score:^10.3g}")
                diag_means = {k: float(np.mean(torch.stack(v).float().cpu().numpy()))
                              for k, v in diags.items()}
                metrics_log.write(json.dumps(
                    {"epoch": epoch, "train_loss": train_loss, "val_cider": score,
                     "ss_ratio": ratios["ss_ratio"],
                     "kl_weight": ratios["kl_weight"],
                     "dis_ratio": ratios["dis_ratio"],
                     **{k: round(v, 5) for k, v in diag_means.items()},
                     # the train loop and the validation decode; the
                     # checkpoint saves come after
                     "epoch_wall_s": round(time.perf_counter() - epoch_t0, 2)})
                    + "\n")
                metrics_log.flush()
                if improved(score):
                    save_checkpoint(str(outputdir), "best", trainer, iteration,
                                    vocab, conf)
                save_checkpoint(str(outputdir), "last", trainer, iteration, vocab,
                                conf)
                extra = {"best_score": improved.best}
                if plateau is not None:
                    extra.update(plateau.state())
                write_ckpt_step(str(outputdir), "last", iteration, **extra)
                for stale in ("step_0", "step_1", "step"):  # superseded by last
                    remove_checkpoint(str(outputdir), stale)
                if _TRIAL_ASSESSOR is not None and _TRIAL_ASSESSOR.assess(score):
                    # the sweep's median rule: this trial's best score is
                    # below the completed trials' at this epoch
                    logger.info(f"assessor: trial stopped early at epoch "
                                f"{epoch} (below median of completed trials)")
                    break
    finally:
        if prof is not None:
            _stop_trace(prof, device)
    return str(outputdir)


def _stop_trace(prof: Trace, device: torch.device) -> None:
    """Let the traced steps' kernels finish, then write the trace."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


# ---------------------------------------------------------------------- #
def evaluate(experiment_path: str, eval_h5_csv: Optional[str] = None,
             eval_caption_file: Optional[str] = None,
             decode_method: Optional[str] = None, beam_size: int = 3,
             num_candidates: int = 1, max_length: Optional[int] = None,
             checkpoint: str = "best", seed: int = 1,
             encoder_int8: bool = False, int8_scheme: str = DEFAULT_INT8_SCHEME,
             distributed: bool = False, decode_dtype: Optional[str] = None,
             tag: str = "", device=DEFAULT_DEVICE, **decode_kwargs):
    """Decode a test set and score it (base_runner.py:199-333): one decode
    per clip (``num_candidates`` with their own noise; a dbs decode's every
    output beam instead), the references from every caption, the first
    candidate scored.  ``encoder_int8`` encodes with the int8 encoder of
    ``int8_scheme``, calibrated on the first eval batch (its precision is
    its own: ``decode_dtype`` then only names the files, as in the JAX
    package).  ``decode_dtype=bfloat16`` decodes with the parameters cast
    (``ops/amp.py``).  ``tag`` suffixes the output files' names.  Returns
    the scores."""
    decode_method = _method_alias(decode_kwargs.pop("method", None),
                                  decode_method)
    if distributed:
        _later("evaluate --distributed", "A19")
    device = _device(device)
    exp = Path(experiment_path)
    conf, vocab, model = load_experiment(str(exp), checkpoint, device=device)
    manifest = eval_h5_csv or conf.get("val_h5_csv") or conf["h5_csv"]
    cap_file = (eval_caption_file or conf.get("val_caption_file")
                or conf["caption_file"])
    info = load_caption_info(cap_file, conf.get("zh", False))
    # one item per clip (caption_dataset.py:20-63); references from all
    ds = CaptionDataset(**_feature_source(manifest), vocabulary=vocab,
                        caption_info=[{**a, "captions": a["captions"][:1]}
                                      for a in info])
    loader = CaptionLoader(ds, conf.get("batch_size", 32))
    gen = torch.Generator(device).manual_seed(seed)
    kw = dict(decode_method=decode_method, beam_size=beam_size,
              max_length=max_length, **decode_kwargs)
    if encoder_int8:
        cb = _to_device(next(iter(loader)), device)
        quant = quant_encoder_for(conf, model, calib=(cb.feats, cb.feat_lens),
                                  **scheme_kwargs(int8_scheme))
        decode = partial(int8_decode_fn(model, quant, **kw), generator=gen)
    else:
        decode = partial(_decode_model(model, decode_dtype).inference_forward,
                         generator=gen, **kw)
    dbs = decode_method == "dbs"
    key2pred: Dict[str, List[str]] = {}
    for aid, cap in _decode_loader(decode, loader, vocab, device,
                                   1 if dbs else num_candidates,
                                   every_beam=dbs):
        key2pred.setdefault(aid, []).append(cap)

    predictions = [
        {"filename": aid,
         "captions" if len(caps) > 1 else "caption":
             [{"caption": c, "tokens": c} for c in caps]
             if len(caps) > 1 else caps[0],
         "tokens": caps[0]}
        for aid, caps in key2pred.items()]
    suffix = "_int8" if encoder_int8 else ""
    if encoder_int8 and int8_scheme != DEFAULT_INT8_SCHEME:
        suffix += int8_scheme
    if decode_dtype and decode_dtype != "float32":
        suffix += f"_{decode_dtype}"
    if tag:
        suffix += f"_{tag}"
    with open(exp / f"eval_output_{decode_method}_{beam_size}{suffix}.json",
              "w") as f:
        json.dump({"predictions": predictions}, f, indent=1)
    scores = score_captions(refs_of(info),
                            {k: [v[0]] for k, v in key2pred.items()},
                            zh=conf.get("zh", False))
    _write_scores(scores, exp / f"scores_{decode_method}_{beam_size}{suffix}.txt")
    return scores


def _decode_model(model, decode_dtype: Optional[str]):
    """``model``, or its copy with float parameters in ``decode_dtype``."""
    dt = resolve_decode_dtype(decode_dtype)
    return model if dt is None else cast_floats_for_decode(model, dt)


def predict(experiment_path: str, h5_csv: str, output: str = "predictions.csv",
            decode_method: Optional[str] = None, beam_size: int = 3,
            checkpoint: str = "best", seed: int = 1,
            method: Optional[str] = None, decode_dtype: Optional[str] = None,
            device=DEFAULT_DEVICE) -> str:
    """The DCASE CSV (base_runner.py:336-395): ``file_name,
    caption_predicted`` for every clip of the manifest ``h5_csv``, the top
    beam, rows sorted.  ``method`` aliases ``decode_method``."""
    decode_method = _method_alias(method, decode_method)
    device = _device(device)
    conf, vocab, model = load_experiment(experiment_path, checkpoint,
                                         device=device)
    src = _feature_source(h5_csv)
    # the clips: the keys of the manifest or of the features alike
    info = [{"audio_id": aid, "captions": [{"tokens": ""}]}
            for aid in next(iter(src.values()))]
    loader = CaptionLoader(CaptionDataset(**src, caption_info=info,
                                          vocabulary=vocab),
                           conf.get("batch_size", 32))
    gen = torch.Generator(device).manual_seed(seed)
    decode = partial(_decode_model(model, decode_dtype).inference_forward,
                     generator=gen, decode_method=decode_method,
                     beam_size=beam_size)
    rows = _decode_loader(decode, loader, vocab, device)
    with open(output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "caption_predicted"])
        w.writerows(sorted(set(rows)))
    return output


def diversity(eval_output: str, train_corpus: Optional[str] = None,
              output: Optional[str] = None, zh: bool = False
              ) -> Dict[str, float]:
    """The diversity suite over an ``eval_output`` JSON
    (utils/diverse_mutil.py): with several candidates a clip, Div1/Div2/
    gDiv1, mBLEU and SelfBLEU (of the first 500 captions), else gDiv1; with
    ``train_corpus`` (a text.json) the Novelty.  Captions are tokenized on
    ingest (``--zh``: by CJK character)."""
    with open(eval_output) as f:
        data = json.load(f)
    caps_by_id: Dict[str, List[str]] = {}
    all_caps: List[str] = []
    for item in data["predictions"]:
        caps = item.get("captions")
        if caps:
            texts = [(c.get("tokens") or c["caption"])
                     if isinstance(c, dict) else c for c in caps]
        else:
            texts = [item.get("tokens") or item["caption"]]
        texts = [" ".join(tokenize(t, zh)) for t in texts]
        caps_by_id[item["filename"]] = texts
        all_caps.extend(texts)
    results: Dict[str, Any] = {}
    if min(len(v) for v in caps_by_id.values()) > 1:
        results.update(eval_div_stats(caps_by_id))
        results["SelfBLEU"] = self_bleu(all_caps[: min(len(all_caps), 500)])
    else:
        results["gDiv1"] = len(set(w for c in all_caps for w in c.split()))
    if train_corpus:
        train_caps = [c["tokens"] for a in load_caption_info(train_corpus, zh)
                      for c in a["captions"]]
        results["Novelty"] = novelty(all_caps, train_caps)
    _print_results(results, output)
    return results


def _print_results(results: Dict[str, Any], output: Optional[str]) -> None:
    text = "\n".join(f"{k}: {v:.4g}" for k, v in results.items())
    print(text)
    if output:
        with open(output, "w") as f:
            f.write(text + "\n")


def ensemble(*experiment_paths: str, eval_h5_csv: Optional[str] = None,
             eval_caption_file: Optional[str] = None,
             decode_method: Optional[str] = None, beam_size: int = 3,
             max_length: int = 20, checkpoint: str = "best",
             output: Optional[str] = None, seed: int = 1,
             method: Optional[str] = None, device=DEFAULT_DEVICE
             ) -> Dict[str, Any]:
    """Probability-averaged ensemble decode across experiment dirs
    (base_runner.py:397-694), scored like ``evaluate``; the data and
    references are the last member's.  ``output`` defaults to
    ``ensemble_scores.txt`` in the first member's dir."""
    decode_method = _method_alias(method, decode_method)
    device = _device(device)
    members, zh = [], None
    for exp_path in experiment_paths:
        conf, vocab, model = load_experiment(exp_path, checkpoint, device=device)
        zh = conf.get("zh", False) if zh is None else zh
        manifest = eval_h5_csv or conf.get("val_h5_csv") or conf["h5_csv"]
        cap_file = (eval_caption_file or conf.get("val_caption_file")
                    or conf["caption_file"])
        info = load_caption_info(cap_file, conf.get("zh", False))
        loader = CaptionLoader(CaptionDataset(
            **_feature_source(manifest), vocabulary=vocab,
            caption_info=[{**a, "captions": a["captions"][:1]} for a in info]),
            conf.get("batch_size", 32))
        members.append(model)
    gen = torch.Generator(device).manual_seed(seed)

    def decode(feats, lens):
        return ensemble_decode(members, feats, lens, decode_method=decode_method,
                               beam_size=beam_size, max_length=max_length,
                               generator=gen)
    key2pred = {aid: [cap] for aid, cap in
                _decode_loader(decode, loader, vocab, device)}
    scores = score_captions(refs_of(info), key2pred, zh=zh)
    if output is None:
        output = str(Path(experiment_paths[0]) / "ensemble_scores.txt")
    _write_scores(scores, output)
    return scores


def human_eval(caption_file: str, output: Optional[str] = None,
               zh: bool = False) -> Dict[str, float]:
    """Leave-one-out accuracy and the diversity ceilings of the reference
    captions (utils/human_eval.py, diverse_mutil_human.py)."""
    key2refs = {a["audio_id"]: [c["tokens"] for c in a["captions"]]
                for a in load_caption_info(caption_file, zh)}
    results = {**human_scores(key2refs), **human_diversity(key2refs)}
    _print_results(results, output)
    return results


# ---------------------------------------------------------------------- #
def scst(experiment_path: str, epochs: int = 10, sample_n: int = 1,
         lr: float = 5e-5, max_length: int = 20, checkpoint: str = "best",
         seed: int = 1, device=DEFAULT_DEVICE, **kwargs) -> str:
    """SCST (``sample_n`` 1, a greedy baseline) or N-SCST (``sample_n`` > 1,
    the leave-one-out baseline) fine-tuning of a trained experiment
    (acvae_tpu/cli/main.py:1452-1506): the weights of ``checkpoint``, a
    fresh optimizer of the recipe's kind at ``lr`` with a constant
    schedule; ``kwargs`` override the recipe.  Writes ``scst_n<N>/``
    (``best.pt`` when the validation CIDEr improves, ``last.pt`` every
    epoch, ``scst.log``), an experiment dir that ``evaluate`` reads."""
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.train.checkpoints import load_weights, save_experiment
    from acvae_tpu_torch.train.scst import make_rollout, scst_train_step
    from acvae_tpu_torch.train.trainer import build_optimizer

    device = _device(device)
    exp = Path(experiment_path)
    conf = Config(copy.deepcopy(DEFAULTS))
    conf.update(json.loads((exp / "config.json").read_text()))
    for k, v in kwargs.items():
        conf.set_path(k, v)
    vocab = Vocabulary.load(str(exp / "vocab.pkl"))
    train_ds, _, train_loader, val_loader = _build_dataloaders(conf, vocab)
    conf.update(optimizer_args={"lr": lr}, scheduler="constant",
                scheduler_args={})
    model = build_model(conf, len(vocab), train_ds.data_dim, device=device)
    load_weights(model, str(exp), checkpoint)
    optimizer = build_optimizer(conf, model.named_parameters(), 1)
    rollout = make_rollout(model, sample_n=int(sample_n),
                           max_length=int(max_length))
    gen = torch.Generator(device).manual_seed(int(seed))
    key2refs, val_key2refs = train_loader.refs(), val_loader.refs()
    outputdir = exp / f"scst_n{sample_n}"
    outputdir.mkdir(exist_ok=True)
    logger = _setup_logger(str(outputdir / "scst.log"))
    improved = criterion_improver("score")
    for epoch in range(1, int(epochs) + 1):
        train_loader.set_epoch(epoch)
        scores = []
        for batch in train_loader.prefetch(stage=partial(_to_device,
                                                         device=device)):
            m = scst_train_step(model, optimizer, rollout, batch.feats,
                                batch.feat_lens, batch.audio_ids, key2refs,
                                vocab, gen, sample_n=int(sample_n))
            scores.append(m["score"])
        score = _validate(model, val_loader, vocab, val_key2refs, device,
                          int(seed), epoch)
        logger.info(f"epoch {epoch}: train CIDEr {float(np.mean(scores)):.3f} "
                    f"val CIDEr {score:.3f}")
        if improved(score):
            save_experiment(str(outputdir), model, conf, vocab, "best")
        save_experiment(str(outputdir), model, conf, vocab, "last")
    return str(outputdir)


def average_checkpoints(experiment_path: str, names: str = "best,last",
                        output_name: str = "avg") -> str:
    """Elementwise weight averaging of same-layout checkpoints of an
    experiment (acvae_tpu/cli/main.py:1349-1389), saved as
    ``<output_name>.pt`` for ``evaluate --checkpoint=<output_name>``."""
    path = _average_checkpoints(experiment_path, names, output_name)
    print(f"averaged {names} -> {path}")
    return str(path)


def diagnose(experiment_path: str, eval_h5_csv: Optional[str] = None,
             eval_caption_file: Optional[str] = None, batches: int = 6,
             batch_size: int = 32, checkpoint: str = "best", seed: int = 0,
             output: Optional[str] = None, device=DEFAULT_DEVICE
             ) -> Dict[str, Any]:
    """Posterior/latent diagnostics of a trained experiment
    (``train/diagnose.py``): the per-dim KL spectrum, active units,
    prior↔posterior agreement, and the teacher-forced CE under the
    posterior and the prior z.  Prints the JSON (and writes ``output``)."""
    from acvae_tpu_torch.train.diagnose import diagnose_experiment

    res = diagnose_experiment(experiment_path, eval_h5_csv, eval_caption_file,
                              batches=int(batches), batch_size=int(batch_size),
                              checkpoint=checkpoint, seed=int(seed),
                              device=_device(device))
    print(json.dumps(res, indent=1))
    if output:
        Path(output).write_text(json.dumps(res, indent=1))
    return res


# ---------------------------------------------------------------------- #
# deployment: the exported decode, its server, features from wavs
def export_model(experiment_path: str, checkpoint: str = "best",
                 decode_method: str = "beam", beam_size: int = 3,
                 max_length: int = 20, t_mel: int = 1024,
                 batch_size: Optional[int] = None,
                 output_dir: Optional[str] = None,
                 platforms: Optional[str] = None,
                 encoder_int8: bool = False,
                 int8_scheme: str = DEFAULT_INT8_SCHEME,
                 decode_dtype: Optional[str] = None, device=DEFAULT_DEVICE,
                 **decode_kwargs) -> str:
    """Export the trained decode to a self-contained ``torch.export``
    artifact (``export.py``; ``acvae_tpu/cli/main.py:1271-1348``):
    ``decode.pt2``, ``meta.json`` and ``vocab.pkl`` in ``output_dir``
    (``<exp>/export`` by default), weights baked in.  Without
    ``batch_size`` the batch is symbolic where the program allows it.
    ``encoder_int8`` bakes the int8 serving encoder of ``int8_scheme``
    (calibrated from bn0's statistics), ``decode_dtype=bfloat16`` the bf16
    decode.  ``platforms`` (``cpu``, ``cuda``; meta.json lists the
    export's device when none is named): a torch artifact is not lowered
    per platform, so each one named is checked by loading the artifact
    there."""
    from torch.export.passes import move_to_device_pass

    from acvae_tpu_torch.export import (build_decode_fn, build_decode_fn_int8,
                                        export_decode, save_exported)

    device = _device(device)
    if isinstance(platforms, str):
        platforms = [p.strip() for p in platforms.split(",") if p.strip()]
    for p in platforms or ():
        if p not in ("cpu", "cuda"):
            raise ValueError(f"platform {p!r} is not a torch device of this "
                             f"port; an artifact loads on cpu and cuda")
        _device(p)
    exp = Path(experiment_path)
    conf, _, model = load_experiment(str(exp), checkpoint, device=device)
    data_dim = int(conf.get("data_dim", 64))
    kwargs = dict(decode_method=decode_method, beam_size=beam_size,
                  max_length=max_length, **decode_kwargs)
    if encoder_int8:
        quant = quant_encoder_for(conf, model, **scheme_kwargs(int8_scheme))
        fn = build_decode_fn_int8(model, quant, **kwargs)
    else:
        fn = build_decode_fn(model, resolve_decode_dtype(decode_dtype), **kwargs)
    t0 = time.perf_counter()
    exported, batch_desc = export_decode(
        fn, t_mel=t_mel, n_mels=data_dim,
        batch=None if batch_size is None else int(batch_size))
    out = output_dir or str(exp / "export")
    path = save_exported(exported, out, {
        "decode_method": decode_method, "beam_size": beam_size,
        "max_length": max_length, "t_mel": t_mel, "n_mels": data_dim,
        "batch": batch_desc, "platforms": list(platforms or [device.type]),
        "encoder_int8": bool(encoder_int8),
        "int8_scheme": int8_scheme if encoder_int8 else None,
        "decode_dtype": str(decode_dtype or "float32"),
        "decode_kwargs": decode_kwargs or None, "noise": fn.noise,
        "checkpoint": checkpoint, "experiment": str(exp)})
    shutil.copy(str(exp / "vocab.pkl"), str(Path(out) / "vocab.pkl"))
    for p in platforms or ():    # the artifact must load there
        move_to_device_pass(torch.export.load(path), _device(p))
    print(f"exported {decode_method}-{beam_size} decode (batch={batch_desc}, "
          f"T={t_mel}) -> {path} in {time.perf_counter() - t0:.1f} s")
    return out


def serve(experiment_path: Optional[str] = None, device=DEFAULT_DEVICE,
          **kwargs) -> None:
    """The micro-batching caption server (``serve.py::serve``;
    ``acvae_tpu/cli/main.py:1146-1206``) over an experiment dir (several
    joined by commas: the ensemble) or, with ``--exported=<dir>``, over an
    ``export_model`` artifact, whose decode flags are baked: changing one
    raises.  ``kwargs``: ``--host``, ``--port``, ``--max_wait_ms`` and
    ``CaptionService``'s arguments (``--batch_size``, ``--decode_method``,
    ``--encoder_int8``, ``--seed``, the decode kwargs, ...), each at its
    default when absent."""
    from acvae_tpu_torch.serve import serve as serve_http

    serve_http(experiment_path, device=_device(device), **kwargs)


def prepare_data(wav_dir: str, output_npz: str, output_csv: str,
                 sr: int = 32000, n_fft: int = 1024, hop_length: int = 320,
                 n_mels: int = 64, fmin: float = 50.0,
                 batch_seconds: float = 40.0, device=DEFAULT_DEVICE) -> str:
    """A directory of wavs -> log-mels in ``output_npz`` (one array a clip,
    named by its file) and the TSV manifest ``output_csv``, the layout of
    ``make_synthetic`` (``acvae_tpu/cli/main.py:1987-2029``, which writes
    HDF5).  Integer samples become floats, channels are averaged, another
    rate is resampled by linear interpolation, and each clip, padded to the
    hop, goes through ``ops/audio.py::log_mel_spectrogram`` on ``device``
    (no ``top_db`` floor), cut to ``1 + len // hop`` frames.
    ``batch_seconds`` is accepted, unused, as in the JAX package."""
    from scipy.io import wavfile

    from acvae_tpu_torch.ops.audio import log_mel_spectrogram

    if not str(output_npz).endswith(".npz"):
        raise ValueError(f"output_npz must end in .npz (the port's feature "
                         f"files are numpy archives), got {output_npz!r}")
    device = _device(device)
    wavs = sorted(Path(wav_dir).glob("*.wav"))
    if not wavs:
        raise FileNotFoundError(f"no .wav files in {wav_dir}")
    mels = {}
    for path in wavs:
        file_sr, data = wavfile.read(str(path))
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        if data.ndim > 1:
            data = data.mean(axis=1)
        if file_sr != sr:
            new_len = int(len(data) / file_sr * sr)
            data = np.interp(np.linspace(0, len(data) - 1, new_len),
                             np.arange(len(data)), data)
        n_frames = 1 + len(data) // hop_length
        wave = np.pad(data.astype(np.float32), (0, (-len(data)) % hop_length))
        mel = log_mel_spectrogram(
            torch.from_numpy(wave)[None].to(device), sr=sr, n_fft=n_fft,
            hop_length=hop_length, n_mels=n_mels, fmin=fmin, top_db=None)
        mels[path.name] = mel[0, :n_frames].cpu().numpy()
    Path(output_npz).parent.mkdir(parents=True, exist_ok=True)
    np.savez(output_npz, **mels)
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["audio_id", "hdf5_path"])
        w.writerows([aid, str(output_npz)] for aid in mels)
    print(f"wrote {len(mels)} clips to {output_npz}")
    return output_csv


# ---------------------------------------------------------------------- #
# the auxiliary training stack: the discriminator of adverse_loss, the GE2E
# caption embedder, the global sentence VAE and the embedding trees
def _discriminator_model(mode: str, conf: Config, vocab_size: int,
                         data_dim: Optional[int], device: torch.device):
    """The seeded trainer module of ``train_discriminator``: the encoder
    of the recipe and the discriminator (aud2cap), or the discriminator
    alone (cap2cap)."""
    from acvae_tpu_torch.models.discriminator import (
        Aud2CapDiscriminatorTrainer, Cap2CapDiscriminatorTrainer,
        DiscriminatorRNNModel)
    from acvae_tpu_torch.models.encoders import build_encoder

    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(conf["seed"])
        # cap2cap reads no audio: no aud_proj, as in the JAX package's tree
        audio_dim = conf["discriminator_audio_dim"] if mode == "aud2cap" else None
        dscrm = DiscriminatorRNNModel(vocab_size, audio_dim=audio_dim,
                                      device=device,
                                      **conf.get("discriminator_args", {}))
        if mode == "cap2cap":
            return Cap2CapDiscriminatorTrainer(dscrm, conf.get("uttnumbers", 5))
        enc = build_encoder(conf["encodermodel"], conf.get("encoder_args", {}),
                            data_dim, device)
        return Aud2CapDiscriminatorTrainer(enc, dscrm)


def train_discriminator(config: str, mode: str = "aud2cap",
                        device=DEFAULT_DEVICE, **kwargs) -> str:
    """Train the caption discriminator (acvae_tpu/cli/main.py:1509-1656):
    ``aud2cap`` matches audio to captions (negatives: the batch's captions
    rolled by one), ``cap2cap`` caption to caption over Stage1Dataset
    groups of the seeded 90/10 audio split.  BCE over both, the recipe's
    optimizer at ``optimizer_args.lr`` (default 1e-3) with the
    ``max_grad_norm`` clip; ``best`` on the validation loss (the train loss
    when the held-out split yields no batch).  Writes
    ``<outputpath>/DiscriminatorModel/<remark>_<mode>/seed_<N>/``
    (``train_dscrm.log``, ``config.json``, ``vocab.pkl``, ``best.pt``,
    ``last.pt``), the directory ``adverse_loss.discriminator`` names."""
    from acvae_tpu_torch.data.aux_datasets import Stage1Dataset
    from acvae_tpu_torch.losses.wrappers import bce_logits_loss
    from acvae_tpu_torch.train.checkpoints import save_experiment
    from acvae_tpu_torch.train.optim import OptaxChain

    if mode not in ("aud2cap", "cap2cap"):
        raise ValueError(f"mode {mode!r}: aud2cap or cap2cap")
    conf = Config(copy.deepcopy(DEFAULTS))
    conf.update(load_config(config, **kwargs))
    device = _device(device)
    seed = conf["seed"]
    outputdir = (Path(conf["outputpath"]) / "DiscriminatorModel"
                 / f"{conf['remark']}_{mode}" / f"seed_{seed}")
    outputdir.mkdir(parents=True, exist_ok=True)
    logger = _setup_logger(str(outputdir / "train_dscrm.log"))
    vocab = Vocabulary.load(conf["vocab_file"])
    conf["discriminator_mode"] = mode
    conf["discriminator_audio_dim"] = conf.get("encoder_args", {}).get(
        "embed_size", 512)
    data_dim = None
    if mode == "aud2cap":
        train_ds, _, train_loader, val_loader = _build_dataloaders(conf, vocab)
        conf["data_dim"] = data_dim = train_ds.data_dim
    else:
        info = load_caption_info(conf["caption_file"], conf.get("zh", False))
        perm = np.random.default_rng(seed).permutation(len(info))
        n_tr = max(1, int(len(info) * 0.9))
        utt, per_batch = conf.get("uttnumbers", 5), conf.get("audios_per_batch", 8)
        s1 = Stage1Dataset([info[i] for i in perm[:n_tr]], vocab, uttnumbers=utt)
        s1_val = Stage1Dataset([info[i] for i in perm[n_tr:]], vocab,
                               uttnumbers=utt)
        s1.require_batch(per_batch, seed)
    model = _discriminator_model(mode, conf, len(vocab), data_dim, device)
    lr = conf.get("optimizer_args", {}).get("lr", 1e-3)
    optimizer = OptaxChain(model.named_parameters(), conf.get("optimizer", "Adam"),
                           lambda step: lr,
                           max_grad_norm=conf.get("max_grad_norm", 1.0))

    def batches(epoch: int, train: bool):
        if mode == "aud2cap":
            loader = train_loader if train else val_loader
            loader.set_epoch(epoch)
            return ((b.feats, b.feat_lens, b.caps, b.cap_lens) for b in
                    loader.prefetch(stage=partial(_to_device, device=device)))
        return (tuple(torch.from_numpy(a).to(device) for a in b) for b in
                (s1 if train else s1_val).batches(per_batch, seed, epoch))

    def loss_of(args, train: bool):
        pos, neg = model(*args, train=train)
        probs = torch.cat([pos, neg])
        labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        return bce_logits_loss(probs, labels), probs, labels

    (outputdir / "config.json").write_text(json.dumps(conf, indent=1))
    improved = criterion_improver("loss")   # on the validation loss
    logger.info("{:^10}\t{:^12}\t{:^10}\t{:^10}".format(
        "Epoch", "Train loss", "Acc", "Val loss"))
    for epoch in range(1, conf["epochs"] + 1):
        losses, accs = [], []
        for args in batches(epoch, True):
            optimizer.zero_grad()
            loss, probs, labels = loss_of(args, True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            accs.append(((probs > 0.5) == (labels > 0.5)).float().mean())
        with torch.no_grad():
            vlosses = [loss_of(args, False)[0] for args in batches(epoch, False)]
        loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        acc = float(np.mean(torch.stack(accs).cpu().numpy()))
        # a tiny corpus can leave the held-out split without a batch
        vloss = (float(np.mean(torch.stack(vlosses).cpu().numpy()))
                 if vlosses else loss)
        logger.info(f"{epoch:^10}\t{loss:^12.4g}\t{acc:^10.3f}\t{vloss:^10.4g}")
        if improved(vloss):
            save_experiment(str(outputdir), model, conf, vocab, "best")
        save_experiment(str(outputdir), model, conf, vocab, "last")
    return str(outputdir)


def _stage1_models(vocab_size: int, embed_size: int, seed: int,
                   device: torch.device):
    """The seeded stage-1 embedder and GE2E loss of ``stage1``."""
    from acvae_tpu_torch.models.stage1 import GE2ELoss, Stage1Encoder

    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed)
        return (Stage1Encoder(vocab_size, embed_size=embed_size, device=device),
                GE2ELoss(device=device))


def _load_stage1(stage1_dir: str, vocab_size: int, embed_size: int,
                 device: torch.device):
    from acvae_tpu_torch.models.stage1 import Stage1Encoder

    enc = Stage1Encoder(vocab_size, embed_size=embed_size, device=device)
    ckpt = torch.load(Path(stage1_dir) / "stage1_params.pt", map_location="cpu",
                      weights_only=True)
    enc.load_state_dict(ckpt["state_dict"], strict=True)
    return enc


def stage1(caption_file: str, vocab_file: str,
           output_dir: str = "experiments/stage1", epochs: int = 20,
           audios_per_batch: int = 16, uttnumbers: int = 5,
           embed_size: int = 512, lr: float = 1e-3, seed: int = 1,
           zh: bool = False, device=DEFAULT_DEVICE) -> str:
    """GE2E pretraining of the stage-1 caption embedder
    (acvae_tpu/cli/main.py:1658-1725, runners/stage1_runner.py): batches of
    ``audios_per_batch`` × ``uttnumbers`` captions; optax's ``sgd(lr,
    momentum=0.9)`` on two groups, each clipped apart (the embedder at 3.0,
    the loss's w/b at 1.0).  Writes ``stage1.log`` and
    ``stage1_params.pt`` (the embedder with its BatchNorm statistics) into
    ``output_dir``."""
    from acvae_tpu_torch.data.aux_datasets import Stage1Dataset
    from acvae_tpu_torch.train.optim import OptaxChain

    device = _device(device)
    info = load_caption_info(caption_file, zh)
    vocab = Vocabulary.load(vocab_file)
    ds = Stage1Dataset(info, vocab, uttnumbers=uttnumbers)
    ds.require_batch(audios_per_batch, seed)
    enc, loss_mod = _stage1_models(len(vocab), embed_size, seed, device)
    opts = [OptaxChain(m.named_parameters(), "SGD", lambda step: lr,
                       max_grad_norm=clip, momentum=0.9)
            for m, clip in ((enc, 3.0), (loss_mod, 1.0))]
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    logger = _setup_logger(str(outdir / "stage1.log"))
    for epoch in range(1, epochs + 1):
        losses = []
        for caps, lens in ds.batches(audios_per_batch, seed, epoch):
            emb = enc(torch.from_numpy(caps).to(device),
                      torch.from_numpy(lens).to(device), train=True)
            loss = loss_mod(emb.reshape(audios_per_batch, uttnumbers, -1))
            for opt in opts:
                opt.zero_grad()
            loss.backward()
            for opt in opts:
                opt.step()
            losses.append(loss.detach())
        mean = np.mean([float(v) for v in torch.stack(losses).cpu()])
        logger.info(f"epoch {epoch}: GE2E loss {mean:.4f}")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in enc.state_dict().items()}},
               outdir / "stage1_params.pt")
    return str(outdir)


def stage1_test(stage1_dir: str, caption_file: str, vocab_file: str,
                audios_per_batch: int = 16, uttnumbers: int = 4,
                epochs: int = 1, embed_size: int = 512, seed: int = 1,
                device=DEFAULT_DEVICE) -> float:
    """Caption-verification EER of a stage-1 embedder
    (acvae_tpu/cli/main.py:1727-1782): each batch's groups split in half,
    the first half the enrollment (its centroids), the second the
    verification; ``equal_error_rate`` of their similarities, averaged over
    the batches of ``epochs`` reshuffles and printed.  ``uttnumbers`` must
    be even."""
    from acvae_tpu_torch.data.aux_datasets import Stage1Dataset
    from acvae_tpu_torch.models.stage1 import (equal_error_rate, get_centroids,
                                               get_cossim)

    if uttnumbers % 2:
        raise ValueError("uttnumbers must be even for enroll/verify "
                         "halves (stage1_runner.py:160)")
    device = _device(device)
    vocab = Vocabulary.load(vocab_file)
    ds = Stage1Dataset(load_caption_info(caption_file), vocab,
                       uttnumbers=uttnumbers)
    enc = _load_stage1(stage1_dir, len(vocab), embed_size, device)
    half, A = uttnumbers // 2, audios_per_batch

    def embed(caps, lens):
        return enc(caps.reshape(-1, caps.shape[-1]), lens.reshape(-1),
                   train=False).reshape(A, half, -1)

    eers = []
    with torch.no_grad():
        for epoch in range(epochs):
            for caps, lens in ds.batches(A, seed, epoch):
                caps = torch.from_numpy(caps).to(device).reshape(A, uttnumbers, -1)
                lens = torch.from_numpy(lens).to(device).reshape(A, uttnumbers)
                enr = embed(caps[:, :half], lens[:, :half])
                ver = embed(caps[:, half:], lens[:, half:])
                sim = get_cossim(ver, get_centroids(enr))
                eers.append(equal_error_rate(sim)[0])
    avg = float(np.mean(eers)) if eers else float("nan")
    print(f"avg EER over {len(eers)} batches: {avg:.4f}")
    return avg


def extract_embedding(stage1_dir: str, caption_file: str, vocab_file: str,
                      output_dir: str, embed_size: int = 512,
                      device=DEFAULT_DEVICE) -> str:
    """``<output_dir>/<audio_id>/<i>.npy``, the stage-1 embedding of each
    caption (padded to 22 ids), and ``caption.npy``, their mean: the tree
    ``embedding_path`` reads (acvae_tpu/cli/main.py:1784-1816)."""
    device = _device(device)
    vocab = Vocabulary.load(vocab_file)
    enc = _load_stage1(stage1_dir, len(vocab), embed_size, device)
    out_root = Path(output_dir)
    with torch.no_grad():
        for audio in load_caption_info(caption_file):
            aid_dir = out_root / audio["audio_id"]
            aid_dir.mkdir(parents=True, exist_ok=True)
            caps, lens = [], []
            for cap in audio["captions"]:
                ids = ([START_IDX] + [vocab(t) for t in cap["tokens"].split()]
                       + [END_IDX])
                caps.append(np.pad(np.asarray(ids[:22], np.int32),
                                   (0, max(0, 22 - len(ids)))))
                lens.append(min(len(ids), 22))
            emb = enc(torch.from_numpy(np.stack(caps)).to(device),
                      torch.tensor(lens, device=device), train=False)
            emb = emb.cpu().numpy()
            for i in range(emb.shape[0]):
                np.save(aid_dir / f"{i}.npy", emb[i])
            np.save(aid_dir / "caption.npy", emb.mean(0))
    return str(out_root)


def global_vae(caption_file: str, vocab_file: str,
               output_dir: str = "experiments/global_vae", epochs: int = 20,
               batch_size: int = 64, latent_size: int = 512, lr: float = 5e-4,
               kl_weight: float = 0.5, seed: int = 1,
               device=DEFAULT_DEVICE) -> str:
    """Pretrain the global sentence VAE on the caption corpus
    (acvae_tpu/cli/main.py:1818-1877): CE + ``kl_weight``·KL against
    N(0, 1), the gradient clipped at 1.0, then Adam.  Writes
    ``global_vae.log`` and ``global_vae_params.pt``, which ``train``'s
    ``pretrained_global`` merges by name."""
    from acvae_tpu_torch.data.aux_datasets import CaptionCorpus
    from acvae_tpu_torch.models.global_vae import GlobalSentenceVAE
    from acvae_tpu_torch.ops.losses import cross_entropy, normal_kl_loss
    from acvae_tpu_torch.ops.masked import length_mask
    from acvae_tpu_torch.train.optim import OptaxChain

    device = _device(device)
    vocab = Vocabulary.load(vocab_file)
    corpus = CaptionCorpus(load_caption_info(caption_file), vocab)
    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed)
        model = GlobalSentenceVAE(len(vocab), latent_size=latent_size,
                                  device=device)
    optimizer = OptaxChain(model.named_parameters(), "Adam", lambda step: lr,
                           max_grad_norm=1.0)
    gen = torch.Generator(device).manual_seed(seed + 2)
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    logger = _setup_logger(str(outdir / "global_vae.log"))
    for epoch in range(1, epochs + 1):
        losses = []
        for caps, lens in corpus.batches(batch_size, seed=seed, epoch=epoch):
            caps = torch.from_numpy(caps).to(device)
            lens = torch.from_numpy(lens).to(device)
            out = model(caps, lens, train=True, generator=gen)
            mask = length_mask(lens - 1, caps.shape[1] - 1)
            ce = cross_entropy(out["logits"], caps[:, 1:], mask)
            kl = normal_kl_loss(out["mu"], out["logvar"],
                                torch.zeros_like(out["mu"]),
                                torch.zeros_like(out["logvar"]))
            loss = ce + kl_weight * kl
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        mean = np.mean([float(v) for v in torch.stack(losses).cpu()])
        logger.info(f"epoch {epoch}: loss {mean:.4f}")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}},
               outdir / "global_vae_params.pt")
    return str(outdir)


def export_embeddings(embedding_dir: str, output_prefix: str) -> str:
    """``<output_prefix>_vectors.tsv`` and ``_metadata.tsv`` (audio_id,
    cap_idx) of an embedding tree, for TensorBoard's projector
    (acvae_tpu/cli/main.py:1915-1933)."""
    vecs, labels = [], []
    for audio_dir in sorted(Path(embedding_dir).iterdir()):
        if not audio_dir.is_dir():
            continue
        for npy in sorted(audio_dir.glob("[0-9]*.npy")):
            vecs.append(np.load(npy))
            labels.append(f"{audio_dir.name}\t{npy.stem}")
    np.savetxt(f"{output_prefix}_vectors.tsv", np.stack(vecs), delimiter="\t")
    with open(f"{output_prefix}_metadata.tsv", "w") as f:
        f.write("audio_id\tcap_idx\n")
        f.write("\n".join(labels) + "\n")
    print(f"wrote {len(vecs)} embeddings")
    return output_prefix


def extract_sentence_embedding(caption_file: str, vocab_file: str,
                               embedding_source: str, output_dir: str,
                               device=DEFAULT_DEVICE) -> str:
    """Per-caption sentence embeddings, the mean of the caption's word
    vectors (acvae_tpu/cli/main.py:2457-2498): ``<output_dir>/<audio_id>/
    <i>.npy`` and the per-audio mean ``caption.npy``.  ``embedding_source``
    is a ``.npy`` or pickled [vocab, dim] matrix, a GloVe/fastText text
    file or a gensim model (``train/pretrained.py::load_word_embeddings``),
    or a local HuggingFace transformer directory (its mean-pooled last
    hidden states, computed on ``device``; needs the ``transformers``
    package).  The word-vector means are host numpy."""
    from acvae_tpu_torch.train.pretrained import load_word_embeddings

    src = Path(embedding_source)
    if src.is_dir() and (src / "config.json").exists():
        return _extract_hf_sentence_embedding(caption_file, embedding_source,
                                              output_dir, device)
    vocab = Vocabulary.load(vocab_file)
    matrix = load_word_embeddings(embedding_source, vocab)
    out_root = Path(output_dir)
    n = 0
    for audio in load_caption_info(caption_file):
        aid_dir = out_root / audio["audio_id"]
        aid_dir.mkdir(parents=True, exist_ok=True)
        embs = []
        for i, cap in enumerate(audio["captions"]):
            words = (cap.get("tokens")
                     or " ".join(tokenize(cap["caption"]))).split()
            ids = [vocab(w) for w in words]
            emb = (matrix[ids].mean(0) if ids
                   else np.zeros(matrix.shape[1], np.float32))
            np.save(aid_dir / f"{i}.npy", emb.astype(np.float32))
            embs.append(emb)
            n += 1
        np.save(aid_dir / "caption.npy", np.mean(embs, axis=0).astype(np.float32))
    print(f"wrote {n} caption embeddings under {output_dir}")
    return output_dir


def _extract_hf_sentence_embedding(caption_file: str, model_dir: str,
                                   output_dir: str, device) -> str:
    """Mean-pooled last hidden states of a local HF transformer over the
    real tokens (the reference's utils/bert SentenceTransformer pooling)."""
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as e:
        raise ImportError(f"{model_dir} is a HuggingFace model directory; "
                          f"embedding with it needs the transformers package, "
                          f"which is not installed") from e
    tok = AutoTokenizer.from_pretrained(model_dir)
    mdl = AutoModel.from_pretrained(model_dir).eval().to(device)
    out_root = Path(output_dir)
    n = 0
    with torch.no_grad():
        for audio in load_caption_info(caption_file):
            aid_dir = out_root / audio["audio_id"]
            aid_dir.mkdir(parents=True, exist_ok=True)
            texts = [c.get("caption") or c["tokens"] for c in audio["captions"]]
            enc = {k: v.to(device) for k, v in tok(
                texts, return_tensors="pt", padding=True,
                truncation=True).items()}
            hidden = mdl(**enc).last_hidden_state
            m = enc["attention_mask"].unsqueeze(-1).float()
            emb = ((hidden * m).sum(1) / m.sum(1).clamp(min=1)).cpu().numpy()
            emb = emb.astype(np.float32)
            for i in range(emb.shape[0]):
                np.save(aid_dir / f"{i}.npy", emb[i])
                n += 1
            np.save(aid_dir / "caption.npy", emb.mean(0))
    print(f"wrote {n} HF caption embeddings under {output_dir}")
    return output_dir


# ---------------------------------------------------------------------- #
# the hyper-parameter sweep
TRIAL_POLL_S = 5.0   # an isolated trial's metrics.jsonl is read this often


def _sweep_space(space) -> Dict[str, List[Any]]:
    """A search space: a mapping already read, a YAML file or inline YAML;
    each value must be a candidate list."""
    if isinstance(space, dict):
        sp = space
    elif Path(str(space)).exists():
        with open(str(space)) as f:
            sp = safe_load(f)
    else:
        sp = safe_load(str(space))
    sp = _fix_yaml11_floats(sp)
    if not isinstance(sp, dict) or not all(isinstance(v, list)
                                           for v in sp.values()):
        raise ValueError("search space must be a mapping of config key -> "
                         f"candidate list, got: {sp!r}")
    return sp


def _sweep_trials(param, values, space, mode: str, n_trials, seed: int):
    """(trials, advisor): the overrides of each trial, None where the
    sequential advisor suggests it once the earlier trials have run."""
    from acvae_tpu_torch.train.sweep_advisor import AnnealAdvisor, TPEAdvisor

    if space is None:
        if param is None or values is None:
            raise ValueError("either --space or --param/--values")
        if mode in ("tpe", "anneal"):
            raise ValueError(f"--mode={mode} needs a --space search space; "
                             "--param/--values runs the literal list")
        raws = (values if isinstance(values, (list, tuple))
                else str(values).split(","))
        return [{param: _fix_yaml11_floats(_coerce(r))} for r in raws], None
    sp = _sweep_space(space)
    names = list(sp)
    if mode == "random":
        rng = np.random.default_rng(seed)
        combos = [tuple(sp[n][int(rng.integers(len(sp[n])))] for n in names)
                  for _ in range(int(n_trials or 10))]
        return [dict(zip(names, c)) for c in combos], None
    if mode in ("tpe", "anneal"):
        k = int(n_trials or 10)
        advisor = (TPEAdvisor(sp, seed=seed) if mode == "tpe"
                   else AnnealAdvisor(sp, seed=seed, n_trials=k))
        return [None] * k, advisor
    combos = list(itertools.product(*[sp[n] for n in names]))
    if n_trials:
        combos = combos[:int(n_trials)]
    return [dict(zip(names, c)) for c in combos], None


def _trial_subprocess(config: str, opts: Dict[str, Any], stopper, metric: str,
                      device) -> str:
    """One sweep trial as its own ``python -m acvae_tpu_torch.cli train``
    process in the repo root, given ``--device`` (a CPU trial is also hidden
    from every card): memory returns to the system when it exits.  The
    trial's new ``metrics.jsonl`` lines feed ``stopper`` as the in-process
    hook does, read every ``TRIAL_POLL_S`` and when the child ends; a stop
    terminates the child (its ``best``/``last`` are saved before the
    question is asked).  Returns the trial's experiment dir."""
    repo_root = Path(__file__).resolve().parents[2]
    merged = Config(copy.deepcopy(DEFAULTS))
    merged.update(load_config(config, **opts))
    # train resolves a relative outputpath against its own cwd
    exp_dir = repo_root / _experiment_dir(merged)
    metrics_path = exp_dir / "metrics.jsonl"
    # metrics.jsonl appends across runs: only this trial's lines count
    seen = (len(metrics_path.read_text().splitlines())
            if metrics_path.exists() else 0)
    argv = [sys.executable, "-m", "acvae_tpu_torch.cli", "train",
            str(Path(config).resolve())]
    for k, v in opts.items():
        argv.append(f"--{k}=" + (json.dumps(v) if isinstance(v, (dict, list, bool))
                                 else str(v)))
    argv.append(f"--device={device}")
    env = dict(os.environ)
    if torch.device(device).type == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(argv, cwd=str(repo_root), env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        stopped = False
        try:
            while True:
                try:
                    rc = proc.wait(timeout=TRIAL_POLL_S)
                except subprocess.TimeoutExpired:
                    rc = None
                if metrics_path.exists():
                    # whole lines only: the child may be writing the next
                    lines = metrics_path.read_text().split("\n")[:-1]
                    for line in lines[seen:]:
                        rec = json.loads(line)
                        if metric in rec and stopper is not None \
                                and stopper.assess(rec[metric]):
                            print(f"assessor: trial stopped early at epoch "
                                  f"{rec.get('epoch')} (below median of "
                                  f"completed trials)")
                            proc.terminate()
                            try:
                                proc.wait(timeout=60)
                            except subprocess.TimeoutExpired:
                                proc.kill()
                            stopped = True
                            break
                    seen = len(lines)
                if stopped or rc is not None:
                    break
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if not stopped and proc.returncode != 0:
            err.seek(0)
            tail = "\n".join(err.read().splitlines()[-20:])
            raise RuntimeError(f"sweep trial exited {proc.returncode}; see "
                               f"{exp_dir}/train_caption.log\n{tail}")
    return str(exp_dir)


def sweep(config: str, param: Optional[str] = None, values=None, space=None,
          mode: str = "grid", n_trials: Optional[int] = None,
          metric: str = "val_cider", seed: int = 0,
          assessor: Optional[str] = None, assessor_min_trials: int = 3,
          assessor_min_epochs: int = 2, isolate_trials: bool = False,
          device=DEFAULT_DEVICE, **kwargs) -> Dict[str, Any]:
    """Hyper-parameter sweep over ``train`` (acvae_tpu/cli/main.py:2272-2454,
    the reference's NNI search made local).  ``--param=beta
    --values=0.3,0.5`` runs the listed values; ``--space`` (a YAML file or
    inline YAML mapping each config key, dotted keys reaching nested ones,
    to its candidates) runs ``--mode=grid`` (the cartesian product, cut to
    ``--n_trials``), ``random`` (``--n_trials`` joint draws with
    ``--seed``), ``tpe`` or ``anneal`` (``train/sweep_advisor.py``: each
    trial's best ``--metric`` feeds the next suggestion).
    ``--assessor=median`` stops a trial whose best score at an epoch is
    below the median of the completed trials' running means there (from
    ``--assessor_min_epochs``, after ``--assessor_min_trials`` completed);
    a stopped trial is marked ``"stopped_early"``.  ``--isolate_trials``
    runs each trial as its own ``train`` process on ``--device``.  Other
    ``--key=value`` flags override the recipe of every trial.  Prints the
    JSON summary (each trial's best, experiment dir and overrides; the best
    trial) and returns the results."""
    from acvae_tpu_torch.train.sweep_advisor import MedianStopAssessor

    global _TRIAL_ASSESSOR
    trials, advisor = _sweep_trials(param, values, space, mode, n_trials,
                                    int(seed))
    # a swept key the config never reads varies nothing: warn (keys read
    # with .get(), such as free_bits, legitimately miss from the file)
    try:
        merged = Config(copy.deepcopy(DEFAULTS))
        merged.update(load_config(config, **kwargs))
    except OSError:
        merged = None   # train raises its own error
    swept = ({param} if param is not None
             else set().union(*[set(t) for t in trials if t]) if trials
             else set())
    for k in sorted(swept) if merged is not None else ():
        sentinel = object()
        if merged.get_path(k, sentinel) is sentinel:
            print(f"# WARNING: swept key {k!r} is not present in the merged "
                  f"config — if it is a typo (e.g. 'lr' vs "
                  f"'optimizer_args.lr') every trial will train identically",
                  file=sys.stderr)
    stopper = None
    if assessor == "median":
        stopper = MedianStopAssessor(min_trials=int(assessor_min_trials),
                                     min_epochs=int(assessor_min_epochs))
    elif assessor is not None:
        raise ValueError(f"unknown --assessor={assessor!r} (median)")
    results: Dict[str, Any] = {}
    history = []   # (overrides, best metric) for the sequential advisors
    for t, overrides in enumerate(trials):
        if overrides is None:
            overrides = advisor.suggest(history)
        tag = "t{}_{}".format(t, "_".join(f"{k.split('.')[-1]}={v}"
                                          for k, v in overrides.items()))
        print(f"=== sweep trial {t}: {overrides} ===")
        opts = {**overrides, "remark": f"sweep_{tag}", **kwargs}
        if stopper is not None:
            stopper.trial_begin()
        if isolate_trials:
            exp_dir = _trial_subprocess(config, opts, stopper, metric, device)
        else:
            _TRIAL_ASSESSOR = stopper
            try:
                exp_dir = train(config, device=device, **opts)
            finally:
                _TRIAL_ASSESSOR = None
        recs = [json.loads(line) for line in
                (Path(exp_dir) / "metrics.jsonl").read_text().splitlines()]
        if not recs or metric not in recs[-1]:
            raise ValueError(f"--metric={metric!r} not in {exp_dir}/"
                             f"metrics.jsonl; available: "
                             f"{sorted(recs[-1]) if recs else []}")
        best = max(r[metric] for r in recs)
        history.append((overrides, best))
        results[tag] = {"best": best, "exp_dir": exp_dir, "params": overrides}
        if stopper is not None:
            if stopper.last_stop:
                results[tag]["stopped_early"] = True
            stopper.trial_end()
    _warn_identical_trials(results)
    best_tag = max(results, key=lambda k: results[k]["best"])
    print(json.dumps({"results": results, "best": best_tag,
                      "best_params": results[best_tag]["params"]}, indent=1))
    return results


def _warn_identical_trials(results: Dict[str, Any]) -> None:
    """Warn when trials with different overrides wrote byte-identical
    metric trajectories (the swept keys never reached training)."""
    trajs = {}
    for tag, r in results.items():
        try:
            lines = [json.loads(line) for line in
                     (Path(r["exp_dir"]) / "metrics.jsonl").read_text().splitlines()]
        except OSError:
            continue
        for rec in lines:    # wall time differs between identical runs
            rec.pop("epoch_wall_s", None)
        trajs[tag] = json.dumps(lines, sort_keys=True)
    if len(trajs) > 1 and len(set(trajs.values())) == 1 and len(
            {json.dumps(r["params"], sort_keys=True, default=str)
             for r in results.values()}) > 1:
        print("# WARNING: all trials produced byte-identical metric "
              "trajectories despite different overrides — the swept key(s) "
              "likely never reach training (check the config path, e.g. "
              "optimizer_args.lr not lr)", file=sys.stderr)


# ---------------------------------------------------------------------- #
# reference checkpoints, results across seeds, corpus files, the device
def import_torch(pth_path: str, config: str, output_dir: str, vocab_file: str,
                 data_dim: Optional[int] = None, mel_bucket: int = 64,
                 device=DEFAULT_DEVICE) -> Dict[str, int]:
    """A reference-trained torch checkpoint (``{"model": state_dict}`` or a
    bare state dict, DDP's ``module.`` prefix or not) as a port experiment
    (``config.json``, ``vocab.pkl``, ``best.pt``) that ``evaluate``,
    ``predict``, ``serve`` and ``export_model`` read
    (acvae_tpu/cli/main.py:1031-1097).  The port's modules keep the
    reference's torch names, so the tensors merge by name and shape,
    parameters and buffers apart; a key the model lacks or a shape that
    differs is logged and skipped (the reference's policy), and the rest of
    the model keeps its seeded initialisation.  The encoder's
    ``stem_pad_lanes`` (the port's zero lanes of a one-lane stem, which no
    reference dict holds) is not counted.  ``data_dim``: the flag, else the
    config's, else 64; ``vocab_file`` is this package's pickle (``cli
    build_vocab`` on the same text.json).  ``mel_bucket`` is read and
    ignored: the JAX package initialises on a batch of that many frames,
    the port needs none.  Returns the four counts."""
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.train.checkpoints import save_experiment
    from acvae_tpu_torch.train.pretrained import (merge_pretrained,
                                                  read_torch_state_dict)

    device = _device(device)
    conf = load_config(config)
    conf.setdefault("seed", 1)
    vocab = Vocabulary.load(vocab_file)
    log = logging.getLogger("acvae_tpu_torch").info
    sd = read_torch_state_dict(pth_path)
    conf["data_dim"] = int(data_dim if data_dim is not None
                           else conf.get("data_dim", 64))
    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(conf["seed"])
        model = build_model(conf, len(vocab), conf["data_dim"], device=device)
    state = model.state_dict()
    params = {n for n, _ in model.named_parameters()}
    counts = {}
    for col, names in (("params", [k for k in state if k in params]),
                       ("stats", [k for k in state if k not in params
                                  and not k.endswith("stem_pad_lanes")])):
        merged, n, total = merge_pretrained({k: state[k] for k in names}, sd, log)
        state.update(merged)
        counts[col] = (n, total)
    for k in sorted(set(sd) - set(state)):
        log(f"unmapped key {k} (dropped)")
    model.load_state_dict(state, strict=True)
    save_experiment(output_dir, model, conf, vocab, "best")
    (n_p, t_p), (n_s, t_s) = counts["params"], counts["stats"]
    print(f"imported {pth_path}: params {n_p}/{t_p}, batch_stats {n_s}/{t_s} "
          f"-> {output_dir}/best")
    if n_p < t_p:
        print(f"warning: {t_p - n_p} param tensors kept their fresh init "
              f"(see log for unmapped/shape-mismatched keys)")
    return {"params_loaded": n_p, "params_total": t_p,
            "stats_loaded": n_s, "stats_total": t_s}


def report_results(experiment_root: str,
                   score_file: str = "scores_beam_3.txt") -> Dict[str, List[float]]:
    """Mean ± population std of each score over the ``seed_*`` dirs of an
    experiment root (utils/report_results.py; acvae_tpu/cli/main.py:
    1880-1912), printed and written to ``aggregated_scores.txt`` (for the
    default ``score_file``, else ``aggregated_<score_file>``) in the root.
    Returns each score's values."""
    root = Path(experiment_root)
    values: Dict[str, List[float]] = {}
    for seed_dir in sorted(root.glob("seed_*")):
        path = seed_dir / score_file
        if not path.exists():
            continue
        for line in path.read_text().splitlines():
            m = re.match(r"(\S+):\s+([-\d.]+)", line)
            if m:
                values.setdefault(m.group(1), []).append(float(m.group(2)))
    text = "\n".join(f"{name}: {np.mean(v):.3f} ± {np.std(v):.3f} (n={len(v)})"
                     for name, v in values.items())
    print(text)
    out_name = ("aggregated_scores.txt" if score_file == "scores_beam_3.txt"
                else f"aggregated_{score_file}")
    with open(root / out_name, "w") as f:
        f.write(text + "\n")
    return values


def split_dataset(caption_file: str, output_prefix: str) -> str:
    """``<output_prefix>_hard.json`` and ``_easy.json``: the audios split in
    half by the mean bag-of-words cosine between their captions, the less
    alike half hard (utils/split_dataset.py with the JAX package's TF-IDF
    stand-in for BERT; acvae_tpu/cli/main.py:2089-2120)."""
    info = load_caption_info(caption_file)

    def cosine(a: str, b: str) -> float:
        ca, cb = Counter(a.split()), Counter(b.split())
        num = sum(ca[w] * cb[w] for w in ca)
        na = math.sqrt(sum(v * v for v in ca.values()))
        nb = math.sqrt(sum(v * v for v in cb.values()))
        return num / (na * nb + 1e-8)

    sims = []
    for a in info:
        caps = [c["tokens"] for c in a["captions"]]
        pair = [cosine(caps[i], caps[j])
                for i in range(len(caps)) for j in range(i + 1, len(caps))]
        sims.append(np.mean(pair) if pair else 0.0)
    order = np.argsort(sims)    # numpy's default kind, as the JAX package
    half = len(order) // 2
    for name, idxs in (("hard", order[:half]), ("easy", order[half:])):
        with open(f"{output_prefix}_{name}.json", "w") as f:
            json.dump({"audios": [info[i] for i in idxs]}, f, indent=1)
    print(f"wrote {output_prefix}_hard.json / _easy.json "
          f"({half}/{len(order) - half} audios)")
    return output_prefix


def concat_json(*inputs: str, output: str) -> str:
    """One text.json of the audios of every input, in order
    (utils/concat_json.py)."""
    audios = [a for path in inputs for a in load_caption_info(path)]
    with open(output, "w") as f:
        json.dump({"audios": audios}, f, indent=1)
    return output


def concat_csv(*inputs: str, output: str) -> str:
    """One TSV of the rows of every input TSV (utils/concat_csv.py), written
    as pandas' ``read_csv`` + ``concat`` + ``to_csv`` write it
    (``core/tsv.py``; the card's machine has no pandas)."""
    from acvae_tpu_torch.core.tsv import concat_tsv

    concat_tsv(inputs, output)
    return output


def tsne(*embedding_dirs: str, output_prefix: str = "tsne",
         num_audios: int = 20, seed: int = 0) -> List[str]:
    """A t-SNE scatter of each ``<dir>/<audio_id>/<i>.npy`` caption
    embedding tree (utils/show_tsne.py; acvae_tpu/cli/main.py:1936-1985):
    ``num_audios`` audio ids sampled from the first dir with ``seed``, one
    ``<output_prefix>_<dir name>.png`` per dir, points coloured by audio.
    Needs scikit-learn and matplotlib (the card's machine has neither)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError(f"tsne needs scikit-learn and matplotlib, and "
                          f"{e.name} is not installed") from e
    if not embedding_dirs:
        raise ValueError("pass at least one embedding directory")
    rng = np.random.default_rng(seed)
    roots = [Path(d) for d in embedding_dirs]
    audio_ids = sorted(p.name for p in roots[0].iterdir() if p.is_dir())
    if len(audio_ids) > num_audios:
        audio_ids = list(rng.choice(audio_ids, num_audios, replace=False))
    outputs = []
    for root in roots:
        vecs, labels = [], []
        for li, aid in enumerate(audio_ids):
            adir = root / aid
            if not adir.is_dir():
                continue   # an id sampled from the first dir may be absent
            for npy in sorted(adir.glob("[0-9]*.npy")):
                vecs.append(np.load(npy).ravel())
                labels.append(li)
        if len(vecs) < 3:
            print(f"skipping {root}: only {len(vecs)} embeddings for the "
                  f"sampled audio ids (need >= 3 for t-SNE)")
            continue
        x = np.stack(vecs)
        emb = TSNE(n_components=2, init="pca", random_state=seed,
                   perplexity=max(1.0, min(30.0, len(x) - 1))).fit_transform(x)
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="hsv", s=18)
        ax.set_title(f"t-SNE caption embeddings — {root.name}")
        out = f"{output_prefix}_{root.name}.png"
        fig.savefig(out, dpi=200, bbox_inches="tight")
        plt.close(fig)
        outputs.append(out)
        print(f"wrote {out} ({len(vecs)} points, {len(audio_ids)} audios)")
    return outputs


# the device probe of ``doctor``, run in a process of its own: one 128x128
# matmul and its time, synchronised, then 5 more
_PROBE = """\
import json, sys, time, torch
dev = torch.device(sys.argv[1])
cuda = dev.type == "cuda"
if cuda and not torch.cuda.is_available():
    sys.exit(f"device {dev} needs a CUDA card and none is visible")
sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
t0 = time.perf_counter()
x = torch.ones((128, 128), device=dev)
y = x @ x
sync()
first = time.perf_counter() - t0
if float(y[0, 0]) != 128.0:
    sys.exit(f"the probe's matmul gave {float(y[0, 0])}, not 128")
ts = []
for _ in range(5):
    t = time.perf_counter()
    x @ x
    sync()
    ts.append(time.perf_counter() - t)
print(json.dumps({"type": dev.type,
                  "name": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": torch.cuda.device_count() if cuda else 1,
                  "first_call_s": round(first, 3),
                  "matmul_ms_p50": round(sorted(ts)[2] * 1000, 3)}))
"""


def _probe_device(device, timeout: float) -> Dict[str, Any]:
    """``{"ok": True, "device": {...}}``, or ``{"ok": False, "error": ...}``
    when the probe fails or runs past ``timeout`` seconds."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE, str(device)],
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"device probe of {device} hung for "
                                      f"{timeout:.0f} s"}
    if r.returncode != 0:
        lines = (r.stderr or "").splitlines()
        return {"ok": False, "error": lines[-1] if lines else
                f"probe exited {r.returncode} with no stderr"}
    return {"ok": True, "device": json.loads(r.stdout.splitlines()[-1])}


def doctor(probe_timeout: float = 120.0, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """A bounded check of ``device`` (acvae_tpu/cli/main.py:2139-2186):
    torch's version and CUDA runtime, the kernel build directory
    (``ops/cuda/build.py``; the port's counterpart of the compilation
    cache) and its entries, and a probe in a process of its own, cut at
    ``probe_timeout`` seconds: the device's name and count, one small
    matmul's time, synchronised.  Prints the JSON report; exits with code 1
    when the probe fails or times out."""
    from acvae_tpu_torch.ops.cuda.build import BUILD_DIR

    report: Dict[str, Any] = {"torch_version": torch.__version__,
                              "cuda_runtime": torch.version.cuda}
    report["kernel_build"] = {
        "path": str(BUILD_DIR),
        "entries": len(os.listdir(BUILD_DIR)) if BUILD_DIR.is_dir() else 0}
    t0 = time.perf_counter()
    report.update(_probe_device(device, float(probe_timeout)))
    report["probe_wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(report, indent=1))
    if not report["ok"]:
        sys.exit(1)
    return report


# ---------------------------------------------------------------------- #
def make_synthetic(output_dir: str, num_audios: int = 3000,
                   captions_per_audio: int = 5, mel_frames: int = 1024,
                   rich: bool = False, seed: int = 0) -> str:
    """Write a synthetic Clotho-style corpus: ``mels.npz`` (one array per
    clip), ``mels.csv`` (the manifest), ``text.json`` and ``vocab.pkl``.
    ``--rich`` picks the ~200-word generator."""
    from acvae_tpu_torch.data.synthetic import (make_synthetic_clotho,
                                                make_synthetic_clotho_rich)

    gen = make_synthetic_clotho_rich if rich else make_synthetic_clotho
    feats, info, vocab = gen(num_audios=num_audios,
                             captions_per_audio=captions_per_audio,
                             mel_frames=mel_frames, seed=seed)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    npz = str(out / "mels.npz")
    np.savez(npz, **feats)
    with open(out / "mels.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["audio_id", "hdf5_path"])
        w.writerows([aid, npz] for aid in feats)
    with open(out / "text.json", "w") as f:
        json.dump({"audios": info}, f)
    vocab.save(str(out / "vocab.pkl"))
    print(f"wrote {len(feats)} clips / "
          f"{sum(len(a['captions']) for a in info)} captions / "
          f"vocab {len(vocab)} to {out}")
    return str(out)


def build_vocab(caption_file: str, output: str, threshold: int = 1,
                zh: bool = False, pad_to_multiple: int = 1) -> str:
    """vocab.pkl from text.json; the captions' ``tokens`` are written back
    into the file (build_vocab.py:95)."""
    info = load_caption_info(caption_file, zh=zh)
    vocab = _build_vocab(info, threshold, zh=zh,
                         pad_to_multiple=int(pad_to_multiple))
    with open(caption_file, "w") as f:
        json.dump({"audios": info}, f, indent=1)
    vocab.save(output)
    print(f"vocabulary size: {len(vocab)}")
    return output


def tokenize_caption(caption_file: str, output: Optional[str] = None,
                     zh: bool = False) -> str:
    """Write ``tokens`` into each caption of text.json (in place without
    ``output``), without building a vocabulary."""
    info = load_caption_info(caption_file)
    n = 0
    for audio in info:
        for cap in audio["captions"]:
            cap["tokens"] = " ".join(tokenize(cap["caption"], zh))
            n += 1
    with open(output or caption_file, "w") as f:
        json.dump({"audios": info}, f, indent=1)
    print(f"tokenized {n} captions")
    return output or caption_file


COMMANDS = {"train": train, "evaluate": evaluate, "predict": predict,
            "diversity": diversity, "ensemble": ensemble,
            "human_eval": human_eval, "scst": scst,
            "average_checkpoints": average_checkpoints, "diagnose": diagnose,
            "make_synthetic": make_synthetic, "build_vocab": build_vocab,
            "tokenize_caption": tokenize_caption,
            "train_discriminator": train_discriminator, "stage1": stage1,
            "stage1_test": stage1_test, "extract_embedding": extract_embedding,
            "global_vae": global_vae, "export_embeddings": export_embeddings,
            "extract_sentence_embedding": extract_sentence_embedding,
            "export_model": export_model, "serve": serve,
            "prepare_data": prepare_data, "sweep": sweep,
            "import_torch": import_torch, "report_results": report_results,
            "split_dataset": split_dataset, "concat_json": concat_json,
            "concat_csv": concat_csv, "tsne": tsne, "doctor": doctor}
# the commands that compute on the device (the others only check --device)
ON_DEVICE = ("train", "evaluate", "predict", "ensemble", "scst", "diagnose",
             "train_discriminator", "stage1", "stage1_test",
             "extract_embedding", "global_vae", "extract_sentence_embedding",
             "export_model", "serve", "prepare_data", "sweep", "import_torch",
             "doctor")


def main(argv: Optional[List[str]] = None) -> Any:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return None
    command, *rest = argv
    if command not in COMMANDS:
        raise SystemExit(f"unknown command {command!r}; one of "
                         f"{', '.join(COMMANDS)}")
    positional, overrides = [], {}
    for arg in rest:
        if arg.startswith("--"):
            k, _, v = arg[2:].partition("=")
            overrides[k.replace("-", "_")] = v if v != "" else True
        else:
            positional.append(arg)
    # override strings read as YAML, as the JAX CLI reads them
    coerced = {k: safe_load(v) if isinstance(v, str) else v
               for k, v in overrides.items()}
    device = coerced.pop("device", DEFAULT_DEVICE)
    _device(device)
    if command in ON_DEVICE:
        coerced["device"] = device
    return COMMANDS[command](*positional, **coerced)
