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
as there: ``kl_anneal``, ``free_bits``, ``global_loss``, the five
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
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import json
import logging
import random
import sys
import time
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.core.config import Config, load_config
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
    "adverse_loss": "A17 part 2", "use_aug_prob": "A17 part 2",
    "embedding_loss": "A17 part 2", "embedding_path": "A17 part 2",
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
    return dataclasses.replace(batch, feats=feats,
                               feat_lens=put(batch.feat_lens),
                               caps=put(batch.caps), cap_lens=put(batch.cap_lens))


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
    train_ds = CaptionDataset(**train_src, caption_info=train_info,
                              vocabulary=vocab,
                              embedding_path=conf.get("embedding_path"))
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

    remark = f"{conf['remark']}_{conf['beta']}"
    if "alpha" in conf:
        remark += f"_{conf['alpha']}"
    outputdir = (Path(conf["outputpath"]) / conf.get("model", "Hybrid_VAEModel")
                 / remark / f"seed_{seed}")
    outputdir.mkdir(parents=True, exist_ok=True)
    logger = _setup_logger(str(outputdir / "train_caption.log"))
    logger.info(f"Storing files in: {outputdir}")

    vocab = Vocabulary.load(conf["vocab_file"])
    train_ds, _, train_loader, val_loader = _build_dataloaders(conf, vocab)
    conf["data_dim"] = train_ds.data_dim
    total_iters = len(train_loader) * conf["epochs"]
    conf["total_iters"] = total_iters
    val_key2refs = val_loader.refs()
    trainer = Trainer(conf, len(vocab), train_ds.data_dim, device=device,
                      total_iters=total_iters, vocab=vocab)
    apply_pretrained(conf, trainer.model, logger.info)
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
                    m = trainer.step(batch.arrays(), iteration, epoch)
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
            "tokenize_caption": tokenize_caption}
# the commands that compute on the device (the others only check --device)
ON_DEVICE = ("train", "evaluate", "predict", "ensemble", "scst", "diagnose")


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
