#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``acvae_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile DIR] [--only parallel]

Phases, each of which exits nonzero on failure:

1. device: a CUDA card is required (no CPU fallback); TF32 is turned off for
   matmuls and cuDNN; prints the card's name and power limit.
2. build: compiles every CUDA source of the port, one nvcc each, all
   started together; counts the tensor-core MMAs (``IGMMA``/``IMMA``) and
   ``IDP4A`` in each conv kernel's SASS (``cuobjdump -sass``) and fails
   unless the conv body has ``IGMMA`` (wgmma) and no ``IMMA`` or ``IDP4A``,
   the stem has ``IMMA``, and ptxas reports no spill in the stem kernels.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases; times the kernel, the plain
   version and the library call that computes the same function with CUDA
   events (median, L2 flushed).  ``time_warp_1d``: max |error| <= 1e-6.
   ``stem_conv3x3_i8`` (the fused stem at [512, 1024, 64] f32 -> 64, sym
   and offset, codes included, and its edge cases), ``conv3x3_i8`` (every
   body conv of the int8 Cnn10 and Cnn14 at batch 512, block 1's
   2^31-element tensors included, Cnn14's 2- and 4-column maps and 2048
   channels, the ragged edges of its tiles, its Ci = 1 path) and
   ``avgpool2x2_i8`` (their 3 and 5 pools): max |error| 0, and each beside
   cuDNN's bf16 ``conv2d``/``avg_pool2d`` at the same shapes,
   channels-last, and each body conv beside ``torch._int_mm`` of its
   im2col (labelled comparisons, not the same function); the stem also
   beside its plain quantize alone and the pair the port ran before (the
   plain quantize, then the int8 stem kernel), and its bound; Cnn10's body
   (7 convs), Cnn14's stem and 11 body convs, and their 3 and 5 pools.
   ``bn_relu`` (the bf16 ConvBlock's inference epilogue: BatchNorm, ReLU
   and the 2x2 pool as one pass): the 12 launches of a bf16 Cnn14 batch of
   512 and odd shapes, bit for bit against the unfused ops, summed beside
   its bytes bound and the unfused ops' time.  ``topk_rows`` (the beam's
   top-k): bit for bit against the card's stable sort cut to k at a beam
   step of 512 clips (3 x 4981 scores each, k 3), drawn, coarse (ties) and
   planted (ties across beams, +-inf, +-0.0, NaN of both signs) rows, and
   at other widths and k; timed beside its bytes bound, the sort and
   ``torch.topk`` (not the same order on ties, so the port never calls it).
4. parity: one small train step on the card against the same step on the
   CPU (plain versions), same weights and draws.
5. train: the train path — ``Trainer`` on the flagship recipe at full
   width (Cnn10 64->512 in bf16, embed/hidden 512, vocab 4981, batch 32,
   T_mel 1024 ragged, F 64, L 22) with ``augments: [timewarp, timemask,
   freqmask]`` for 5 steps on seeded random batches; every metric
   finite; each kernel launched on that path.
6. decode parity: a small flagship's beam-3 and greedy decodes on the card
   against the CPU (same weights and prior noise): tokens identical,
   scores within rtol 1e-4; ``beam_topk``'s tie order on the card, through
   the ``topk_rows`` kernel.
7. serve: the serving path at full width — the flagship written to an
   experiment dir with ``save_experiment`` and read back with
   ``load_experiment``; (a) beam-3 decode at batch 512, T_mel 1024, max
   length 20 through ``inference_forward`` (one warm-up batch, 5 timed):
   captions/s, p50 batch latency, peak memory; (b) ``CaptionService`` at
   the CLI defaults behind ``run_server`` on a free port, driven over HTTP
   with every request kind and a malformed one, ``/stats`` counts checked.
8. int8 decode parity: a small flagship's int8 encoders (v2sym, v2, v4)
   baked on the CPU and carried to the card: the codes at every quantize
   point identical to the CPU's; beam-3 tokens identical, scores within
   rtol 1e-4.
9. int8 serve: the slice's path at full width — the flagship through
   ``save_experiment``/``load_experiment``, ``quant_encoder_for(...,
   v2sym)`` calibrated from bn0's statistics on the card, then (a) one
   warm-up and 5 timed batches of 512 at beam 3, T_mel 1024, max_length
   20 through ``int8_decode_fn``: captions/s, p50, the encoder/beam split,
   peak memory, and 1 ``stem_conv3x3_i8`` + 7 ``conv3x3_i8`` + 3
   ``avgpool2x2_i8`` launches a batch;
   (b) ``CaptionService(encoder_int8=True)`` behind ``run_server`` over
   HTTP as in phase 7, its launches counted against its batches.
10. cli: the user's own commands, in process through
   ``acvae_tpu_torch.cli.main.main``: ``make_synthetic --rich`` (320 clips
   of 512-992 frames), ``train configs/ac_vae.yaml`` at its full width
   (vocabulary the corpus's) with ``--augments=[timewarp,timemask,freqmask]``
   for 2 epochs of 45 iterations, again with ``--epochs=3 --resume=true``
   (restored step 90, final step 135, the checkpoint files, 3 finite
   ``metrics.jsonl`` lines), then ``evaluate`` at beam 3 with the bf16 and
   the int8 v2sym encoder (every score JAX writes, finite).  Launches: one
   ``time_warp_1d`` a train iteration; 1 ``stem_conv3x3_i8``, 7
   ``conv3x3_i8`` and 3 ``avgpool2x2_i8`` an int8 eval batch,
   calibration's reported apart.
   Prints epoch wall s, iterations/s, the loader's host ms a batch against
   the step's, validation s, evaluate clips/s and peak memory.
11. diverse: (a) a small flagship on the card against the CPU, same weights
   and noise: dbs at (beam 8, group 4, lambda 0.5) and (8, 8) tokens
   identical, scores within rtol 1e-4; a two-member ensemble beam and
   greedy decode tokens identical; one bf16 ``decode_step_api`` step within
   3e-2 of the largest logit.  (b) Full width: the flagship's v2sym int8
   encoder (bn0 calibration) under dbs at beam 8, 4 groups, lambda 0.5,
   batch 512, T_mel 1024, max_length 20 (one warm-up, 5 timed): clips/s,
   candidates/s, p50, the encoder/dbs split, peak memory, 1 + 7 + 3 int8
   launches a batch; then the bf16-parameter beam-3 decode
   on the bf16 encoder at the same batch, beside phase 7's float32 loop.
   (c) On phase 10's experiment and corpus, in process: ``evaluate
   --decode_method=dbs --beam_size=20 --group_size=4`` with the bf16 and
   the int8 encoder (20 candidates a clip; 1 + 7 + 3 launches an int8 eval
   batch, calibration apart), ``evaluate --decode_dtype=bfloat16``,
   ``diversity`` of the dbs output against the corpus (every metric
   finite, the ratios in [0, 1]), ``predict`` (one CSV row a clip),
   ``ensemble <exp> <exp> --checkpoint=last`` and ``human_eval``.  (d)
   ``CaptionService`` at dbs b8 g4 (and one HTTP round trip), as a
   two-member ensemble, with bf16 decode parameters and with bf16 uploads,
   16 clips each.

12. families: the six other recipes of ``configs/`` (``vae``, ``gmm_vae``,
   ``simple_vae``, ``trans_vae``, ``attn_rnn_xe``, ``xe_baseline``).  (a)
   Each at a small size on the card against the CPU, same weights and
   noise: greedy and beam-3 tokens identical, dbs (beam 4, 2 groups) tokens
   identical, ``forced_decode`` log-probs within 1e-4.  (b) Each at its
   recipe's full width (Cnn10 64->512, embed 512; the transformers 2 layers,
   4 heads, FFN 2048; vocab 4981): 3 ``Trainer`` steps at batch 32, T_mel
   1024 ragged, with ``augments: [timewarp, timemask, freqmask]`` (3
   ``time_warp_1d`` launches a family; the median ms of steps 2-3), then one
   warm-up and one timed beam-3 batch of 512 clips at T_mel 1024, max_length
   20: captions/s and the encoder / loop split.  (c) The int8 v2sym encoder
   of ``vae`` and ``gmm_vae`` (bn0 calibration on the card) at batch 512:
   one warm-up and one timed beam-3 batch, 1 + 7 + 3 int8 launches a
   batch, and the card's codes at every quantize point
   against the CPU's on 2 clips.  (d) The CLI on phase 10's corpus: 1 epoch
   of ``train`` for ``vae.yaml``, ``trans_vae.yaml`` and
   ``xe_baseline.yaml`` with the time warp, then ``evaluate`` at beam 3
   (and ``--encoder_int8`` for ``vae.yaml``).

13. extras: the rest of ``cli train`` and three commands, on phase 10's
   corpus and experiment at full width.  (a) ``train configs/ac_vae.yaml``
   with the time warp for 2 epochs and ``--checkpoint_every_steps=20
   --fault_abort_step=42``: exactly that SystemExit, ``step_1`` (step 20)
   and ``step_0`` (step 40) on disk; ``--resume=true`` restores step 40,
   skips 40 batches and ends at 90 with the snapshots gone; against phase
   10's first run (the same command, uninterrupted, without snapshots)
   ``ckpt_steps.json``'s keys and step exactly, its best score and epoch
   2's train loss within rel 1e-3.  (b) One epoch with ``--accum_steps=2``,
   ReduceLROnPlateau (patience 0, factor 0.5), ``--global_loss=kl
   --free_bits=0.05``, a cyclical ``kl_anneal``, AdamW (weight decay
   0.01), ``--freeze_word_embedding``, ``--pretrained=<phase 10>/best.pt``
   and ``--profile_dir``: the word embeddings bit-identical to the
   pretrained ones, the ``loaded`` log line, ``kl_raw``, the plateau's
   fields, 22 updates for 45 micro-batches and one trace file.  (c) ``scst``
   of phase 10's experiment for an epoch at ``sample_n`` 1 (rollout, host
   CIDEr and replay + update timed apart), the replay's log-probs against
   the rollout's on one batch (atol 1e-4), 3 N-SCST iterations at 5
   samples.  (d) ``average_checkpoints best,last``, ``evaluate
   --checkpoint=avg`` in bf16 and with the int8 encoder (10 + 70 + 30 launches)
   and ``diagnose`` (its JSON keys).  (e) New, with the optimizer
   state's dtypes: ``optimizer_args.mu_dtype: bfloat16`` (Adam) and
   ``optimizer: SGD`` with ``momentum: 0.9, accumulator_dtype: bfloat16``:
   two small steps card vs CPU from the same weights and draws (metrics
   within rtol 1e-3, the stored moment within 1e-2 per tensor), 3
   full-width flagship steps each with the time warp (the moment bfloat16
   on the card), the state's bytes beside the float32 chain's, and the
   Cnn14 flagship's.

14. encoders: (a) every registered encoder (``models/encoders.py``) on the
   card against the CPU at ``tests/test_encoders.py``'s widths (N 2, T 64;
   Cnn14, ResNet38 and CNN10Encoder at their fixed widths), same weights,
   eval and train mode with the dropouts off: within 1e-3·(1 + |cpu|),
   lengths exact.  Then the flagship recipe with PANN Cnn14
   (``encodermodel: Cnn14``, ``encoder_args.embed_size: 2048``, bf16) at
   full width: (b) 6 ``Trainer`` steps at batch 32, T_mel 1024 ragged,
   with the time warp (6 launches; the median ms of steps 2-6); (c) through ``save_experiment``/
   ``load_experiment``, the beam-3 decode at batch 512 with the bf16
   encoder, then with the int8 v2sym one calibrated from bn0's statistics
   (its codes at the 12 quantize points card vs CPU on 2 clips; one
   warm-up and 5 timed batches; 1 ``stem_conv3x3_i8``, 11 ``conv3x3_i8``
   and 5 ``avgpool2x2_i8`` a batch): captions/s, the encoder / loop split, peak memory; then
   ``CaptionService(encoder_int8=True)`` over HTTP; (d) on phase 10's
   corpus, a seeded state dict in PANN's Cnn14 layout (with its frontend
   and ``fc_audioset``) as ``train --pretrained_encoder`` for 1 epoch (the
   ``loaded 40/40`` line), ``evaluate --encoder_int8`` (10 + 110 +
   50 launches), and ``evaluate`` on the ``.npz`` manifest and on the same
   features as a kaldi ``.scp``/``.ark`` table: the same captions.
15. aux: the auxiliary training stack on phase 10's corpus.  (a) Card vs
   CPU from the same weights and noise (within 1e-4·(1 + |cpu|)): the
   discriminator's aud2cap and cap2cap (id and soft captions), the GE2E
   loss and ``get_cossim``, the global VAE's train forward, the sentence
   head, ``adverse_loss`` (and the logits' gradient) and
   ``augment_loss``; then one small ``Trainer.step`` each with
   ``adverse_loss``, ``embedding_loss`` and a ``keep_mask`` batch (SGD:
   metrics, gradients and updated parameters).  (b) ``configs/adverse.yaml``: ``train_discriminator
   --mode=aud2cap`` for 1 epoch; 6 flagship train steps with
   ``adverse_loss`` (a seeded discriminator at vocab 4981, gumbel) at
   batch 32, T_mel 1024, L 22, the median of steps 2-6 beside phase 5's,
   and 6 of the same recipe without the term (the term's cost);
   1 CLI epoch of stage 2 and ``evaluate --encoder_int8`` of it (10 + 70
   + 30 launches).  (c) ``configs/sentence.yaml``: ``stage1`` (2 epochs, embed
   512), ``stage1_test`` (the EER), ``extract_embedding``, 6 timed
   ``Seq2SeqAttnModel`` steps with ``embedding_loss: Cosine``, 1 CLI epoch
   with ``embedding_path`` and ``evaluate``.  (d) ``global_vae`` (2
   epochs at batch 64, latent 512), a ``configs/ac_vae.yaml`` epoch
   warm-started by ``pretrained_global`` (its ``loaded N/M`` line) with
   ``use_aug_prob: 0.5`` over aug-tagged caption copies,
   ``extract_sentence_embedding`` from a seeded 512-dim matrix and
   ``export_embeddings``; where the transformers package is installed,
   ``extract_sentence_embedding`` from a seeded BERT directory, card vs CPU.
16. export: the deployment surface on phase 9's seeded flagship.  (a) ``cli
   export_model`` of the beam-3 decode (T_mel 1024, max_length 20, a
   symbolic batch) with the int8 v2sym encoder (``--platforms=cuda,cpu``:
   the artifact loads on both) and with bf16 parameters: the export's wall
   time and ``decode.pt2``'s bytes; no kernel launches while tracing.  (b)
   Each artifact in a new ``load_exported`` on the card against the eager
   decode, in turns, one warm-up and 5 timed batches of 512 on the same
   noise: tokens identical, scores within 1e-6·(1 + |score|), captions/s of
   both; 1 ``stem_conv3x3_i8``, 7 ``conv3x3_i8`` and 3 ``avgpool2x2_i8``
   an int8 batch from the exported program's operators, as from the eager
   decode.  (c) ``cli serve
   --exported=<int8>`` as a process of its own: /health, and a float32
   JSON mel, a binary uint8 mel and a wav captioned.  (d) ``cli
   prepare_data`` on seeded wavs (32 kHz mono and stereo, 16 kHz) on the
   card and with ``--device=cpu``: the mels within atol 1e-4 dB.
17. tools: the rest of the CLI on phase 10's corpus and experiment, at the
   flagship's full width.  (a) ``sweep configs/ac_vae.yaml --param=beta
   --values=0.5,0.4 --epochs=1 --isolate_trials=true``: each trial a ``cli
   train`` process of its own, whose log must name the card; the wall of
   each trial and of the sweep.  (b) ``sweep --mode=tpe --n_trials=3
   --space={beta: [0.3, 0.5], smoothing: [0.05, 0.1]} --assessor=median
   --assessor_min_trials=1 --assessor_min_epochs=1`` in process, 2 epochs on
   96 of the 320 clips: the suggestions and every ``stopped_early`` (the
   assessor's log line after the last epoch a stopped trial wrote).  (c) Phase
   10's ``best`` weights as a reference ``.pth`` (``{"model": ...}`` with
   DDP's ``module.`` prefix) through ``cli import_torch`` (every tensor
   loaded, equal to the source's), then ``evaluate --encoder_int8`` of the
   import and of its source in turns: identical captions and scores, 1 + 7
   + 3 int8 launches an eval batch (calibration
   apart).  (d) ``report_results`` over two ``seed_*`` dirs holding (c)'s
   scores, ``split_dataset``, ``concat_json`` (the halves join to the
   corpus), ``concat_csv`` and ``tsne`` (its PNG, or its refusal naming
   scikit-learn and matplotlib).  (e) ``doctor`` on the card: the probe
   names the card, the build directory holds the kernels' libraries.
18. parallel: ``acvae_tpu_torch/parallel`` on the flagship at full width
   (vocab 4982, a multiple of the model axis; batch 32, T_mel 1024, L 22;
   dropouts off; one Adam step at lr 1e-4).  (a) A group of 2 worker
   processes sharing the card over gloo (NCCL refuses two ranks on one
   device) takes a DP (2 data), a TP (1 data x 2 model) and an SP (TP +
   ``sequence_parallel``) step, each against the unsplit step on the card
   from the same weights and global draws: with the encoder in float32 the
   loss within rtol 1e-5, with the recipe's bf16 encoder (timed after a
   warm-up step) within 1e-4; the ranks agree; the gradients before Adam
   and the step's update of the weights, per tensor against the unsplit
   step's, within ``PAR_DTYPES``'s limits, and two planted faults outside
   them (gradients averaged instead of summed; the halo exchange's
   backward dropped); the unsplit step probed again with cuDNN's other
   algorithms and with BatchNorm in float64; ``time_warp_1d`` launched on
   each rank.  (b) ``cli train configs/ac_vae.yaml --distributed=true``
   for an epoch on phase 10's corpus: "running unsharded" on one card,
   ``data-parallel mesh: {'data': D}`` (a worker a card, NCCL) on D.  (c)
   ``evaluate --distributed --encoder_int8`` of (b)'s experiment against
   the plain int8 evaluate, each twice (cold, warm): identical files, the
   int8 launches counted per card.  (d) With 2 or more cards, (a) over
   NCCL on all of them.  ``--only parallel`` runs phases 1, 2 and 18 alone
   (phase 10's corpus made here).  New with sequence parallelism beyond
   Cnn10, in (a) and (d): the PANN Cnn14 (``--encodermodel=Cnn14
   --encoder_args.embed_size=2048``, phase 14's set-up) and ResNet38 take
   the SP step, every dropout off (they hard-code theirs).  In float32
   with the port's BatchNorm the loss (rtol 1e-5) and the gradients per
   tensor are held, the unsplit step probed and the dropped halo outside
   the limits; a second float32 pass with BatchNorm in float64 on both
   sides holds the update too (the float32 BatchNorm's rounding moves
   Adam's sign steps; the probes read it).  Cnn14 is also timed in bf16:
   its split held at limits of its own (``PAR_LIMITS``: the unsplit
   bf16 step moves as far when only its BatchNorms change precision,
   which its probe reads), at T_mel 1024 and at 3072, the largest mel
   bucket.  The peak memory of the unsplit step and of each rank, in the
   timed step above what the process held before, is printed for every
   timed case.  New with sequence parallelism for every encoder but
   RNNEncoder, in (a) and (d): a float32 SP step of ResNetEncoder (strided
   and wide halos, a padded max pool), CNNEncoder (5-frame halos, the
   unmasked time mean), CNN10Encoder (Block2D and LP pools),
   E2EASREncoder (VGG2L, its BiGRUs on the gathered frames),
   TransformerEncoder and M2TransformerEncoder (the shard's queries
   against every frame's keys and values), each at its own full width
   with the flagship's decoder, the loss, gradients and update held at
   ``PAR_DTYPES``'s float32 limits against the unsplit step, the
   unsplit step probed; two more planted faults outside them
   (ResNetEncoder's halo backward dropped; TransformerEncoder's keys and
   values gathered with ``gather_replicated``).  TransformerEncoder
   (float32: it takes no dtype in either package) is also timed at
   T_mel 1024 and 3072, its peak memory a rank beside the unsplit
   step's.

Kernel launches are counted from 0 over each path (train, serve, int8
serve, cli, diverse, families, extras, encoders, aux, export, tools,
parallel; ``topk_rows`` checked at none in a train step or an export's
trace and one a step of each group's beam in every timed decode, service
and exported decode), and after phase 3 every call of the plain float64 FMA
(``ops/int8.py`` ``fma_f32``) on a card tensor: none may run.  Prints the whole script's wall time, a ``{"kernels": [...]}``
JSON line (``launches`` on each kernel's own path, ``launches_by_path`` on
all twelve), then, last, the ``{"ok": true, "device": ...}`` line.  ``--profile DIR`` also traces two
more train steps (phase 5's, and phase 15's adverse step) and one full-width decode batch of each serving path and
of phase 11's int8 dbs decode with torch.profiler and writes the traces and
op tables into DIR.
"""
import argparse
import concurrent.futures
import copy
import functools
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM: HBM rate, the float32 (non-tensor-core) rate, the int8
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
VOCAB, DATA_DIM, BATCH, T_MEL, CAP_LEN = 4981, 64, 32, 1024, 22
STEPS = 5
# Clotho dev: 3839 clips x 5 captions x 0.9 train split / batch 32 = 540
# iterations per epoch, over the recipe's 25 epochs
ITERS_PER_EPOCH, EPOCHS = 540, 25
# the serving headline's shape (bench.py:25-36): beam 3 over batches of 512
# clips of 1024 frames, captions of at most 20 words
DEC_BATCH, BEAM, MAX_LEN, DEC_TIMED = 512, 3, 20, 5
# the int8 encoder's convs (H, W, Ci, Co) and pools (H, W, C) at T_mel 1024,
# F 64, Cnn10 64->512: 8 convs and 3 int8 pools a batch (block 4 pools f32)
CONV_SHAPES = [(1024, 64, 1, 64), (1024, 64, 64, 64), (512, 32, 64, 128),
               (512, 32, 128, 128), (256, 16, 128, 256), (256, 16, 256, 256),
               (128, 8, 256, 512), (128, 8, 512, 512)]
POOL_SHAPES = [(1024, 64, 64), (512, 32, 128), (256, 16, 256)]
# Cnn14 (phase 14) shares Cnn10's first 7 convs and 3 pools; its block 4
# requantizes (sym) where Cnn10's writes f32, then blocks 5 and 6 (2048
# channels on 2-column maps; the last conv unpooled, f32): 12 convs and 5
# int8 pools a batch
CNN14_CONVS = [(128, 8, 512, 512, "sym"), (64, 4, 512, 1024, "sym"),
               (64, 4, 1024, 1024, "sym"), (32, 2, 1024, 2048, "sym"),
               (32, 2, 2048, 2048, "f32relu")]
CNN14_POOLS = [(128, 8, 512), (64, 4, 1024)]
PATHS = ("train", "serve", "int8_serve", "cli", "diverse", "families",
         "extras", "encoders", "aux", "export", "tools", "parallel")
# phase 10: the corpus (320 clips: 45 train iterations of 32 an epoch at
# train_percent 90, 5 validation batches, 10 eval batches)
CLI_AUDIOS, CLI_ITERS, CLI_EVAL_BATCHES = 320, 45, 10
SMI = ""
STEP_MS = {}   # median train step ms: phase 5's flagship, phase 15's recipes


# the int8 encoder's kernels and their launches a batch: the fused stem,
# the body convs, the int8 pools
INT8_KERNELS = ("stem_conv3x3_i8", "conv3x3_i8", "avgpool2x2_i8")
CNN10_PER_BATCH = (1, 7, 3)
# plain float64 FMAs (ops/int8.py fma_f32) on card tensors after phase 3:
# the int8 paths run none (the stem's quantization is the kernel's)
PLAIN_FMA_ON_CARD = [0]


def kernel_fns():
    """Every kernel wrapper of the port, by kernel name."""
    from acvae_tpu_torch.ops.cuda.bn_relu_kernel import bn_relu
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (avgpool2x2_i8, conv3x3_i8,
                                                         stem_conv3x3_i8)
    from acvae_tpu_torch.ops.cuda.topk_kernel import topk_rows
    from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d
    return {"time_warp_1d": time_warp_1d, "stem_conv3x3_i8": stem_conv3x3_i8,
            "conv3x3_i8": conv3x3_i8, "avgpool2x2_i8": avgpool2x2_i8,
            "bn_relu": bn_relu, "topk_rows": topk_rows}


def topk_per_search(kw):
    """topk_rows launches of one search of ``kw``: one a step of each
    group's beam (a dbs decode's groups each take their own), none in a
    greedy decode."""
    groups = {"beam": 1, "dbs": kw.get("group_size")}.get(kw["decode_method"], 0)
    return kw["max_length"] * groups


def int8_launches(counts, before=None):
    """(stem, conv, pool) launches in ``counts``, less ``before``'s."""
    return tuple(counts[k] - (before[k] if before else 0) for k in INT8_KERNELS)


def per_batches(per_batch, n):
    return tuple(k * n for k in per_batch)


def guard_plain_fma():
    """From here on, count the plain float64 FMA's calls on card tensors
    (``PLAIN_FMA_ON_CARD``); ``main`` fails if any path made one."""
    from acvae_tpu_torch.ops import int8
    real = int8.fma_f32

    def fma_f32(a, b, c):
        if a.is_cuda:
            PLAIN_FMA_ON_CARD[0] += 1
        return real(a, b, c)
    int8.fma_f32 = fma_f32


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_device"):
            fn.launches_by_device.clear()


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke runs on "
             "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    global SMI
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    SMI = smi.splitlines()[0]
    print(SMI)


def time_ms(fn, flush, reps=30):
    """Median ms of one call, L2 flushed before each (CUDA events).  The
    flush reads 256 MB (~80 us of device work): it leaves L2 holding clean
    lines (a write would leave dirty ones, whose writeback the timed call
    would pay for), and it is still running when the host has launched
    ``fn``, so the events time the device, not the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(flush):
    from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d, time_warp_1d_ref
    from acvae_tpu_torch.ops.warp import warp_flow

    g = torch.Generator("cuda").manual_seed(0)
    dev = "cuda"
    # the main path's inputs: a Clotho-shaped batch and the spline flow the
    # train step builds for it (W=40, ragged lengths)
    img = torch.randn((BATCH, T_MEL, DATA_DIM), generator=g, device=dev)
    lens = torch.randint(T_MEL // 2, T_MEL + 1, (BATCH,), generator=g, device=dev)
    flow = warp_flow(img, 40, lens, generator=g)
    cases = [("main path", img, flow, 64),
             ("flows beyond ±max_shift", img,
              torch.randn(img.shape, generator=g, device=dev) * 96, 64)]
    for B, T, F, max_shift in ((2, 256, 16, 128), (2, 64, 16, 64),
                               (1, 128, 8, 8)):
        x = torch.randn((B, T, F), generator=g, device=dev)
        cases.append((f"[{B},{T},{F}] max_shift={max_shift}", x,
                      torch.randn(x.shape, generator=g, device=dev)
                      * max_shift / 2, max_shift))
    worst = 0.0
    for name, x, fl, ms in cases:
        out = time_warp_1d(x, fl, ms)
        torch.cuda.synchronize()
        err = (out - time_warp_1d_ref(x, fl, ms)).abs().max().item()
        print(f"time_warp_1d {name}: max_abs_err {err:.3e}")
        check(err <= 1e-6, f"time_warp_1d disagrees with its plain version "
                           f"({name}: {err})")
        worst = max(worst, err)
    # the library call: grid_sample with border padding and aligned corners
    # clips q to [0, T-1] and lerps rows floor(q), floor(q)+1, which is the
    # reference's edge clamp; it differs only by the rounding of the
    # normalised coordinate (~T * 6e-8 in q, times a row difference of a few
    # units), hence the 2e-3 tolerance
    grid = grid_sample_grid(flow, 64)
    lib_err = (grid_sample_warp(img, grid)
               - time_warp_1d_ref(img, flow, 64)).abs().max().item()
    print(f"grid_sample (border, align_corners) vs plain: max_abs_err "
          f"{lib_err:.3e}")
    check(lib_err <= 2e-3, f"grid_sample does not compute time_warp_1d "
                           f"({lib_err})")
    k_ms = time_ms(lambda: time_warp_1d(img, flow, 64), flush)
    p_ms = time_ms(lambda: time_warp_1d_ref(img, flow, 64), flush)
    l_ms = time_ms(lambda: grid_sample_warp(img, grid), flush)
    n = img.numel()
    # each input read once, the output written once; ~12 flops per element
    b_ms, by = bound(12 * n, 3 * 4 * n, FP32_FLOPS)
    print(f"time_warp_1d [{BATCH},{T_MEL},{DATA_DIM}]: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, grid_sample {l_ms:.4f} ms (grid built "
          f"before), bound {b_ms * 1e3:.2f} us ({by})")
    return {"name": "time_warp_1d", "route": "cuda",
            "source": "acvae_tpu_torch/csrc/time_warp.cu",
            "replaces": "acvae_tpu/ops/pallas/warp_kernel.py:145",
            "launches": None, "max_abs_err": worst, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms}


def grid_sample_grid(flow, max_shift):
    """The [B, T, F, 2] sampling grid of the warp for ``grid_sample``:
    x = f (exact), y = t - clip(flow, ±max_shift), both normalised with
    aligned corners."""
    B, T, F = flow.shape
    q = (torch.arange(T, dtype=flow.dtype, device=flow.device)[None, :, None]
         - flow.clamp(-max_shift, max_shift))
    x = (torch.arange(F, dtype=flow.dtype, device=flow.device)
         * (2.0 / (F - 1)) - 1.0).expand(B, T, F)
    return torch.stack((x, q * (2.0 / (T - 1)) - 1.0), dim=-1)


def grid_sample_warp(img, grid):
    """One library call computing time_warp_1d (timed as ``library_ms``;
    the port never calls it)."""
    return torch.nn.functional.grid_sample(
        img[:, None], grid, mode="bilinear", padding_mode="border",
        align_corners=True)[:, 0]


def conv_inputs(N, H, W, ci, co, g):
    """Random codes [N, H, W, ci], OHWI weights and an epilogue affine that
    spreads the outputs over the codes."""
    x = torch.randint(-128, 128, (N, H, W, ci), dtype=torch.int8, device="cuda",
                      generator=g)
    w = torch.randint(-127, 128, (co, 3, 3, ci), dtype=torch.int8, device="cuda",
                      generator=g)
    A = ((torch.rand(co, generator=g, device="cuda") + 0.5)
         * (40.0 / (math.sqrt(9 * ci) * 73.0 * 73.0)))
    B = torch.randn(co, generator=g, device="cuda") * 20
    return x, w, A, B


def stem_inputs(N, T, F, co, g):
    """A log-mel [N, T, F], the stem's c1/c2 [F], OHWI weights [co, 3, 3, 1]
    and an epilogue affine.  The mel lies on a grid of 1/4 and the first
    bins' c1, c2 (1, 2, 4, 1/2 and 1/2, 1/4, -1/2, 3/2) put some of x·c1 +
    c2 on ties (.5), where the rounding's half-to-even shows."""
    feats = torch.round(torch.randn((N, T, F), generator=g, device="cuda") * 24) / 4
    c1 = torch.rand(F, generator=g, device="cuda") * 30 + 5
    c2 = torch.randn(F, generator=g, device="cuda") * 10
    k = min(F, 4)
    c1[:k] = torch.tensor([1.0, 2.0, 4.0, 0.5], device="cuda")[:k]
    c2[:k] = torch.tensor([0.5, 0.25, -0.5, 1.5], device="cuda")[:k]
    _, w, A, B = conv_inputs(1, 1, 1, 1, co, g)
    return feats, c1, c2, w, A, B


def max_err(a, b):
    """max |a - b| over the batch, 32 rows at a time."""
    return max((a[i:i + 32].float() - b[i:i + 32].float()).abs().max().item()
               for i in range(0, a.shape[0], 32))


def bound(ops, nbytes, peak_ops):
    """(ms, by): the least time for the work, the larger of its operations
    over the peak rate and its bytes over the memory rate."""
    ops_ms, bytes_ms = ops / peak_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms else "bytes"


CONV_EDGES = [  # (N, H, W, Ci, Co, mode, pad_code)
    (3, 100, 64, 1, 64, "sym", 0), (3, 100, 64, 1, 128, "f32relu", -128),
    (3, 100, 64, 1, 64, "offset", 0), (3, 100, 64, 64, 64, "offset", -128),
    (3, 100, 64, 64, 64, "sym", -128), (3, 37, 13, 128, 192, "f32relu", -128),
    (3, 50, 8, 512, 512, "f32", 0), (3, 9, 5, 64, 64, "offset", 0),
    (2, 1, 1, 64, 64, "sym", 0),
    # the body's tile (128 pixels of whole rows, 128 or 64 channels, 32
    # input channels a stage, 3 stages): H*W not a multiple of the tile,
    # W above and below the tile width, Co = 192 against a 128-channel
    # tile, and Ci = 192 (three 64-channel chunks, six stages' worth)
    (2, 11, 10, 64, 128, "sym", 0), (2, 3, 150, 64, 128, "offset", -128),
    (1, 5, 129, 64, 64, "f32", -128), (2, 40, 3, 64, 128, "f32relu", -128),
    (2, 20, 16, 64, 192, "sym", -128), (2, 9, 70, 128, 192, "offset", 0),
    (2, 17, 24, 192, 128, "f32", -128), (2, 8, 8, 192, 64, "sym", 0),
    # conv3x3_i8's Ci = 1 path (int8 codes in, the stem kernel's tiles of
    # rows of at most 128 columns)
    (2, 5, 200, 1, 64, "offset", -128), (2, 13, 7, 1, 192, "f32", -128),
    (1, 9, 33, 1, 512, "sym", -128), (2, 1, 1, 1, 64, "f32", 0),
    # the fused stem from an f32 mel (Ci "mel", pad 0: SAME on the codes),
    # codes on and off: N = 1, T past a tile's 54 rows and not a multiple of
    # them, F = 1, F > 128 (TMA over two column tiles; F % 4 != 0 through
    # registers), odd F, Co 64 to 512, every mode
    (1, 100, 64, "mel", 64, "sym", 0), (2, 55, 64, "mel", 512, "offset", 0),
    (3, 37, 1, "mel", 64, "f32relu", 0), (2, 19, 132, "mel", 128, "f32", 0),
    (2, 9, 200, "mel", 512, "sym", 0), (1, 3, 7, "mel", 192, "offset", 0),
    (2, 1, 1, "mel", 64, "f32", 0), (2, 70, 16, "mel", 64, "f32relu", 0),
    # Cnn14's narrow maps at odd heights: 2 and 4 columns, 2048 channels
    (3, 9, 2, 2048, 128, "sym", 0), (2, 33, 4, 1024, 2048, "f32relu", 0),
    (2, 5, 2, 2048, 2048, "f32", -128),
    # the body's pixel tiles run over the flattened batch: tiles that span
    # images (H*W not a multiple of 64 or 128), a batch smaller than one
    # tile, W = 1 and H = 1, maps that are mostly border under the offset
    # coding's -128 pad (added back in the epilogue), Co = 192 against a
    # 128-channel tile, Ci = 64 and 2048
    (3, 7, 9, 64, 64, "sym", 0), (5, 13, 11, 128, 128, "offset", -128),
    (1, 5, 7, 64, 128, "f32", -128), (2, 3, 3, 128, 64, "offset", -128),
    (4, 37, 1, 64, 128, "offset", -128), (3, 1, 45, 128, 64, "f32relu", -128),
    (2, 1, 1, 64, 64, "offset", -128), (3, 4, 4, 256, 128, "offset", -128),
    (3, 11, 7, 128, 192, "offset", -128), (2, 9, 6, 64, 192, "sym", 0),
    (2, 7, 5, 2048, 64, "offset", -128), (2, 5, 3, 2048, 192, "f32", 0),
    (3, 10, 6, 64, 256, "sym", -128),
    # Ci = 64 and 192 where a tile of 256 pixels is whole rows (W = 8, 16,
    # 32, 128, 256): the weights stay resident and one halo box serves three
    # taps; 128 channels on such a map take the im2col ring
    (2, 32, 8, 64, 128, "offset", -128), (2, 4, 128, 64, 64, "sym", -128),
    (3, 32, 16, 64, 192, "f32", -128), (1, 8, 32, 192, 64, "offset", -128),
    (1, 3, 256, 64, 64, "sym", 0), (2, 16, 16, 128, 128, "offset", -128)]
POOL_EDGES = [(3, 101, 63, 64), (3, 7, 9, 512), (3, 2, 2, 16), (2, 1, 1, 16)]


def int_mm_ms(x, w, flush):
    """Time of ``torch._int_mm`` of the conv's im2col [M, 9*Ci] by its
    weights [9*Ci, Co] (the int8 tensor cores' GEMM, not the same function:
    no halo, no epilogue), on a batch slice whose im2col stays near 1 GiB,
    scaled to the whole batch.  Returns (ms, images in the slice)."""
    N, H, W, ci = x.shape
    co = w.shape[0]
    n = max(1, min(N, 2**30 // (H * W * 9 * ci)))
    xp = torch.nn.functional.pad(x[:n], (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(n * H * W, 9 * ci)
    wt = w.reshape(co, 9 * ci).t()                  # [K, N], column-major
    ms = time_ms(lambda: torch._int_mm(cols, wt), flush, reps=10)
    return ms * N / n, n


def _conv_case(H, W, ci, co, mode, g, flush):
    """One conv shape at batch DEC_BATCH: the kernel against its plain
    version (max |err| 0), timed beside the plain version, cuDNN's bf16
    conv2d and (body convs) ``torch._int_mm``.  Returns its numbers."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import conv3x3_i8
    from acvae_tpu_torch.ops.int8 import conv3x3_i8_ref

    F = torch.nn.functional
    x, w, A, B = conv_inputs(DEC_BATCH, H, W, ci, co, g)
    w_hwio = w.permute(1, 2, 3, 0)
    out = conv3x3_i8(x, w, A, B, mode, 0)
    torch.cuda.synchronize()
    err = max_err(out, conv3x3_i8_ref(x, w_hwio, A, B, mode, 0))
    check(err == 0, f"conv3x3_i8 disagrees with its plain version at "
                    f"[{DEC_BATCH},{H},{W},{ci}]->{co} {mode}: {err}")
    del out
    k_ms = time_ms(lambda: conv3x3_i8(x, w, A, B, mode, 0), flush)
    p_ms = time_ms(lambda: conv3x3_i8_ref(x, w_hwio, A, B, mode, 0), flush,
                   reps=2)
    mm, i_ms = "", 0.0
    if ci > 1:
        i_ms, n = int_mm_ms(x, w, flush)
        mm = (f", int8 torch._int_mm {i_ms:.4f} ms (GEMM only, not the same "
              f"function; im2col of {n} images, scaled)")
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)     # NHWC as channels-last
    wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
    l_ms = time_ms(lambda: F.conv2d(xb, wb, padding=1), flush, reps=10)
    del xb, wb, x
    ops = 2.0 * DEC_BATCH * H * W * 9 * ci * co
    nbytes = (DEC_BATCH * H * W * (ci + co * (4 if mode == "f32relu" else 1))
              + 9 * ci * co + 8 * co)
    b_ms, by = bound(ops, nbytes, INT8_OPS)
    print(f"conv3x3_i8 [{DEC_BATCH},{H},{W},{ci}]->{co} {mode}: kernel "
          f"{k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s, {b_ms / k_ms:.1%} of "
          f"the bound), plain {p_ms:.4f} "
          f"ms, bf16 cuDNN conv2d {l_ms:.4f} ms (not the same function)"
          f"{mm}, bound {b_ms:.4f} ms ({by}); max_abs_err {err}")
    return dict(ms=k_ms, plain=p_ms, bound=b_ms, by=by, bf16=l_ms,
                int_mm=i_ms, ops=ops, err=err)


def _pool_case(H, W, C, g, flush, pool):
    """One pool shape at batch DEC_BATCH, as :func:`_conv_case`."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import avgpool2x2_i8
    from acvae_tpu_torch.ops.int8 import avgpool2x2_i8_ref

    x = torch.randint(-128, 128, (DEC_BATCH, H, W, C), dtype=torch.int8,
                      device="cuda", generator=g)
    err = max_err(avgpool2x2_i8(x), avgpool2x2_i8_ref(x))
    check(err == 0, f"avgpool2x2_i8 disagrees with its plain version at "
                    f"[{DEC_BATCH},{H},{W},{C}]: {err}")
    pool["err"] = max(pool["err"], err)
    k_ms = time_ms(lambda: avgpool2x2_i8(x), flush)
    p_ms = time_ms(lambda: avgpool2x2_i8_ref(x), flush, reps=10)
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    l_ms = time_ms(lambda: torch.nn.functional.avg_pool2d(xb, 2), flush)
    del xb
    b_ms, _ = bound(0, DEC_BATCH * H * W * C * 5 // 4, INT8_OPS)
    print(f"avgpool2x2_i8 [{DEC_BATCH},{H},{W},{C}]: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bf16 cuDNN avg_pool2d {l_ms:.4f} ms (not "
          f"the same function), bound {b_ms:.4f} ms (bytes); max_abs_err {err}")
    pool["ms"] += k_ms
    pool["plain"] += p_ms
    pool["bound"] += b_ms
    pool["bf16"] += l_ms


def _tally(cases):
    """The sums over conv cases of :func:`_conv_case`."""
    t = {k: sum(c[k] for c in cases)
         for k in ("ms", "plain", "bound", "bf16", "int_mm", "ops")}
    by = {b: sum(c["bound"] for c in cases if c["by"] == b)
          for b in ("operations", "bytes")}
    return dict(t, convs=len(cases), bound_by=max(by, key=by.get))


def _stem_case(g, flush):
    """The fused stem at batch DEC_BATCH ([512, 1024, 64] f32 -> 64): the
    kernel against its plain version (``stem_codes``, the float64 FMA
    emulation of ops/int8.py, then ``conv3x3_i8_ref``), codes included, in
    the modes of v2sym and v2 (max |err| 0); timed beside the plain
    version, the plain quantize alone, the pair the port ran before (the
    plain quantize, then the int8 stem kernel of ``conv3x3_i8``) and
    cuDNN's bf16 conv2d of the codes.  Returns its numbers."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import conv3x3_i8, stem_conv3x3_i8
    from acvae_tpu_torch.ops.int8 import conv3x3_i8_ref, stem_codes

    N, T, F, co = DEC_BATCH, T_MEL, DATA_DIM, 64
    feats, c1, c2, w, A, B = stem_inputs(N, T, F, co, g)
    w_hwio = w.permute(1, 2, 3, 0)
    codes = stem_codes(feats, c1, c2)
    err = 0
    for mode in ("sym", "offset"):
        out, q = stem_conv3x3_i8(feats, c1, c2, w, A, B, mode, True)
        torch.cuda.synchronize()
        e = max(max_err(out, conv3x3_i8_ref(codes, w_hwio, A, B, mode, 0)),
                int((q != codes).sum()))
        check(e == 0, f"stem_conv3x3_i8 disagrees with its plain version at "
                      f"[{N},{T},{F}]->{co} {mode} (codes included): {e}")
        err = max(err, e)
        del out, q
    k_ms = time_ms(lambda: stem_conv3x3_i8(feats, c1, c2, w, A, B, "sym"), flush)
    off_ms = time_ms(lambda: stem_conv3x3_i8(feats, c1, c2, w, A, B, "offset"), flush)
    p_ms = time_ms(lambda: conv3x3_i8_ref(stem_codes(feats, c1, c2), w_hwio, A, B,
                                          "sym", 0), flush, reps=2)
    q_ms = time_ms(lambda: stem_codes(feats, c1, c2), flush, reps=5)
    pair_ms = time_ms(lambda: conv3x3_i8(stem_codes(feats, c1, c2), w, A, B, "sym", 0),
                      flush, reps=5)
    i8_ms = time_ms(lambda: conv3x3_i8(codes, w, A, B, "sym", 0), flush)
    xb = codes.permute(0, 3, 1, 2).to(torch.bfloat16)     # NHWC as channels-last
    wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
    l_ms = time_ms(lambda: torch.nn.functional.conv2d(xb, wb, padding=1), flush, reps=10)
    del xb, wb, codes
    ops = 2.0 * N * T * F * 9 * co
    # the f32 mel read once, the int8 output written once (and the weights)
    b_ms, by = bound(ops, N * T * F * (4 + co) + 9 * co + 8 * co + 8 * F, INT8_OPS)
    print(f"stem_conv3x3_i8 [{N},{T},{F}] f32 -> {co} sym: kernel {k_ms:.4f} ms "
          f"({b_ms / k_ms:.1%} of the bound; offset {off_ms:.4f} ms), plain "
          f"{p_ms:.4f} ms (of which the float64-FMA quantize {q_ms:.4f} ms), the "
          f"plain quantize + the int8 stem kernel {pair_ms:.4f} ms (the kernel "
          f"alone {i8_ms:.4f} ms), bf16 cuDNN conv2d of the codes {l_ms:.4f} ms "
          f"(not the same function), bound {b_ms:.4f} ms ({by}); max_abs_err "
          f"{err} ({SMI})")
    return dict(ms=k_ms, offset_ms=off_ms, plain=p_ms, quant_plain=q_ms,
                pair=pair_ms, int8_kernel=i8_ms, bound=b_ms, by=by, bf16=l_ms,
                int_mm=0.0, ops=ops, err=err)


def int8_kernel_phase(flush):
    """stem_conv3x3_i8, conv3x3_i8 and avgpool2x2_i8 against their plain
    versions: every shape of a batch of 512 of Cnn10 and of Cnn14, and the
    edge cases, max |err| 0; times summed over a Cnn10 batch's 7 body
    convs and its 3 pools, the stem apart, and over a Cnn14 batch's stem,
    11 body convs and 5 pools."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (avgpool2x2_i8, conv3x3_i8,
                                                         stem_conv3x3_i8)
    from acvae_tpu_torch.ops.int8 import avgpool2x2_i8_ref, conv3x3_i8_ref, stem_codes

    g = torch.Generator("cuda").manual_seed(2)
    stem = _stem_case(g, flush)
    body = [_conv_case(H, W, ci, co, "f32relu" if k == len(CONV_SHAPES)
                       else "sym", g, flush)
            for k, (H, W, ci, co) in enumerate(CONV_SHAPES, 1) if ci > 1]
    extra14 = [_conv_case(H, W, ci, co, mode, g, flush)
               for H, W, ci, co, mode in CNN14_CONVS]
    err_all = max(c["err"] for c in body + extra14)
    body10, body14 = _tally(body), _tally(body[:6] + extra14)
    c14 = _tally([stem] + body[:6] + extra14)
    pool = dict(ms=0.0, plain=0.0, bound=0.0, bf16=0.0, err=0.0)
    for H, W, C in POOL_SHAPES:
        _pool_case(H, W, C, g, flush, pool)
    pool14 = dict(pool)
    for H, W, C in CNN14_POOLS:
        _pool_case(H, W, C, g, flush, pool14)
    pool["err"] = pool14["err"]
    for n, H, W, ci, co, mode, pad in CONV_EDGES:
        if ci == "mel":   # the fused stem from an f32 mel, codes on and off
            feats, c1, c2, w, A, B = stem_inputs(n, H, W, co, g)
            codes = stem_codes(feats, c1, c2)
            ref = conv3x3_i8_ref(codes, w.permute(1, 2, 3, 0), A, B, mode, 0)
            err = 0
            for want in (True, False):
                out, q = stem_conv3x3_i8(feats, c1, c2, w, A, B, mode, want)
                err = max(err, max_err(out, ref),
                          int((q != codes).sum()) if want else int(q.numel()))
            print(f"stem_conv3x3_i8 edge [{n},{H},{W}] f32 -> {co} {mode}, codes on "
                  f"and off: max_abs_err {err}")
            check(err == 0, f"stem_conv3x3_i8 disagrees at the edge case "
                            f"{(n, H, W, co, mode)}: {err}")
            stem["err"] = max(stem["err"], err)
            continue
        x, w, A, B = conv_inputs(n, H, W, ci, co, g)
        err = max_err(conv3x3_i8(x, w, A, B, mode, pad),
                      conv3x3_i8_ref(x, w.permute(1, 2, 3, 0), A, B, mode, pad))
        print(f"conv3x3_i8 edge [{n},{H},{W},{ci}]->{co} {mode} pad {pad}: "
              f"max_abs_err {err}")
        check(err == 0, f"conv3x3_i8 disagrees at the edge case "
                        f"{(n, H, W, ci, co, mode, pad)}: {err}")
        err_all = max(err_all, err)
    for n, H, W, C in POOL_EDGES:
        x = torch.randint(-128, 128, (n, H, W, C), dtype=torch.int8,
                          device="cuda", generator=g)
        out, ref = avgpool2x2_i8(x), avgpool2x2_i8_ref(x)
        err = max_err(out, ref) if ref.numel() else 0.0
        check(out.shape == ref.shape and err == 0,
              f"avgpool2x2_i8 disagrees at the edge case {(n, H, W, C)}: {err}")
        print(f"avgpool2x2_i8 edge [{n},{H},{W},{C}] -> {tuple(out.shape)}: "
              f"max_abs_err {err}")
        pool["err"] = max(pool["err"], err)
    print(f"int8 kernels, a batch of {DEC_BATCH}: stem_conv3x3_i8 {stem['ms']:.4f} "
          f"ms ({stem['bound'] / stem['ms']:.1%} of its {stem['bound']:.4f} ms "
          f"bound; the plain quantize + the int8 stem kernel {stem['pair']:.4f} ms); "
          f"7 conv3x3_i8 {body10['ms']:.3f} ms ({body10['ops'] / body10['ms'] / 1e9:.1f} "
          f"TOP/s; plain {body10['plain']:.1f}, bf16 cuDNN {body10['bf16']:.3f}, "
          f"_int_mm {body10['int_mm']:.3f}, bound {body10['bound']:.3f} "
          f"({body10['bound_by']})); 3 avgpool2x2_i8 {pool['ms']:.3f} ms (plain "
          f"{pool['plain']:.3f}, bf16 cuDNN {pool['bf16']:.3f}, bound "
          f"{pool['bound']:.3f}) ({SMI})")
    print(f"int8 kernels, a Cnn14 batch of {DEC_BATCH}: the stem and 11 conv3x3_i8 "
          f"{c14['ms']:.3f} ms (plain {c14['plain']:.1f}, bf16 cuDNN "
          f"{c14['bf16']:.3f}, bound {c14['bound']:.3f}), of which the 11 body "
          f"convs {body14['ms']:.3f} ms ({body14['ops'] / body14['ms'] / 1e9:.1f} "
          f"TOP/s, {body14['ops'] / 2e12:.2f} T MAC; _int_mm {body14['int_mm']:.3f}, "
          f"bound {body14['bound']:.3f}); 5 avgpool2x2_i8 {pool14['ms']:.3f} ms "
          f"(plain {pool14['plain']:.3f}, bf16 cuDNN {pool14['bf16']:.3f}, bound "
          f"{pool14['bound']:.3f}) ({SMI})")
    common = {"route": "cuda", "source": "acvae_tpu_torch/csrc/conv_i8.cu",
              "launches": None, "library_ms": None}
    return [dict(common, name="stem_conv3x3_i8",
                 replaces="acvae_tpu/models/quant.py:246",
                 max_abs_err=stem["err"], ms=stem["ms"], plain_ms=stem["plain"],
                 bound_ms=stem["bound"], bound_by=stem["by"],
                 offset_ms=stem["offset_ms"], quant_plain_ms=stem["quant_plain"],
                 plain_quant_and_int8_kernel_ms=stem["pair"],
                 int8_stem_kernel_ms=stem["int8_kernel"], bf16_cudnn_ms=stem["bf16"],
                 timed=f"the stem of a batch of {DEC_BATCH}, sym"),
            dict(common, name="conv3x3_i8",
                 replaces="acvae_tpu/models/quant.py:424",
                 max_abs_err=err_all, ms=body10["ms"], plain_ms=body10["plain"],
                 bound_ms=body10["bound"], bound_by=body10["bound_by"],
                 bf16_cudnn_ms=body10["bf16"], int_mm_ms=body10["int_mm"],
                 tops=body10["ops"] / body10["ms"] / 1e9,
                 timed=f"7 body convs of a batch of {DEC_BATCH}",
                 cnn14={"convs": 11, "ms": body14["ms"], "plain_ms": body14["plain"],
                        "bound_ms": body14["bound"], "int_mm_ms": body14["int_mm"],
                        "with_stem_ms": c14["ms"], "with_stem_bound_ms": c14["bound"],
                        "bf16_cudnn_ms": c14["bf16"]}),
            dict(common, name="avgpool2x2_i8",
                 replaces="acvae_tpu/models/quant.py:86",
                 max_abs_err=pool["err"], ms=pool["ms"], plain_ms=pool["plain"],
                 bound_ms=pool["bound"], bound_by="bytes",
                 bf16_cudnn_ms=pool["bf16"], timed=f"3 pools of a batch of {DEC_BATCH}",
                 cnn14={"pools": 5, "ms": pool14["ms"], "plain_ms": pool14["plain"],
                        "bound_ms": pool14["bound"], "bf16_cudnn_ms": pool14["bf16"]})]


# bn_relu: the bf16 Cnn14's conv outputs (C, H, W) at T_mel 1024, F 64, and
# whether the launch pools (each block's conv1, then its conv2; block 6
# unpooled): the 12 launches of a batch; odd shapes (N, C, H, W)
BN_RELU_LAUNCHES = [((c, T_MEL >> b, DATA_DIM >> b), pool)
                    for b, c in enumerate((64, 128, 256, 512, 1024, 2048))
                    for pool in (False, b < 5)]
BN_RELU_EDGES = [(3, 5, 33, 65), (2, 4, 9, 2), (2, 4, 10, 4), (2, 3, 7, 9),
                 (1, 6, 5, 1), (2, 16, 4, 12), (2, 4, 17, 4), (2, 3, 33, 32)]
CNN10_BN_RELU_PER_BATCH, CNN14_BN_RELU_PER_BATCH = 8, len(BN_RELU_LAUNCHES)


def bn_relu_kernel_phase(flush):
    """bn_relu against the unfused ops (BatchNorm on running statistics,
    relu, avg_pool2d) bit for bit, at the 12 launches of a bf16 Cnn14 batch
    of 512 and at odd shapes in bf16 and float32; times summed over the
    batch's launches beside the bytes bound and the unfused ops."""
    from acvae_tpu_torch.models.encoders import BatchNorm
    from acvae_tpu_torch.ops.cuda.bn_relu_kernel import bn_relu

    F = torch.nn.functional
    g = torch.Generator("cuda").manual_seed(5)

    def case(shape, dtype):
        bn = BatchNorm(shape[1], device="cuda")
        with torch.no_grad():
            for t, lo, hi in ((bn.running_mean, -1, 1), (bn.running_var, 0.05, 2),
                              (bn.weight, -1.5, 1.5), (bn.bias, -0.5, 0.5)):
                t.uniform_(lo, hi, generator=g)
        x = (torch.randn(shape, generator=g, device="cuda") * 2).to(dtype)
        return bn, x

    def fused(bn, x, pool):
        return bn_relu(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                       bn.eps, pool)

    def unfused(bn, x, pool):
        y = F.relu(bn(x, False, dtype=x.dtype))
        return F.avg_pool2d(y, 2) if pool else y

    def bits(a, b):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return a.shape == b.shape and torch.equal(a.view(view), b.view(view))

    tot = dict(ms=0.0, plain=0.0, bound=0.0, nbytes=0)
    with torch.inference_mode():
        for (C, H, W), pool in BN_RELU_LAUNCHES:
            bn, x = case((DEC_BATCH, C, H, W), torch.bfloat16)
            check(bits(fused(bn, x, pool), unfused(bn, x, pool)),
                  f"bn_relu disagrees with the unfused ops at [{DEC_BATCH},{C},{H},"
                  f"{W}] pool={pool}")
            torch.cuda.empty_cache()
            k_ms = time_ms(lambda: fused(bn, x, pool), flush)
            p_ms = time_ms(lambda: unfused(bn, x, pool), flush, reps=5)
            nbytes = x.numel() * 2 * (1 + (0.25 if pool else 1))
            b_ms, _ = bound(0, nbytes, FP32_FLOPS)
            print(f"bn_relu [{DEC_BATCH},{C},{H},{W}] bf16 pool={pool}: kernel "
                  f"{k_ms:.4f} ms ({nbytes / k_ms / 1e9:.2f} TB/s, {b_ms / k_ms:.1%} "
                  f"of the bound), unfused ops {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"(bytes)")
            tot["ms"] += k_ms
            tot["plain"] += p_ms
            tot["bound"] += b_ms
            tot["nbytes"] += nbytes
            del bn, x
            torch.cuda.empty_cache()
        for shape in BN_RELU_EDGES:
            for dtype in (torch.bfloat16, torch.float32):
                bn, x = case(shape, dtype)
                for pool in (False, True) if min(shape[2:]) >= 2 else (False,):
                    check(bits(fused(bn, x, pool), unfused(bn, x, pool)),
                          f"bn_relu disagrees with the unfused ops at {shape} "
                          f"{dtype} pool={pool}")
        print(f"bn_relu edges {BN_RELU_EDGES}, bf16 and float32, pooled and not: "
              f"bit for bit")
    print(f"bn_relu, a bf16 Cnn14 batch of {DEC_BATCH} ({len(BN_RELU_LAUNCHES)} "
          f"launches, {tot['nbytes'] / 1e9:.2f} GB): kernel {tot['ms']:.3f} ms "
          f"({tot['bound'] / tot['ms']:.1%} of the {tot['bound']:.3f} ms bound), "
          f"unfused ops {tot['plain']:.3f} ms ({SMI})")
    return {"name": "bn_relu", "route": "cuda",
            "source": "acvae_tpu_torch/csrc/bn_relu.cu",
            "replaces": "acvae_tpu/models/encoders.py:38-60 (XLA's fusion; no Pallas)",
            "launches": None, "max_abs_err": 0, "ms": tot["ms"],
            "plain_ms": tot["plain"], "bound_ms": tot["bound"], "bound_by": "bytes",
            "library_ms": None,
            "timed": f"the 12 launches of a bf16 Cnn14 batch of {DEC_BATCH}"}


# topk_rows: a beam step of the serving cells (DEC_BATCH clips, BEAM x VOCAB
# scores a clip, k = BEAM), then other widths and k
TOPK_EDGES = [(1, 14943, 16), (1536, 14943, 8), (7, 4981, 3), (512, 4981, 1),
              (33, 4097, 2), (5, 1000, 16), (9, 129, 3), (9, 128, 3), (4, 3, 3),
              (3, 1, 2), (512, 14943, 20), (6, 4981, 33), (3, 37, 40)]


def topk_kernel_phase(flush):
    """topk_rows against the card's stable sort cut to k, bit for bit, then
    its time at a beam step beside the bytes bound, the sort (its plain
    version) and torch.topk (the yardstick: another order on ties)."""
    from acvae_tpu_torch.ops.cuda.topk_kernel import topk_rows, topk_rows_ref

    g = torch.Generator("cuda").manual_seed(17)
    R, M, k = DEC_BATCH, BEAM * VOCAB, BEAM

    def bits(a, b):
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return a.shape == b.shape and torch.equal(a.view(view), b.view(view))

    def agree(x, k, what):
        got, want = topk_rows(x, k), topk_rows_ref(x, k)
        check(all(bits(a, b) for a, b in zip(got, want)),
              f"topk_rows disagrees with the card's stable sort: {what}, "
              f"{list(x.shape)} k={k}")

    step = torch.randn((R, M), generator=g, device="cuda") * 4 - 30
    agree(step, k, "drawn")
    agree(torch.round(step), k, "coarse (ties)")
    tied = torch.round(torch.randn((R, VOCAB), generator=g, device="cuda") * 2)
    agree(tied.repeat(1, BEAM), k, "every beam the same")
    planted = torch.round(step * 2) / 2
    # +-inf, +-0.0, NaN and -NaN (sign bit set), each at drawn columns
    words = np.array([0x7F800000, 0xFF800000, 0, 0x80000000, 0x7FC00000,
                      0xFFC00000], np.uint32)
    for v, n in zip(torch.tensor(words.view(np.float32)), (2, 40, 3, 3, 1, 2)):
        cols = torch.randint(0, M, (R, n), generator=g, device="cuda")
        planted.scatter_(1, cols, v.expand(R, n).to("cuda"))
    agree(planted, k, "planted +-inf, +-0.0, NaN")
    for r, m, kk in TOPK_EDGES:
        x = torch.round(torch.randn((r, m), generator=g, device="cuda") * 3)
        agree(x, kk, "edge")
    print(f"topk_rows: bit for bit with the card's stable sort at [{R},{M}] "
          f"k={k} (drawn, coarse, beams alike, planted) and {TOPK_EDGES}")
    k_ms = time_ms(lambda: topk_rows(step, k), flush)
    p_ms = time_ms(lambda: topk_rows_ref(step, k), flush)
    l_ms = time_ms(lambda: torch.topk(step, k), flush)
    nbytes = R * M * 4 + R * k * (4 + 8)
    b_ms, by = bound(0, nbytes, FP32_FLOPS)
    print(f"topk_rows [{R},{M}] k={k}: kernel {k_ms:.4f} ms "
          f"({nbytes / k_ms / 1e9:.2f} TB/s, {b_ms / k_ms:.1%} of the bound), "
          f"stable sort {p_ms:.4f} ms, torch.topk {l_ms:.4f} ms, bound "
          f"{b_ms * 1e3:.2f} us ({by}) ({SMI})")
    return {"name": "topk_rows", "route": "cuda",
            "source": "acvae_tpu_torch/csrc/topk.cu",
            "replaces": "acvae_tpu/decoding/beam.py:37-75 (lax.top_k; no Pallas)",
            "launches": None, "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": l_ms,
            "timed": f"one beam step of {R} clips, {M} scores each, k {k}"}


def small_conf():
    from acvae_tpu_torch.configs import flagship_conf
    return flagship_conf(
        encoder_args={"embed_size": 16, "channels": [4, 8, 8, 16],
                      "conv_dropout": 0.0, "head_dropout": 0.0},
        decoder_args={"embed_size": 16, "hidden_size": 16, "dropout": 0.0},
        model_args={"posterior_model": "PosteriorRNN_hybrid",
                    "posterior_args": {"hidden_size": 16},
                    "prior_model": "PriorRNN", "prior_args": {"hidden_size": 16}},
        augment_args={"p": 1.0, "W": 8, "T": 10, "F": 4})


def small_step_inputs():
    """The small step's recipe, batch and fixed draws (augment and model
    noise) for a step on the card against one on the CPU: (conf, V, F,
    batch, draws, noise)."""
    from acvae_tpu_torch.ops.specaug import draw_span
    from acvae_tpu_torch.ops.warp import draw_anchors

    conf = small_conf()
    V, N, T, F, L, E = 25, 3, 64, 16, 8, 16
    rng = np.random.default_rng(0)
    batch = {"feats": rng.normal(size=(N, T, F)).astype(np.float32),
             "feat_lens": np.array([64, 48, 33], np.int32),
             "caps": rng.integers(3, V, size=(N, L)).astype(np.int32),
             "cap_lens": np.array([8, 5, 3], np.int32)}
    g = torch.Generator().manual_seed(1)
    lens = torch.tensor(batch["feat_lens"])
    aug = conf["augment_args"]
    draws = {"spec": {
        "gate": torch.ones(N, dtype=torch.bool),
        "time": [draw_span(aug["T"], lens, N, g, "cpu") for _ in range(2)],
        "freq": [draw_span(aug["F"], torch.full((N,), F), N, g, "cpu")
                 for _ in range(2)],
        "warp": draw_anchors(N, T, aug["W"], lens, g, "cpu")}}
    noise = {"q_eps": torch.randn((N, L - 1, E), generator=g),
             "p_eps": torch.randn((L - 1, N, E), generator=g),
             "ss_coins": torch.ones(L - 1, dtype=torch.bool),
             "dis_coins": torch.rand(L - 1, generator=g) < 0.5}
    return conf, V, F, batch, draws, noise


def parity_phase():
    """One small step on the card (kernels) and on the CPU (plain
    versions) from the same weights and draws: metrics within rtol 1e-3."""
    from acvae_tpu_torch.train.trainer import Trainer

    conf, V, F, batch, draws, noise = small_step_inputs()
    gpu = Trainer(conf, V, F, device="cuda", total_iters=100)
    cpu = Trainer(conf, V, F, device="cpu", total_iters=100)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    m_gpu = gpu.step(batch, 1, 12, draws=draws, noise=noise)
    m_cpu = cpu.step(batch, 1, 12, draws=draws, noise=noise)
    for k in ("loss", "ce", "kl", "global", "grad_norm"):
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"parity {k}: card {a:.6f} cpu {b:.6f}")
        check(math.isfinite(a) and abs(a - b) <= 1e-3 * abs(b) + 1e-6,
              f"card and CPU disagree on {k}: {a} vs {b}")
    sd_cpu = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v.cpu(), sd_cpu[k], rtol=1e-3, atol=1e-4)


def make_batch(rng, T=T_MEL):
    lens = rng.integers(T // 2, T + 1, size=BATCH).astype(np.int32)
    lens[0] = T
    feats = rng.normal(size=(BATCH, T, DATA_DIM)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    cap_lens = rng.integers(8, CAP_LEN + 1, size=BATCH).astype(np.int32)
    cap_lens[0] = CAP_LEN
    caps = rng.integers(4, VOCAB, size=(BATCH, CAP_LEN)).astype(np.int32)
    caps[:, 0] = 1                                     # <start>
    caps[np.arange(BATCH), cap_lens - 1] = 2           # <end>
    caps[np.arange(CAP_LEN)[None, :] >= cap_lens[:, None]] = 0   # <pad>
    return {"feats": feats, "feat_lens": lens, "caps": caps,
            "cap_lens": cap_lens}


def train_phase(steps, profile_dir=None):
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.train.trainer import Trainer

    conf = copy.deepcopy(FLAGSHIP_CONF)
    trainer = Trainer(conf, VOCAB, DATA_DIM, device="cuda",
                      total_iters=ITERS_PER_EPOCH * EPOCHS)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    rng = np.random.default_rng(1)
    batches = [make_batch(rng) for _ in range(steps)]
    # mid-run (epoch 12): scheduled sampling < 1 and prior grounding > 0, so
    # both coin branches of the decode loop run
    epoch = 12
    it0 = ITERS_PER_EPOCH * (epoch - 1)
    print(f"train: flagship {n_params} params, batch {BATCH}, T_mel {T_MEL}, "
          f"L {CAP_LEN}, epoch {epoch}, ratios {trainer.ratios(it0 + 1, epoch)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        m = trainer.step(batch, it0 + 1 + i, epoch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        print(f"step {i + 1}: loss {vals['loss']:.4f} ce {vals['ce']:.4f} "
              f"kl {vals['kl']:.4f} global {vals['global']:.4f} "
              f"grad_norm {vals['grad_norm']:.4f} lr {vals['lr']:.3e} "
              f"{step_ms[-1]:.1f} ms")
        check(all(math.isfinite(v) for v in vals.values()),
              f"non-finite metric at step {i + 1}: {vals}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(torch.isfinite(p).all() for p in trainer.model.parameters()),
          "non-finite parameters after the steps")
    STEP_MS["flagship"] = statistics.median(step_ms[1:] or step_ms)
    print(f"train: step ms median {statistics.median(step_ms):.1f} "
          f"(first {step_ms[0]:.1f}, steps 2-{steps} "
          f"{statistics.median(step_ms[1:] or step_ms):.1f}); "
          f"peak memory {peak / 2**30:.3f} GiB; launches {counts}")
    check(counts["time_warp_1d"] == steps,
          f"time_warp_1d launched {counts['time_warp_1d']} times in "
          f"{steps} steps (expected {steps})")
    check(counts["topk_rows"] == 0, "a train step launched topk_rows")
    if profile_dir:
        profile_steps(trainer, rng, it0 + steps, epoch, step_ms, profile_dir)
    return counts


RANGES = ("augment", "forward", "encoder", "posterior", "decode_loop",
          "adverse", "backward", "optimizer")


def profile_steps(trainer, rng, it, epoch, step_ms, out_dir, tag="train_step",
                  extra=None):
    """Trace two more steps; split device (kernel) time by the trainer's
    record_function ranges.  Backward ops run on autograd's thread, outside
    the "backward" range, so backward = all kernels - the other phases.
    ``extra`` adds arrays to each batch, as in ``_aux_steps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    batches = [make_batch(rng) for _ in range(2)]
    for b in batches:
        b.update(extra(rng) if extra is not None else {})
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, b in enumerate(batches):
            trainer.step(b, it + 1 + i, epoch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and e.key not in RANGES) / 1e3 / 2
    by_range = {e.key: e.device_time_total / 1e3 / 2 for e in events
                if e.key in RANGES and e.device_type == DeviceType.CPU}
    by_range["backward"] = kernel_ms - sum(by_range.get(k, 0.0) for k in
                                           ("augment", "forward", "optimizer"))
    # each range's span on the device timeline (kernels and the gaps between)
    spans = {e.key: e.self_device_time_total / 1e3 / 2 for e in events
             if e.key in RANGES and e.device_type == DeviceType.CUDA}
    # host (CPU) wall of each range per step: launches, syncs, Python
    host = {e.key: e.cpu_time_total / 1e3 / 2 for e in events
            if e.key in RANGES and e.device_type == DeviceType.CPU}
    # CUDA runtime calls per step: kernel launches, copies, syncs
    api = {e.key: (e.count / 2, round(e.self_cpu_time_total / 1e3 / 2, 3))
           for e in events if e.key.startswith("cuda")
           and e.device_type == DeviceType.CPU}
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    (out / f"profile_{tag}.txt").write_text(table)
    host_table = events.table(sort_by="self_cpu_time_total", row_limit=40)
    (out / f"profile_{tag}_host.txt").write_text(host_table)
    prof.export_chrome_trace(str(out / f"trace_{tag}.json"))
    wall = statistics.median(step_ms[1:] or step_ms)
    print(f"profile {tag}: kernel time per step {kernel_ms:.2f} ms vs step "
          f"wall {wall:.2f} ms (unprofiled): device busy share "
          f"{kernel_ms / wall:.3f}")
    print(f"profile {tag}: kernel ms per step by phase " + json.dumps(
        {k: round(v, 3) for k, v in by_range.items()}))
    print(f"profile {tag}: device-timeline span ms per step by phase "
          + json.dumps({k: round(v, 3) for k, v in spans.items()}))
    print(f"profile {tag}: host ms per step by phase " + json.dumps(
        {k: round(v, 3) for k, v in host.items()}))
    print(f"profile {tag}: CUDA runtime calls per step (count, host ms) "
          + json.dumps(api))
    print("\n".join(table.splitlines()[:24]))
    print("\n".join(host_table.splitlines()[:16]))


def phase(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def decode_parity_phase():
    """Phase 6: beam_topk's tie order on the card, then a small flagship's
    beam-3 and greedy decodes on the card and on the CPU from the same
    weights and prior noise: tokens identical, scores within rtol 1e-4."""
    from acvae_tpu_torch.decoding.beam import beam_topk
    from acvae_tpu_torch.models.build import build_model

    before = read_counts()["topk_rows"]
    rows = torch.tensor([[1, 3, 3, 2, 3, 0], [5, 5, 5, 5, 5, 5],
                         [0, 2, 2, 2, 1, 2], [4, 1, 4, 0, 4, 4]],
                        dtype=torch.float32, device="cuda")
    _, idx = beam_topk(rows.view(4, 2, 3), 2)
    check(idx.tolist() == [[1, 2], [0, 1], [1, 2], [0, 2]],
          f"beam_topk tie order on the card: {idx.tolist()}")
    # full width, coarse values (many exact ties): descending value, then
    # ascending index, as numpy's lexsort orders them
    rng = np.random.default_rng(3)
    coarse = (np.round(rng.normal(size=(DEC_BATCH, BEAM * VOCAB)) * 2) / 2
              ).astype(np.float32)
    _, idx = beam_topk(torch.tensor(coarse, device="cuda").view(
        DEC_BATCH, BEAM, VOCAB), BEAM)
    want = np.stack([np.lexsort((np.arange(r.size), -r))[:BEAM] for r in coarse])
    check(np.array_equal(idx.cpu().numpy(), want),
          "beam_topk's order on the card differs from lax.top_k's at full width")
    check(read_counts()["topk_rows"] == before + 2,
          "beam_topk on the card did not go through the topk_rows kernel")

    conf = small_conf()
    V, N, T, F, L = 25, 3, 64, 16, 8
    torch.manual_seed(5)
    gpu = build_model(conf, V, F, device="cuda")
    cpu = build_model(conf, V, F, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    feats = torch.tensor(rng.normal(size=(N, T, F)).astype(np.float32))
    lens = torch.tensor([64, 48, 33])
    eps = torch.randn((L, N * BEAM, 16), generator=torch.Generator().manual_seed(3))
    for method, rows_, score in (("beam", N * BEAM, "scores"),
                                 ("greedy", N, "sampled_logprobs")):
        outs = [m.inference_forward(feats.to(d), lens.to(d), decode_method=method,
                                    beam_size=BEAM, max_length=L,
                                    eps=eps[:, :rows_].to(d))
                for m, d in ((gpu, "cuda"), (cpu, "cpu"))]
        a, b = (o[score].cpu() for o in outs)
        err = ((a - b).abs() / b.abs().clamp_min(1e-6)).max().item()
        print(f"decode parity {method}: seqs {outs[0]['seqs'].shape[1:]} "
              f"identical {torch.equal(outs[0]['seqs'].cpu(), outs[1]['seqs'])}, "
              f"{score} max rel err {err:.2e}")
        check(torch.equal(outs[0]["seqs"].cpu(), outs[1]["seqs"]),
              f"{method} decode tokens differ between the card and the CPU")
        check(torch.allclose(a, b, rtol=1e-4, atol=0),
              f"{method} decode {score} differ beyond rtol 1e-4: {err}")


def flagship_vocab():
    """The four specials, then synthetic words w4..w4980 (vocab 4981)."""
    from acvae_tpu_torch.data.vocab import Vocabulary
    vocab = Vocabulary()
    for i in range(4, VOCAB):
        vocab.add_word(f"w{i}")
    return vocab


def serve_phase(profile_dir=None):
    """Phase 7, the serving path: (a) beam-3 decode at batch 512 through
    ``inference_forward``, (b) the HTTP service at its CLI defaults.
    Returns the kernel launches counted over (a) and (b)."""
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment

    reset_counts()
    torch.manual_seed(7)
    with tempfile.TemporaryDirectory() as exp:
        conf = copy.deepcopy(FLAGSHIP_CONF)
        save_experiment(exp, build_model(conf, VOCAB, DATA_DIM, device="cuda"),
                        conf, flagship_vocab())
        _, vocab, model = load_experiment(exp, device="cuda")
        check(len(vocab) == VOCAB, f"vocab of {len(vocab)} words read back")

        def decode(feats, lens, g):
            return model.inference_forward(feats, lens, generator=g,
                                           **BEAM_KW)
        counts = decode_rate("serve decode", decode, model.encode, model,
                             vocab)[0]
        want = CNN10_BN_RELU_PER_BATCH * (1 + DEC_TIMED)
        check(counts["bn_relu"] == want, f"serve decode: bn_relu launched "
                                         f"{counts['bn_relu']} times (expected {want})")
        if profile_dir:
            profile_decode(decode, profile_dir, "decode")
        del model, decode
        torch.cuda.empty_cache()
        http = http_checks(exp)
    return {k: counts[k] + http[k] for k in counts}


BEAM_KW = dict(decode_method="beam", beam_size=BEAM, max_length=MAX_LEN)
# phase 11: dbs at beam 8 in 4 groups, lambda 0.5, the accuracy-first
# operating point of the JAX package's results (RESULTS.md:603-605)
DBS_KW = dict(decode_method="dbs", beam_size=8, group_size=4,
              diversity_lambda=0.5, max_length=MAX_LEN)
RATES = {}   # clips/s of each decode_rate tag


def decode_rate(tag, decode, encode, model, vocab, kw=BEAM_KW):
    """(a) One warm-up batch, then DEC_TIMED timed batches of ``decode(feats,
    lens, generator)``, each ending in a synchronise; outputs checked after
    the timing (a dbs decode's beams sorted within each group); then one
    more batch split into ``encode`` and the search.  Returns the kernel
    launches of the 1 + DEC_TIMED batches, the clips and their lengths;
    the clips/s go into RATES[tag]."""
    g = torch.Generator("cuda").manual_seed(11)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.full((DEC_BATCH,), T_MEL, device="cuda")
    groups = kw.get("group_size", 1) if kw["decode_method"] == "dbs" else 1
    rows = groups * (kw["beam_size"] // groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, outs = [], []
    for _ in range(1 + DEC_TIMED):
        t0 = time.perf_counter()
        outs.append(decode(feats, lens, g))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = (1 + DEC_TIMED) * topk_per_search(kw)
    check(counts["topk_rows"] == want, f"{tag}: topk_rows launched "
                                       f"{counts['topk_rows']} times (expected {want})")
    for out in outs:
        seqs, scores = out["seqs"], out["scores"]
        check(tuple(seqs.shape) == (DEC_BATCH, rows, MAX_LEN)
              and seqs.dtype == torch.long, f"seqs {seqs.shape} {seqs.dtype}")
        check(bool(((seqs >= 0) & (seqs < VOCAB)).all()), "a token outside the vocab")
        check(bool(torch.isfinite(scores).all()), "a non-finite beam score")
        s = scores.view(DEC_BATCH, groups, -1)
        check(bool((s[..., 1:] <= s[..., :-1]).all()),
              "beam scores not in descending order")
    timed = ms[1:]
    rate = DEC_BATCH * DEC_TIMED / (sum(timed) / 1e3)
    RATES[tag] = rate
    knobs = {k: v for k, v in kw.items() if k != "max_length"}
    what = (f"{rate:.1f} clips/s ({rate * rows:.1f} candidates/s, {rows} a "
            f"clip)" if groups > 1 else f"{rate:.1f} captions/s")
    print(f"{tag}: batch {DEC_BATCH}, {knobs}, T_mel {T_MEL}, "
          f"max_length {MAX_LEN}: {what}; batch ms p50 "
          f"{statistics.median(timed):.1f} (timed {', '.join(f'{t:.1f}' for t in timed)}; "
          f"first {ms[0]:.1f}); peak memory {peak / 2**30:.3f} GiB; launches "
          f"{counts}")
    top = outs[-1]["seqs"][:2, 0].cpu().numpy()
    print(f"{tag}: first captions: "
          + " | ".join(" ".join(vocab.decode(s)) for s in top))
    # the split, one more batch: encoder, then the decode from its output
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode(feats, lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.inference_from_encoded(enc, generator=g, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    print(f"{tag} split: encoder {(t1 - t0) * 1e3:.1f} ms, "
          f"{kw['decode_method']} search {(t2 - t1) * 1e3:.1f} ms ({MAX_LEN} "
          f"steps{f', {groups} groups' if groups > 1 else ''})")
    return counts, feats, lens


def _http(url, data=None, headers=None, timeout=300):
    """(status, JSON reply) of one request."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_checks(exp, tag="serve", per_batch=CNN10_PER_BATCH, **svc_kw):
    """(b) CaptionService at the CLI defaults (and ``svc_kw``) behind
    run_server: one request of each kind, one malformed, then a burst of 16
    concurrent mels.  ``per_batch``: the int8 encoder's stem_conv3x3_i8,
    conv3x3_i8 and avgpool2x2_i8 launches a batch.  Returns the kernel launches of the
    service's life."""
    from acvae_tpu_torch.serve import CaptionService, run_server

    reset_counts()
    t0 = time.perf_counter()
    svc = CaptionService(exp, **svc_kw)
    print(f"{tag}: CaptionService(batch {svc.batch_size}, bucket {svc.bucket}"
          f"{', ' + str(svc_kw) if svc_kw else ''}) ready in "
          f"{time.perf_counter() - t0:.1f} s (load, calibration if int8, 2 "
          f"warm-up batches)")
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(T_MEL, DATA_DIM)).astype(np.float32)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        caps = svc.caption([mel] * svc.batch_size)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(len(caps) == svc.batch_size and all(isinstance(c, str) for c in caps),
              f"CaptionService.caption: {caps}")
    print(f"{tag}: CaptionService.caption of {svc.batch_size} clips, no HTTP: "
          f"p50 {statistics.median(ms):.1f} ms ({', '.join(f'{t:.1f}' for t in ms)})")
    server = run_server(svc, port=0, block=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    js = {"Content-Type": "application/json"}
    short = rng.normal(size=(700, DATA_DIM)).astype(np.float32)
    lo, hi = float(mel.min()), float(mel.max())
    scale = (hi - lo) / 255.0
    q = np.clip(np.round((mel - lo) / scale), 0, 255).astype(np.uint8)
    wav = (rng.normal(size=320000) * 0.1).astype(np.float32)   # 10 s at 32 kHz
    octet = {"Content-Type": "application/octet-stream",
             "X-Mel-Frames": str(T_MEL), "X-Mel-Bins": str(DATA_DIM)}
    good = [
        ("json mel 1024", json.dumps({"mel": mel.tolist()}).encode(), js),
        ("json mel 700", json.dumps({"mel": short.tolist()}).encode(), js),
        ("binary f32", mel.astype("<f4").tobytes(), octet),
        ("binary uint8", q.tobytes(), dict(octet, **{
            "X-Mel-Dtype": "uint8", "X-Mel-Scale": str(scale),
            "X-Mel-Offset": str(lo)})),
        ("json mel_q8", json.dumps({"mel_q8": q.tolist(), "scale": scale,
                                    "offset": lo}).encode(), js),
        ("json wav 10 s", json.dumps({"wav": wav.tolist(), "sr": 32000}).encode(),
         js)]
    try:
        code, health = _http(base + "/health")
        check(code == 200 and health["status"] == "ok", f"/health: {health}")
        for name, data, headers in good:
            t1 = time.perf_counter()
            code, reply = _http(base + "/caption", data, headers)
            check(code == 200 and isinstance(reply.get("caption"), str),
                  f"{name}: {code} {reply}")
            print(f"{tag}: {name}: 200 in {(time.perf_counter() - t1) * 1e3:.1f} "
                  f"ms: {reply['caption'][:60]!r}")
        code, reply = _http(base + "/caption", b'{"nope": 1}', js)
        check(code == 400, f"malformed request: {code} {reply}")
        burst = json.dumps({"mel": mel.tolist()}).encode()
        codes = []
        workers = [threading.Thread(target=lambda: codes.append(
            _http(base + "/caption", burst, js)[0])) for _ in range(16)]
        t1 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        burst_s = time.perf_counter() - t1
        check(codes == [200] * 16, f"burst replies {codes}")
        code, stats = _http(base + "/stats")
        sent_ok = len(good) + 16
        check(code == 200 and stats["requests"] == sent_ok + 1
              and stats["ok"] == sent_ok and stats["client_errors"] == 1
              and stats["server_errors"] == 0 and stats["timeouts"] == 0
              and stats["batched_requests"] == sent_ok,
              f"/stats counts differ from what was sent: {stats}")
        print(f"{tag}: 16 concurrent requests in {burst_s * 1e3:.1f} ms; /stats "
              + json.dumps({k: stats.get(k) for k in (
                  "requests", "ok", "client_errors", "batches",
                  "mean_batch_size", "latency_ms_p50", "latency_ms_p95")}))
    finally:
        server._acvae_stop()
        thread.join(timeout=30)
        server.server_close()
    check(not thread.is_alive(), "the HTTP server did not stop")
    counts = read_counts()
    # 2 warm-up batches, 5 direct ones, then the server's
    batches = 2 + 5 + stats["batches"]
    want = (per_batches(per_batch, batches) if svc.quant is not None
            else (0, 0, 0))
    got = int8_launches(counts)
    print(f"{tag}: launches over the service's {batches} batches {counts}")
    check(got == want, f"{tag}: stem_conv3x3_i8/conv3x3_i8/avgpool2x2_i8 "
                       f"launched {got} times in {batches} batches (expected "
                       f"{want})")
    # the service's decode at its defaults is BEAM_KW's, beam 3 over 20 steps
    want = batches * topk_per_search(BEAM_KW)
    check(counts["topk_rows"] == want, f"{tag}: topk_rows launched "
                                       f"{counts['topk_rows']} times in {batches} "
                                       f"batches (expected {want})")
    return counts


DECODE_RANGES = ("encoder", "decode_loop", "beam_topk")


def profile_decode(decode, out_dir, tag):
    """Trace one full-width batch of ``decode(feats, lens, generator)``; for
    the encoder, the decode loop and the top-k inside it, the kernel time
    inside each range's spans on the device timeline and the spans' total
    length (read from the exported trace: key_averages' per-range totals
    count nested ranges twice)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    g = torch.Generator("cuda").manual_seed(12)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.full((DEC_BATCH,), T_MEL, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(feats, lens, g)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    (out / f"profile_{tag}.txt").write_text(table)
    trace = out / f"trace_{tag}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [(e["ts"], e["dur"]) for e in events if "dur" in e
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernel_ms = sum(d for _, d in kernels) / 1e3
    timeline = (max(t + d for t, d in kernels) - min(t for t, _ in kernels)) / 1e3
    split = {}
    for name in DECODE_RANGES:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "gpu_user_annotation" and e["name"] == name]
        inside = sum(d for t, d in kernels if any(a <= t < b for a, b in spans))
        split[name] = {"kernel_ms": round(inside / 1e3, 3),
                       "span_ms": round(sum(b - a for a, b in spans) / 1e3, 3),
                       "spans": len(spans)}
    print(f"profile {tag}: kernel time {kernel_ms:.2f} ms over a "
          f"{timeline:.2f} ms device timeline (busy share "
          f"{kernel_ms / timeline:.3f}); profiled batch wall {wall:.2f} ms")
    print(f"profile {tag}: by range " + json.dumps(split))
    print("\n".join(table.splitlines()[:24]))


def int8_decode_parity_phase():
    """Phase 8: a small flagship (Cnn10 64->128->128->64, the widths the
    kernels take) whose int8 encoders are baked on the CPU and carried to
    the card: codes at every quantize point identical; beam-3 tokens
    identical, scores within rtol 1e-4."""
    from acvae_tpu_torch.configs import flagship_conf
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)

    E, H = 64, 32
    conf = flagship_conf(
        encoder_args={"embed_size": E, "channels": [64, 128, 128, 64]},
        decoder_args={"embed_size": E, "hidden_size": H, "dropout": 0.0},
        model_args={"posterior_model": "PosteriorRNN_hybrid",
                    "posterior_args": {"hidden_size": H},
                    "prior_model": "PriorRNN", "prior_args": {"hidden_size": H}})
    V, N, T, F, L = 25, 3, 64, 16, 8
    torch.manual_seed(9)
    cpu = build_model(conf, V, F, device="cpu")
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():   # BatchNorm statistics away from their init
        for name, buf in cpu.encoder.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.5)
    gpu = build_model(conf, V, F, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(8)
    feats = torch.tensor(rng.normal(size=(N, T, F)).astype(np.float32))
    lens = torch.tensor([64, 48, 33])
    eps = torch.randn((L, N * BEAM, E), generator=torch.Generator().manual_seed(4))
    for scheme in ("v2sym", "v2", "v4"):
        q_cpu = quant_encoder_for(conf, cpu, **scheme_kwargs(scheme))
        q_gpu = copy.deepcopy(q_cpu).to("cuda")
        codes_cpu, codes_gpu = [], []
        with torch.inference_mode():
            q_cpu(feats, lens, codes=codes_cpu)
            q_gpu(feats.cuda(), lens.cuda(), codes=codes_gpu)
        check(len(codes_cpu) == len(codes_gpu) == 8 + q_cpu.quant_tail,
              f"{scheme}: {len(codes_cpu)} and {len(codes_gpu)} quantize points")
        flipped = [int((a.cpu() != b).sum()) for a, b in zip(codes_gpu, codes_cpu)]
        outs = [int8_decode_fn(m, q, decode_method="beam", beam_size=BEAM,
                               max_length=L)(feats.to(d), lens.to(d), eps=eps.to(d))
                for m, q, d in ((gpu, q_gpu, "cuda"), (cpu, q_cpu, "cpu"))]
        a, b = (o["scores"].cpu() for o in outs)
        err = ((a - b).abs() / b.abs().clamp_min(1e-6)).max().item()
        same = torch.equal(outs[0]["seqs"].cpu(), outs[1]["seqs"])
        print(f"int8 decode parity {scheme}: codes differing at the "
              f"{len(flipped)} quantize points {flipped}; beam tokens "
              f"identical {same}, scores max rel err {err:.2e}")
        check(sum(flipped) == 0, f"{scheme}: codes differ between the card "
                                 f"and the CPU: {flipped}")
        check(same, f"{scheme}: int8 beam tokens differ between the card and "
                    f"the CPU")
        check(torch.allclose(a, b, rtol=1e-4, atol=0),
              f"{scheme}: int8 beam scores differ beyond rtol 1e-4: {err}")


def int8_serve_phase(profile_dir=None):
    """Phase 9, the slice's path: the flagship's v2sym int8 encoder,
    calibrated from bn0's statistics on the card, (a) decoding batches of
    512 at beam 3 through ``int8_decode_fn``, (b) behind the HTTP service.
    Returns the launches of (a)'s batches."""
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)
    from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment

    torch.manual_seed(7)
    with tempfile.TemporaryDirectory() as exp:
        conf = copy.deepcopy(FLAGSHIP_CONF)
        save_experiment(exp, build_model(conf, VOCAB, DATA_DIM, device="cuda"),
                        conf, flagship_vocab())
        _, vocab, model = load_experiment(exp, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))
        torch.cuda.synchronize()
        print(f"int8 serve: v2sym encoder calibrated from bn0's statistics on "
              f"the card in {time.perf_counter() - t0:.2f} s")
        int8 = int8_decode_fn(model, quant, **BEAM_KW)

        def decode(feats, lens, g):
            return int8(feats, lens, generator=g)
        counts, feats, lens = decode_rate("int8 serve decode", decode, quant,
                                          model, vocab)
        batches = 1 + DEC_TIMED
        check(int8_launches(counts) == per_batches(CNN10_PER_BATCH, batches)
              and counts["time_warp_1d"] == 0,
              f"int8 serve: launches {counts} in {batches} batches (expected "
              f"1 stem_conv3x3_i8, 7 conv3x3_i8 and 3 avgpool2x2_i8 a batch)")
        with torch.inference_mode():
            a = quant(feats, lens)["audio_embeds"].flatten()
            b = model.encode(feats, lens)["audio_embeds"].float().flatten()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        print(f"int8 serve: audio_embeds cosine to the bf16 encoder's {cos:.5f}")
        check(cos > 0.9, f"the int8 encoder strays from the bf16 one: cos {cos}")
        if profile_dir:
            profile_decode(decode, profile_dir, "int8_decode")
        del model, quant, int8, decode, feats
        torch.cuda.empty_cache()
        http_checks(exp, "int8 serve", encoder_int8=True)
    return counts


SCORE_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
              "METEOR", "SPICE", "SPIDEr")


class CliProbe:
    """Timers around the CLI's own functions, put in place for phase 10 and
    taken out after it (``restore``): the validation decode, the eval decode
    loop (and the decode calls inside it, each ending in a synchronise), the
    upload to the card, the loader's work in its producer thread (feature
    reads and collate) and the main thread's wait for each batch, per loader
    kind (shuffled = train), and the int8 calibration's kernel launches."""

    def __init__(self, cli, loader_cls):
        self.log = {k: [] for k in ("validate", "decode", "upload", "calib",
                                    "produce", "wait")}
        self._undo = []
        log = self.log

        def validate(real, *a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            log["validate"].append(time.perf_counter() - t0)
            return out

        def decode_loader(real, decode, *a, **k):
            spent = []

            def timed(*da, **dk):
                t0 = time.perf_counter()
                out = decode(*da, **dk)
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t0)
                return out
            t0 = time.perf_counter()
            out = real(timed, *a, **k)
            log["decode"].append((time.perf_counter() - t0, sum(spent), out))
            return out

        def to_device(real, *a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            log["upload"].append(time.perf_counter() - t0)
            return out

        def calib(real, *a, **k):
            before = read_counts()
            q = real(*a, **k)
            log["calib"].append({n: c - before[n] for n, c in read_counts().items()})
            return q

        def iter_batches(real, self_, skip_batches=0):
            yield from _each_timed(real(self_, skip_batches), log["produce"],
                                   self_.shuffle)

        def prefetch(real, self_, *a, **k):
            yield from _each_timed(real(self_, *a, **k), log["wait"],
                                   self_.shuffle)

        for owner, name, wrap in ((cli, "_validate", validate),
                                  (cli, "_decode_loader", decode_loader),
                                  (cli, "_to_device", to_device),
                                  (cli, "quant_encoder_for", calib),
                                  (loader_cls, "_iter_batches", iter_batches),
                                  (loader_cls, "prefetch", prefetch)):
            real = getattr(owner, name)
            self._undo.append((owner, name, real))
            setattr(owner, name, functools.partial(wrap, real)
                    if owner is cli else _method(wrap, real))

    def restore(self):
        for owner, name, real in self._undo:
            setattr(owner, name, real)


def _method(wrap, real):
    def method(self, *a, **k):
        return wrap(real, self, *a, **k)
    return method


def _each_timed(it, log, tag):
    """Yield from ``it``, appending (tag, seconds) for each item's next()."""
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            log.append((tag, time.perf_counter() - t0))
            yield item
    finally:
        it.close()


def cli_phase(tmp):
    """Phase 10: make_synthetic, train (2 epochs, then a resume to 3) and
    evaluate (bf16, int8 v2sym) through ``cli.main.main`` in ``tmp``;
    returns the kernel launches counted over all of it and the experiment
    dir."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.data.dataset import CaptionLoader

    probe = CliProbe(cli, CaptionLoader)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        return cli_path(cli, tmp, probe.log)
    finally:
        probe.restore()


def _ms(xs):
    return f"median {statistics.median(xs) * 1e3:.2f} ms (max {max(xs) * 1e3:.2f})"


def cli_path(cli, tmp, log):
    config = str(Path(__file__).resolve().parent / "configs" / "ac_vae.yaml")
    cli.main(["make_synthetic", tmp, "--rich", f"--num_audios={CLI_AUDIOS}",
              "--mel_frames=1024"])
    args = ["train", config, f"--h5_csv={tmp}/mels.csv",
            f"--caption_file={tmp}/text.json", f"--vocab_file={tmp}/vocab.pkl",
            f"--outputpath={tmp}", "--augments=[timewarp,timemask,freqmask]"]
    t0 = time.perf_counter()
    exp = Path(cli.main(args + ["--epochs=2"]))
    t1 = time.perf_counter()
    check(json.loads((exp / "ckpt_steps.json").read_text())["last"]
          == 2 * CLI_ITERS, "the first train run did not end at step 90")
    cli.main(args + ["--epochs=3", "--resume=true"])
    t2 = time.perf_counter()
    train_peak = torch.cuda.max_memory_allocated()
    log_text = (exp / "train_caption.log").read_text()
    check(f"at step {2 * CLI_ITERS} → epoch 3" in log_text,
          "the resumed run did not restore step 90 and start at epoch 3")
    last = torch.load(exp / "last.pt", map_location="cpu", weights_only=True)
    check(last["step"] == 3 * CLI_ITERS,
          f"the resumed run ended at step {last['step']}, not {3 * CLI_ITERS}")
    for name in ("best.pt", "last.pt", "ckpt_steps.json", "metrics.jsonl",
                 "config.json", "vocab.pkl"):
        check((exp / name).exists(), f"the experiment has no {name}")
    metrics = [json.loads(line) for line in
               (exp / "metrics.jsonl").read_text().splitlines()]
    check(len(metrics) == 3 and all(math.isfinite(v) for m in metrics
                                    for v in m.values()),
          f"metrics.jsonl: {metrics}")
    train_counts = read_counts()
    iters = 3 * CLI_ITERS
    check(train_counts["time_warp_1d"] == iters,
          f"time_warp_1d launched {train_counts['time_warp_1d']} times in "
          f"{iters} train iterations")
    for m, v in zip(metrics, log["validate"]):
        loop = m["epoch_wall_s"] - v
        print(f"cli train epoch {m['epoch']}: wall {m['epoch_wall_s']:.2f} s, "
              f"validation {v:.2f} s (5 batches of 32, beam 3), train loop "
              f"{loop:.2f} s = {CLI_ITERS / loop:.2f} iterations/s, "
              f"{loop / CLI_ITERS * 1e3:.1f} ms a step; loss "
              f"{m['train_loss']:.4f}, val CIDEr {m['val_cider']:.4f} ({SMI})")
    train_produce = [s for shuffled, s in log["produce"] if shuffled]
    train_wait = [s for shuffled, s in log["wait"] if shuffled]
    print(f"cli train: the loader's host time a batch (feature reads + "
          f"collate, producer thread) {_ms(train_produce)}; upload to the card "
          f"{_ms(log['upload'])}; the train loop waited for its next batch "
          f"{_ms(train_wait)}, {sum(train_wait):.2f} s in all, over "
          f"{len(train_wait)} batches; two runs {t1 - t0:.1f} + {t2 - t1:.1f} "
          f"s; peak device memory {train_peak / 2**30:.3f} GiB ({SMI})")

    for tag, extra in (("bf16", []), ("int8", ["--encoder_int8"])):
        log["decode"].clear()
        del log["wait"][:], log["produce"][:]
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores = cli.main(["evaluate", str(exp),
                           f"--eval_caption_file={tmp}/text.json"] + extra)
        wall = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in read_counts().items()}
        suffix = "_int8" if extra else ""
        for name in (f"eval_output_beam_3{suffix}.json",
                     f"scores_beam_3{suffix}.txt"):
            check((exp / name).exists(), f"evaluate wrote no {name}")
        lines = dict(line.split(": ", 1) for line in
                     (exp / f"scores_beam_3{suffix}.txt").read_text().splitlines()
                     if not line.startswith("#"))
        check(all(k in lines and math.isfinite(float(lines[k])) for k in SCORE_KEYS),
              f"scores_beam_3{suffix}.txt: {lines}")
        (loop_s, dec_s, pairs), = log["decode"]
        check(len(pairs) == CLI_AUDIOS, f"{len(pairs)} eval captions")
        calib = log["calib"][-1] if extra else dict.fromkeys(counts, 0)
        want = (per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES) if extra
                else (0, 0, 0))
        got = int8_launches(counts, calib)
        check(got == want and counts["time_warp_1d"] == 0,
              f"evaluate {tag}: launches {counts} (calibration {calib}); "
              f"expected {want} in {CLI_EVAL_BATCHES} batches")
        wait = [s for _, s in log["wait"]]
        print(f"cli evaluate {tag}: {CLI_AUDIOS} clips in {CLI_EVAL_BATCHES} "
              f"batches of 32, beam 3: decode loop {loop_s:.2f} s = "
              f"{CLI_AUDIOS / loop_s:.1f} clips/s, of which the decode calls "
              f"{dec_s:.2f} s and the wait for batches {sum(wait):.2f} s "
              f"(loader host time a batch {_ms([s for _, s in log['produce']])}); "
              f"command {wall:.2f} s with load, "
              + ("calibration, " if extra else "") + "scoring; CIDEr "
              f"{scores['CIDEr']:.4f}, SPIDEr {scores['SPIDEr']:.4f}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB; launches {counts}, of which calibration {calib} ({SMI})")
    counts = read_counts()
    print(f"cli: launches over the path {counts} ({SMI})")
    return counts, exp


def diverse_phase(tmp, exp, profile_dir=None):
    """Phase 11, the diverse path: (a) a small flagship on the card against
    the CPU (dbs, the two-member ensemble engines, one bf16 step); (b) the
    int8 dbs decode at full width, and the bf16 decode beside it; (c) the
    user's commands on phase 10's experiment and corpus; (d) the services.
    Returns the kernel launches over (b)-(d)."""
    diverse_parity()
    total = dict.fromkeys(kernel_fns(), 0)
    for counts in (diverse_full_width(profile_dir), diverse_cli(tmp, exp),
                   diverse_services(exp)):
        for k, v in counts.items():
            total[k] += v
    print(f"diverse: launches over the path {total} ({SMI})")
    return total


def diverse_parity():
    """(a) Same weights, same noise, card and CPU: dbs at (beam 8, group 4,
    lambda 0.5) and (8, 8) token-identical with scores within rtol 1e-4; a
    two-member ensemble_beam and ensemble_greedy token-identical; one bf16
    decode_step_api step within 3e-2 of the largest logit (the CPU test's
    tolerance against JAX)."""
    from acvae_tpu_torch.decoding.ensemble import ensemble_decode
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.ops.amp import cast_floats_for_decode

    conf = small_conf()
    V, N, T, F, E = 25, 3, 8, 16, 16
    torch.manual_seed(21)
    gpus = [build_model(conf, V, F, device="cuda") for _ in range(2)]
    cpus = [build_model(conf, V, F, device="cpu") for _ in range(2)]
    for c, g in zip(cpus, gpus):
        c.load_state_dict({k: v.cpu() for k, v in g.state_dict().items()})
    rng = np.random.default_rng(21)
    feats = torch.tensor(rng.normal(size=(N, 64, F)).astype(np.float32))
    lens = torch.tensor([64, 48, 33])
    gen = torch.Generator().manual_seed(21)
    sides = (("cuda", gpus), ("cpu", cpus))
    for beam, group in ((8, 4), (8, 8)):
        eps = torch.randn((group, T + group - 1, N * (beam // group), E),
                          generator=gen)
        outs = [ms[0].inference_forward(
            feats.to(d), lens.to(d), decode_method="dbs", beam_size=beam,
            group_size=group, diversity_lambda=0.5, max_length=T,
            eps=eps.to(d)) for d, ms in sides]
        a, b = (o["scores"].cpu() for o in outs)
        err = ((a - b).abs() / b.abs().clamp_min(1e-6)).max().item()
        same = torch.equal(outs[0]["seqs"].cpu(), outs[1]["seqs"])
        print(f"diverse parity dbs b{beam} g{group}: seqs "
              f"{tuple(outs[0]['seqs'].shape)} identical {same}, scores max "
              f"rel err {err:.2e}")
        check(same, f"dbs b{beam} g{group} tokens differ between the card "
                    f"and the CPU")
        check(torch.allclose(a, b, rtol=1e-4, atol=0),
              f"dbs b{beam} g{group} scores differ beyond rtol 1e-4: {err}")
    for method in ("beam", "greedy"):
        NB = N * (BEAM if method == "beam" else 1)
        eps = [torch.randn((T, NB, E), generator=gen) for _ in range(2)]
        outs = [ensemble_decode(ms, feats.to(d), lens.to(d),
                                decode_method=method, beam_size=BEAM,
                                max_length=T, eps=[e.to(d) for e in eps])
                for d, ms in sides]
        same = torch.equal(outs[0]["seqs"].cpu(), outs[1]["seqs"])
        print(f"diverse parity ensemble {method} (2 members): tokens "
              f"identical {same}")
        check(same, f"ensemble {method} tokens differ between the card and "
                    f"the CPU")
    state = [torch.randn((N, E), generator=gen) for _ in range(4)]
    words, eps_t = torch.tensor([1, 7, 12]), torch.randn((N, E), generator=gen)
    logits = []
    for d, ms in sides:
        m = cast_floats_for_decode(ms[0], torch.bfloat16)
        s16 = [x.to(d, torch.bfloat16) for x in state]
        with torch.inference_mode():
            ctx = m.decode_ctx(m.encode(feats.to(d), lens.to(d)))
            out, _ = m.decode_step_api(ctx, (s16[0], (s16[1], s16[2]), s16[3]),
                                       words.to(d),
                                       eps_t.to(d, torch.bfloat16))
        check(out.dtype == torch.bfloat16, f"bf16 step logits in {out.dtype}")
        logits.append(out.float().cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    top = logits[1].abs().max().item()
    print(f"diverse parity bf16 decode_step_api: max |dlogit| {err:.3e} "
          f"against max |logit| {top:.3e}")
    check(err <= 3e-2 * top, f"bf16 step differs between the card and the "
                             f"CPU: {err} > 3e-2 * {top}")


def diverse_full_width(profile_dir=None):
    """(b) The flagship through save_experiment/load_experiment, its v2sym
    int8 encoder calibrated from bn0's statistics: dbs (beam 8, 4 groups,
    lambda 0.5) over batches of 512, 1 stem_conv3x3_i8, 7 conv3x3_i8 and 3
    avgpool2x2_i8 a batch; then the bf16 decode (beam 3, bf16 parameters) at the same batch
    beside phase 7's float32 loop.  Returns the launches of the dbs
    batches."""
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)
    from acvae_tpu_torch.ops.amp import cast_floats_for_decode
    from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment

    torch.manual_seed(7)
    with tempfile.TemporaryDirectory() as d:
        conf = copy.deepcopy(FLAGSHIP_CONF)
        save_experiment(d, build_model(conf, VOCAB, DATA_DIM, device="cuda"),
                        conf, flagship_vocab())
        _, vocab, model = load_experiment(d, device="cuda")
    quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))
    int8 = int8_decode_fn(model, quant, **DBS_KW)

    def decode(feats, lens, g):
        return int8(feats, lens, generator=g)
    counts, _, _ = decode_rate("diverse int8 dbs decode", decode, quant, model,
                               vocab, DBS_KW)
    batches = 1 + DEC_TIMED
    check(int8_launches(counts) == per_batches(CNN10_PER_BATCH, batches)
          and counts["time_warp_1d"] == 0,
          f"int8 dbs: launches {counts} in {batches} batches (expected 1 "
          f"stem_conv3x3_i8, 7 conv3x3_i8 and 3 avgpool2x2_i8 a batch)")
    if profile_dir:
        profile_decode(decode, profile_dir, "int8_dbs_decode")
    del int8, quant, decode
    bf16 = cast_floats_for_decode(model, torch.bfloat16)
    del model
    torch.cuda.empty_cache()

    def decode16(feats, lens, g):
        return bf16.inference_forward(feats, lens, generator=g, **BEAM_KW)
    decode_rate("diverse bf16 decode", decode16, bf16.encode, bf16, vocab)
    print(f"bf16 decode (bf16 parameters, bf16 encoder, beam {BEAM}): "
          f"{RATES['diverse bf16 decode']:.1f} captions/s against phase 7's "
          f"float32 loop {RATES.get('serve decode', float('nan')):.1f} "
          f"captions/s in this call ({SMI})")
    del bf16, decode16
    torch.cuda.empty_cache()
    return counts


DIV_KEYS = ("Div1", "Div2", "gDiv1", "mBLeu_1", "mBLeu_2", "mBLeu_3",
            "mBLeu_4", "SelfBLEU", "Novelty")


def diverse_cli(tmp, exp):
    """(c) On phase 10's experiment and corpus, in process: evaluate at dbs
    (beam 20, 4 groups) with the bf16 encoder and with --encoder_int8, and
    with --decode_dtype=bfloat16; diversity of the dbs output against the
    corpus; predict; ensemble of the experiment with itself; human_eval.
    Returns the launches (the int8 calibration's included, and reported
    apart)."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.data.dataset import CaptionLoader

    probe = CliProbe(cli, CaptionLoader)
    log = probe.log
    text = f"--eval_caption_file={tmp}/text.json"
    reset_counts()
    try:
        runs = (("dbs bf16", ["--decode_method=dbs", "--beam_size=20",
                              "--group_size=4"], "dbs_20", 20),
                ("dbs int8", ["--decode_method=dbs", "--beam_size=20",
                              "--group_size=4", "--encoder_int8"],
                 "dbs_20_int8", 20),
                ("bf16 decode", ["--decode_dtype=bfloat16"], "beam_3_bfloat16",
                 1))
        for tag, extra, name, per_clip in runs:
            log["decode"].clear()
            del log["wait"][:], log["produce"][:]
            before = read_counts()
            t0 = time.perf_counter()
            scores = cli.main(["evaluate", str(exp), text] + extra)
            wall = time.perf_counter() - t0
            counts = {k: v - before[k] for k, v in read_counts().items()}
            for f in (f"eval_output_{name}.json", f"scores_{name}.txt"):
                check((exp / f).exists(), f"evaluate {tag} wrote no {f}")
            check(all(math.isfinite(scores[k]) for k in SCORE_KEYS),
                  f"evaluate {tag}: scores {scores}")
            preds = json.loads((exp / f"eval_output_{name}.json").read_text())
            n_caps = [len(p.get("captions", [p.get("caption")]))
                      for p in preds["predictions"]]
            check(len(n_caps) == CLI_AUDIOS and set(n_caps) == {per_clip},
                  f"evaluate {tag}: {len(n_caps)} clips, candidates "
                  f"{sorted(set(n_caps))}")
            (loop_s, dec_s, pairs), = log["decode"]
            int8 = "--encoder_int8" in extra
            calib = log["calib"][-1] if int8 else dict.fromkeys(counts, 0)
            want = (per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES) if int8
                    else (0, 0, 0))
            got = int8_launches(counts, calib)
            check(got == want and counts["time_warp_1d"] == 0,
                  f"evaluate {tag}: launches {counts} (calibration {calib}); "
                  f"expected {want} in {CLI_EVAL_BATCHES} batches")
            print(f"cli evaluate {tag}: {CLI_AUDIOS} clips x {per_clip} "
                  f"candidates in {CLI_EVAL_BATCHES} batches of 32: decode "
                  f"loop {loop_s:.2f} s = {CLI_AUDIOS / loop_s:.1f} clips/s, "
                  f"{CLI_AUDIOS * per_clip / loop_s:.1f} candidates/s (decode "
                  f"calls {dec_s:.2f} s); command {wall:.2f} s; CIDEr "
                  f"{scores['CIDEr']:.4f}; launches {counts}, of which "
                  f"calibration {calib} ({SMI})")
    finally:
        probe.restore()
    t0 = time.perf_counter()
    div = cli.main(["diversity", str(exp / "eval_output_dbs_20.json"),
                    f"{tmp}/text.json"])
    div_s = time.perf_counter() - t0
    check(set(DIV_KEYS) <= set(div)
          and all(math.isfinite(div[k]) for k in DIV_KEYS)
          and all(0.0 <= div[k] <= 1.0 for k in DIV_KEYS if k != "gDiv1"),
          f"diversity: {div}")
    print(f"cli diversity of the dbs output: {json.dumps(div)} in "
          f"{div_s:.2f} s")
    t0 = time.perf_counter()
    csv_path = cli.main(["predict", str(exp), f"{tmp}/mels.csv",
                         f"--output={tmp}/predictions.csv"])
    rows = Path(csv_path).read_text().splitlines()
    check(rows[0] == "file_name,caption_predicted" and len(rows) == CLI_AUDIOS + 1,
          f"predict wrote {len(rows)} lines")
    print(f"cli predict: {len(rows) - 1} rows in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ens = cli.main(["ensemble", str(exp), str(exp), "--checkpoint=last", text])
    check((exp / "ensemble_scores.txt").exists()
          and all(math.isfinite(ens[k]) for k in SCORE_KEYS),
          f"ensemble: {ens}")
    print(f"cli ensemble <exp> <exp> --checkpoint=last: CIDEr "
          f"{ens['CIDEr']:.4f} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    human = cli.main(["human_eval", f"{tmp}/text.json"])
    check(all(math.isfinite(v) for v in human.values()), f"human_eval: {human}")
    print(f"cli human_eval: CIDEr {human['CIDEr']:.4f}, Div1 "
          f"{human['Div1']:.4f} in {time.perf_counter() - t0:.2f} s")
    return read_counts()


def diverse_services(exp):
    """(d) CaptionService on phase 10's experiment at dbs (beam 8, 4
    groups), as a two-member ensemble, with bf16 decode parameters and with
    bf16 uploads: each captions 16 clips; the dbs service answers one HTTP
    request.  Returns their launches."""
    from acvae_tpu_torch.serve import CaptionService, run_server

    reset_counts()
    rng = np.random.default_rng(31)
    mels = [rng.normal(size=(T_MEL, DATA_DIM)).astype(np.float32)
            for _ in range(16)]
    dbs = {k: v for k, v in DBS_KW.items() if k != "max_length"}
    for tag, path, kw in (("dbs b8 g4", str(exp), dbs),
                          ("ensemble of 2", f"{exp},{exp}", {}),
                          ("bf16 decode", str(exp), {"decode_dtype": "bfloat16"}),
                          ("bf16 upload", str(exp), {"upload_dtype": "bfloat16"})):
        t0 = time.perf_counter()
        svc = CaptionService(path, **kw)
        ready = time.perf_counter() - t0
        t0 = time.perf_counter()
        caps = svc.caption(mels)
        ms = (time.perf_counter() - t0) * 1e3
        check(len(caps) == 16 and all(isinstance(c, str) for c in caps),
              f"service {tag}: {caps}")
        print(f"diverse service {tag}: ready in {ready:.1f} s, 16 clips in "
              f"{ms:.1f} ms: {caps[0][:60]!r}")
        if tag.startswith("dbs"):
            server = run_server(svc, port=0, block=False)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                t0 = time.perf_counter()
                code, reply = _http(
                    f"http://127.0.0.1:{server.server_address[1]}/caption",
                    json.dumps({"mel": mels[0].tolist()}).encode(),
                    {"Content-Type": "application/json"})
                check(code == 200 and isinstance(reply.get("caption"), str),
                      f"dbs service over HTTP: {code} {reply}")
                print(f"diverse service {tag}: HTTP 200 in "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            finally:
                server._acvae_stop()
                thread.join(timeout=30)
                server.server_close()
            check(not thread.is_alive(), "the dbs HTTP server did not stop")
        del svc
    return read_counts()


# ---------------------------------------------------------------------- #
# phase 12: the other model families
# ---------------------------------------------------------------------- #
FAMILIES = ("vae", "gmm_vae", "simple_vae", "trans_vae", "attn_rnn_xe",
            "xe_baseline")
FAM_STEPS = 3
CONFIGS = Path(__file__).resolve().parent / "configs"


def recipe_conf(recipe, small=False):
    """``configs/<recipe>.yaml`` with the time warp on; ``small`` cuts it to
    Cnn10 4-8-8-16, embed 16 and no dropout (the card-vs-CPU checks)."""
    from acvae_tpu_torch.core.config import load_config
    conf = json.loads(json.dumps(load_config(str(CONFIGS / f"{recipe}.yaml"))))
    conf.update(augments=["timewarp", "timemask", "freqmask"], data_dim=DATA_DIM)
    if small:
        conf["encoder_args"] = {"embed_size": 16, "channels": [4, 8, 8, 16],
                                "conv_dropout": 0.0, "head_dropout": 0.0}
        dec = dict(conf["decoder_args"], embed_size=16, dropout=0.0)
        dec.update(dict(nhead=2, hidden_size=32) if "nhead" in dec
                   else dict(hidden_size=16))
        conf["decoder_args"] = dec
        for key in ("posterior_args", "prior_args"):
            if key in conf.get("model_args", {}):
                conf["model_args"][key]["hidden_size"] = 12
    return conf


def family_noise(model, recipe, method, N, T, g, beam=3, groups=2):
    """The prior draws a decode of ``recipe`` takes, on the CPU (None for
    the plain captioners)."""
    E = model.decoder.embed_size
    if recipe in ("attn_rnn_xe", "xe_baseline"):
        return None
    rows = {"beam": N * beam, "dbs": N * (beam // groups)}.get(method, N)
    if recipe == "simple_vae":
        return torch.randn((groups, rows, E) if method == "dbs" else (rows, E),
                           generator=g)
    if method == "dbs":
        return torch.randn((groups, T + groups - 1, rows, E), generator=g)
    return torch.randn((T, rows, E), generator=g)


def families_parity():
    """(a) Card against CPU at a small size, same weights and noise."""
    from acvae_tpu_torch.models.build import build_model

    V, N, F, T = 25, 3, 16, 8
    rng = np.random.default_rng(41)
    feats = torch.tensor(rng.normal(size=(N, 64, F)).astype(np.float32))
    lens = torch.tensor([64, 48, 33])
    for recipe in FAMILIES:
        conf = recipe_conf(recipe, small=True)
        torch.manual_seed(41)
        cpu = build_model(conf, V, F, device="cpu")
        gpu = build_model(conf, V, F, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(41)
        report = []
        for method, kw in (("greedy", {}), ("beam", {"beam_size": 3}),
                           ("dbs", {"beam_size": 4, "group_size": 2,
                                    "diversity_lambda": 0.5})):
            eps = family_noise(cpu, recipe, method, N, T, g,
                               beam=kw.get("beam_size", 3))
            outs = [m.inference_forward(
                feats.to(d), lens.to(d), decode_method=method, max_length=T,
                eps=None if eps is None else eps.to(d), **kw)
                for m, d in ((gpu, "cuda"), (cpu, "cpu"))]
            same = torch.equal(outs[0]["seqs"].cpu(), outs[1]["seqs"])
            report.append(f"{method} identical {same}")
            check(same, f"families {recipe}: {method} tokens differ between "
                        f"the card and the CPU")
            if method == "greedy":
                seqs, g_eps = outs[1]["seqs"], eps
        forced = [m.forced_decode(feats.to(d), lens.to(d), seqs.to(d),
                                  eps=None if g_eps is None else g_eps.to(d))
                  ["sampled_logprobs"].cpu() for m, d in ((gpu, "cuda"),
                                                          (cpu, "cpu"))]
        err = (forced[0] - forced[1]).abs().max().item()
        print(f"families parity {recipe} ({type(cpu).__name__}): "
              f"{', '.join(report)}; forced_decode max |dlogprob| {err:.2e}")
        check(err <= 1e-4, f"families {recipe}: forced_decode log-probs "
                           f"differ by {err} between the card and the CPU")


def family_rate(recipe, model, vocab):
    """(b) One warm-up and one timed beam-3 batch of DEC_BATCH clips; then
    one more split into the encoder and the search.  Returns captions/s."""
    g = torch.Generator("cuda").manual_seed(11)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.full((DEC_BATCH,), T_MEL, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = model.inference_forward(feats, lens, generator=g, **BEAM_KW)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    seqs, scores = out["seqs"], out["scores"]
    check(tuple(seqs.shape) == (DEC_BATCH, BEAM, MAX_LEN)
          and bool(((seqs >= 0) & (seqs < VOCAB)).all())
          and bool(torch.isfinite(scores).all()),
          f"{recipe}: beam output {tuple(seqs.shape)}")
    decode = (getattr(model, "inference_from_encoded", None) or model._decode)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = model.encode(feats, lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode(enc, generator=g, **BEAM_KW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rate = DEC_BATCH / (ms[1] / 1e3)
    print(f"families {recipe} beam 3, batch {DEC_BATCH}: {rate:.1f} captions/s "
          f"(timed batch {ms[1]:.1f} ms, warm-up {ms[0]:.1f}); split encoder "
          f"{(t1 - t0) * 1e3:.1f} ms / loop {(t2 - t1) * 1e3:.1f} ms "
          f"({(t2 - t1) / (t2 - t0):.2f} of the batch); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; first caption "
          f"{' '.join(vocab.decode(seqs[0, 0].cpu().numpy()))!r} ({SMI})")
    return rate


def family_int8(recipe, conf, model):
    """(c) The v2sym int8 encoder in front of the family's beam-3 decode at
    batch 512 (1 + 7 + 3 launches a batch), and its codes card vs CPU."""
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)
    quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))
    q_cpu = copy.deepcopy(quant).to("cpu")
    rng = np.random.default_rng(43)
    x = torch.tensor(rng.normal(size=(2, 256, DATA_DIM)).astype(np.float32))
    xl = torch.tensor([256, 200])
    codes_gpu, codes_cpu = [], []
    with torch.inference_mode():
        quant(x.to("cuda"), xl.to("cuda"), codes=codes_gpu)
        q_cpu(x, xl, codes=codes_cpu)
    flipped = [int((a.cpu() != b).sum()) for a, b in zip(codes_gpu, codes_cpu)]
    check(len(flipped) == 8 and sum(flipped) == 0,
          f"families {recipe} int8: codes differ card vs CPU {flipped}")
    int8 = int8_decode_fn(model, quant, **BEAM_KW)
    g = torch.Generator("cuda").manual_seed(11)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.full((DEC_BATCH,), T_MEL, device="cuda")
    reset_counts()
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = int8(feats, lens, generator=g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    check(int8_launches(counts) == per_batches(CNN10_PER_BATCH, 2)
          and counts["time_warp_1d"] == 0,
          f"families {recipe} int8: launches {counts} in 2 batches (expected "
          f"1 stem_conv3x3_i8, 7 conv3x3_i8 and 3 avgpool2x2_i8 a batch)")
    check(bool(((out["seqs"] >= 0) & (out["seqs"] < VOCAB)).all()),
          f"families {recipe} int8: a token outside the vocab")
    print(f"families {recipe} int8 v2sym beam 3, batch {DEC_BATCH}: "
          f"{DEC_BATCH / (ms[1] / 1e3):.1f} captions/s (timed batch "
          f"{ms[1]:.1f} ms); codes card vs CPU differ at {flipped}; launches "
          f"{counts} ({SMI})")
    return counts


def families_full_width():
    """(b), (c): train steps, the beam-3 rate and, for the two int8
    families, the int8 decode; returns the launches."""
    from acvae_tpu_torch.train.trainer import Trainer

    vocab = flagship_vocab()
    total = dict.fromkeys(kernel_fns(), 0)
    epoch = 12
    it0 = ITERS_PER_EPOCH * (epoch - 1)
    for recipe in FAMILIES:
        conf = recipe_conf(recipe)
        torch.manual_seed(7)
        trainer = Trainer(conf, VOCAB, DATA_DIM, device="cuda",
                          total_iters=ITERS_PER_EPOCH * EPOCHS)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        rng = np.random.default_rng(1)
        reset_counts()
        step_ms = []
        for i in range(FAM_STEPS):
            batch = make_batch(rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.step(batch, it0 + 1 + i, epoch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            vals = {k: float(v) for k, v in m.items()}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"families {recipe}: non-finite metric at step {i + 1}: {vals}")
        counts = read_counts()
        check(counts["time_warp_1d"] == FAM_STEPS,
              f"families {recipe}: time_warp_1d launched "
              f"{counts['time_warp_1d']} times in {FAM_STEPS} steps")
        total["time_warp_1d"] += counts["time_warp_1d"]
        print(f"families {recipe} ({type(trainer.model).__name__}, {n_params} "
              f"params) train: step ms {', '.join(f'{t:.1f}' for t in step_ms)}"
              f"; median of steps 2-{FAM_STEPS} "
              f"{statistics.median(step_ms[1:]):.1f}; loss {vals['loss']:.4f}; "
              + ", ".join(f"{k} {vals[k]:.4f}" for k in ("ce", "kl")
                          if k in vals) + f"; launches {counts} ({SMI})")
        model = trainer.model.eval()
        del trainer
        family_rate(recipe, model, vocab)
        if hasattr(model, "inference_from_encoded"):
            for k, v in family_int8(recipe, conf, model).items():
                total[k] += v
        del model
        torch.cuda.empty_cache()
    return total


def families_cli(tmp):
    """(d) train (1 epoch) and evaluate through the CLI on phase 10's
    corpus for three recipes; returns the launches."""
    from acvae_tpu_torch.cli import main as cli

    total = dict.fromkeys(kernel_fns(), 0)
    for recipe in ("vae", "trans_vae", "xe_baseline"):
        reset_counts()
        t0 = time.perf_counter()
        exp = Path(cli.main([
            "train", str(CONFIGS / f"{recipe}.yaml"), f"--h5_csv={tmp}/mels.csv",
            f"--caption_file={tmp}/text.json", f"--vocab_file={tmp}/vocab.pkl",
            f"--outputpath={tmp}/families", "--epochs=1",
            "--augments=[timewarp,timemask,freqmask]"]))
        train_s = time.perf_counter() - t0
        counts = read_counts()
        check(counts["time_warp_1d"] == CLI_ITERS,
              f"families cli {recipe}: time_warp_1d launched "
              f"{counts['time_warp_1d']} times in {CLI_ITERS} iterations")
        m = json.loads((exp / "metrics.jsonl").read_text().splitlines()[-1])
        check(math.isfinite(m["train_loss"]), f"families cli {recipe}: {m}")
        line = (f"families cli {recipe}: train 1 epoch ({CLI_ITERS} iterations)"
                f" {train_s:.1f} s, epoch wall {m['epoch_wall_s']:.2f} s, loss "
                f"{m['train_loss']:.4f}, val CIDEr {m['val_cider']:.4f}")
        for extra in ([], ["--encoder_int8"]) if recipe == "vae" else ([],):
            before = read_counts()
            t0 = time.perf_counter()
            scores = cli.main(["evaluate", str(exp),
                               f"--eval_caption_file={tmp}/text.json"] + extra)
            wall = time.perf_counter() - t0
            got = {k: v - before[k] for k, v in read_counts().items()}
            check(all(math.isfinite(scores[k]) for k in SCORE_KEYS),
                  f"families cli {recipe} evaluate {extra}: {scores}")
            want = (per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES) if extra
                    else (0, 0, 0))
            check(int8_launches(got) == want,
                  f"families cli {recipe} evaluate {extra}: launches {got}, "
                  f"expected {want} (the calibration launches none)")
            line += (f"; evaluate{' int8' if extra else ''} {wall:.2f} s "
                     f"({CLI_AUDIOS / wall:.1f} clips/s with load and scoring), "
                     f"CIDEr {scores['CIDEr']:.4f}")
        print(line + f" ({SMI})")
        for k, v in read_counts().items():
            total[k] += v
    return total


def families_phase(tmp):
    """Phase 12; returns the kernel launches of (b)-(d)."""
    families_parity()
    total = dict.fromkeys(kernel_fns(), 0)
    for counts in (families_full_width(), families_cli(tmp)):
        for k, v in counts.items():
            total[k] += v
    print(f"families: launches over the path {total} ({SMI})")
    return total


# phase 13: mid-epoch snapshots every SNAP_EVERY iterations of the 2-epoch
# run, its injected fault at FAULT_AT; a few N-SCST iterations at
# SCST_SAMPLE_N samples a clip
SNAP_EVERY, FAULT_AT, SCST_SAMPLE_N, SCST_N_ITERS = 20, 42, 5, 3
# card against card: an interrupted-and-resumed run against an
# uninterrupted one; cuBLAS/cuDNN backward sums need not be bit-deterministic
# (measured equal on an H100 80GB HBM3 at 700 W)
RESUME_RTOL = 1e-3
# the SCST replay's log-probs against the rollout's, same card and weights
REPLAY_ATOL = 1e-4


def extras_phase(tmp, exp):
    """Phase 13 on phase 10's corpus and experiment: (a) mid-epoch
    snapshots, a fault and a resume against an uninterrupted run; (b) one
    epoch with the other train keys; (c) SCST and N-SCST; (d)
    ``average_checkpoints``, ``evaluate --checkpoint=avg`` (bf16, int8) and
    ``diagnose``; (e) the optimizer state's dtypes.  Returns the kernel
    launches over all of it."""
    from acvae_tpu_torch.cli import main as cli

    config = str(CONFIGS / "ac_vae.yaml")
    args = ["train", config, f"--h5_csv={tmp}/mels.csv",
            f"--caption_file={tmp}/text.json", f"--vocab_file={tmp}/vocab.pkl",
            "--augments=[timewarp,timemask,freqmask]"]
    torch.cuda.synchronize()
    reset_counts()
    warps = extras_snapshots(cli, tmp, args, exp)
    warps += extras_keys(cli, tmp, args, exp)
    counts = read_counts()
    check(counts["time_warp_1d"] == warps,
          f"extras: time_warp_1d launched {counts['time_warp_1d']} times in "
          f"{warps} train iterations")
    extras_scst(cli, exp)
    extras_average(cli, tmp, exp)
    before = read_counts()["time_warp_1d"]
    warps = extras_state_dtypes()
    counts = read_counts()
    check(counts["time_warp_1d"] - before == warps,
          f"extras state dtypes: time_warp_1d launched "
          f"{counts['time_warp_1d'] - before} times in {warps} steps")
    for k, v in counts.items():
        check(v > 0, f"extras: {k} never launched on the path")
    print(f"extras: launches over the path {counts} ({SMI})")
    return counts


class _Timed:
    """Wall times (synchronised) of the calls of ``owner.name`` while in
    place; ``restore()`` puts the original back."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = real = getattr(owner, name)
        self.times, self.starts = [], []

        def timed(*a, **k):
            t0 = time.perf_counter()
            self.starts.append(t0)
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            return out
        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.real)


def extras_snapshots(cli, tmp, args, exp):
    """(a) 2 epochs with a snapshot every SNAP_EVERY iterations, stopped by
    ``fault_abort_step`` at FAULT_AT, then ``--resume=true`` from the newest
    snapshot; held against phase 10's first run (``exp``), the same
    command uninterrupted and without snapshots.  Returns the train
    iterations run (one ``time_warp_1d`` each)."""
    from acvae_tpu_torch.train.trainer import Trainer

    run = args + ["--epochs=2", f"--checkpoint_every_steps={SNAP_EVERY}",
                  f"--outputpath={tmp}/extras_a"]
    saves = _Timed(cli, "save_checkpoint")
    try:
        try:
            cli.main(run + [f"--fault_abort_step={FAULT_AT}"])
        except SystemExit as e:
            msg = str(e)
        else:
            msg = None
        snap_s = list(saves.times)
    finally:
        saves.restore()
    check(msg == f"fault_abort_step: injected failure at step {FAULT_AT}",
          f"the interrupted run ended with {msg!r}")
    exp_a = next(Path(f"{tmp}/extras_a").glob("*/*/seed_1"))
    meta = json.loads((exp_a / "ckpt_steps.json").read_text())
    newest = FAULT_AT // SNAP_EVERY * SNAP_EVERY
    # the two newest snapshots, one in each slot
    want = {f"step_{(s // SNAP_EVERY) % 2}": s
            for s in (newest - SNAP_EVERY, newest)}
    check({k: meta.get(k) for k in want} == want
          and all((exp_a / f"{k}.pt").exists() for k in want),
          f"snapshots after the fault: ckpt_steps.json {meta}, expected {want}")
    size_mb = (exp_a / f"step_{(newest // SNAP_EVERY) % 2}.pt").stat().st_size / 2**20

    first = _Timed(Trainer, "step")
    try:
        t0 = time.perf_counter()
        cli.main(run + ["--resume=true"])
        to_first = first.starts[0] - t0
    finally:
        first.restore()
    iters = 2 * CLI_ITERS
    log = (exp_a / "train_caption.log").read_text()
    check(f"at step {newest} → epoch 1 (skipping {newest} consumed batches)"
          in log, f"the resume did not restore step {newest}")
    last = torch.load(exp_a / "last.pt", map_location="cpu", weights_only=True)
    check(last["step"] == iters, f"the resumed run ended at {last['step']}")
    check(not list(exp_a.glob("step*.pt")), "stale snapshots left after last")
    # phase 10's first two epochs are the uninterrupted run: its
    # ckpt_steps.json then held last 90 and the best of their scores
    ma = [json.loads(x) for x in (exp_a / "metrics.jsonl").read_text().splitlines()]
    mb = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()][:2]
    best = 0.0
    for m in mb:
        best = max(best, m["val_cider"])
    meta_a = json.loads((exp_a / "ckpt_steps.json").read_text())
    check(meta_a.keys() == {"last", "best_score"} and meta_a["last"] == iters,
          f"ckpt_steps.json after the resume: {meta_a}")
    # epoch 1's line of the resumed run averages only the batches after
    # the resume, as the JAX CLI's does; epoch 2 is whole in both
    check(len(ma) == 2, f"metrics.jsonl lines after the resume: {len(ma)}")
    rel = abs(ma[1]["train_loss"] - mb[1]["train_loss"]) / abs(mb[1]["train_loss"])
    d_best = abs(meta_a["best_score"] - best)
    print(f"extras snapshots: save {_ms(snap_s)} a snapshot, {size_mb:.1f} MB; "
          f"resume to the first step {to_first * 1e3:.0f} ms; epoch 2 train "
          f"loss resumed {ma[1]['train_loss']:.6f} / uninterrupted "
          f"{mb[1]['train_loss']:.6f} (rel {rel:.2e}); best_score "
          f"{meta_a['best_score']:.6f} / {best:.6f} ({SMI})")
    check(rel <= RESUME_RTOL and d_best <= RESUME_RTOL * max(best, 1e-3),
          f"the resumed run is off the uninterrupted one: train loss rel "
          f"{rel:.2e}, best_score {d_best:.2e} (rtol {RESUME_RTOL})")
    return FAULT_AT + (iters - newest)


def extras_keys(cli, tmp, args, exp):
    """(b) One epoch with accumulation, the plateau, the KL variants, AdamW,
    a frozen word embedding, a warm start from phase 10's best and a
    profile.  Returns the iterations run."""
    from acvae_tpu_torch.train.profiling import Trace
    from acvae_tpu_torch.train.trainer import Trainer

    out, prof = f"{tmp}/extras_keys", f"{tmp}/extras_profile"
    steps, stops = _Timed(Trainer, "step"), _Timed(Trace, "stop")
    try:
        t0 = time.perf_counter()
        exp_k = Path(cli.main(args + [
            "--epochs=1", f"--outputpath={out}", "--accum_steps=2",
            "--scheduler=ReduceLROnPlateau",
            "--scheduler_args={patience: 0, factor: 0.5}", "--global_loss=kl",
            "--free_bits=0.05", "--kl_anneal={mode: cyclical, cycles: 2}",
            "--optimizer=AdamW",
            "--optimizer_args={lr: 0.0005, weight_decay: 0.01}",
            "--freeze_word_embedding=true", f"--pretrained={exp}/best.pt",
            f"--profile_dir={prof}"]))
        wall = time.perf_counter() - t0
    finally:
        steps.restore()
        stops.restore()
    src = torch.load(exp / "best.pt", map_location="cpu", weights_only=True)
    last = torch.load(exp_k / "last.pt", map_location="cpu", weights_only=True)
    frozen = [k for k in src["state_dict"] if "word_embedding" in k]
    check(len(frozen) == 3 and all(torch.equal(last["state_dict"][k],
                                               src["state_dict"][k])
                                   for k in frozen),
          f"the frozen word embeddings {frozen} moved")
    check("pretrained[params]: loaded" in (exp_k / "train_caption.log").read_text(),
          "no 'pretrained[params]: loaded' line in the log")
    m = json.loads((exp_k / "metrics.jsonl").read_text().splitlines()[-1])
    meta = json.loads((exp_k / "ckpt_steps.json").read_text())
    check("kl_raw" in m and all(math.isfinite(v) for v in m.values()),
          f"metrics.jsonl: {m}")
    check({"plateau_best", "plateau_num_bad", "plateau_scale"} <= set(meta),
          f"ckpt_steps.json lacks the plateau: {meta}")
    opt = last["optimizer"]
    updates = CLI_ITERS // 2
    check(opt["count"] == updates and opt["mini_step"] == CLI_ITERS % 2,
          f"{opt['count']} updates, mini-step {opt['mini_step']} after "
          f"{CLI_ITERS} micro-batches")
    traces = list(Path(prof).glob("*.json"))
    check(len(traces) == 1, f"profile_dir holds {traces}")
    # after the profiled window (or all steps of an epoch no longer than
    # it): micro-batches that accumulate (odd) and that apply the update
    w = cli.PROFILE_STEPS if len(steps.times) > cli.PROFILE_STEPS + 1 else 0
    acc_ms = [t * 1e3 for i, t in enumerate(steps.times[w:], w + 1) if i % 2]
    upd_ms = [t * 1e3 for i, t in enumerate(steps.times[w:], w + 1) if not i % 2]
    window = sum(steps.times[:cli.PROFILE_STEPS])
    print(f"extras keys: 1 epoch {wall:.1f} s; steps {w + 1}-{CLI_ITERS} (step "
          f"ends synchronised): {statistics.median(acc_ms):.1f} ms a "
          f"micro-batch that accumulates, {statistics.median(upd_ms):.1f} ms "
          f"one that applies the update, so {statistics.median(acc_ms) + statistics.median(upd_ms):.1f} "
          f"ms an update ({updates} for {CLI_ITERS} micro-batches); the "
          f"{cli.PROFILE_STEPS} profiled steps {window:.2f} s, writing the trace "
          f"{stops.times[0]:.2f} s ({traces[0].stat().st_size / 2**20:.1f} MB); "
          f"kl {m['kl']:.4f} kl_raw {m['kl_raw']:.4f}, kl_weight "
          f"{m['kl_weight']}, plateau {meta['plateau_scale']} ({SMI})")
    return CLI_ITERS


# (e): the optimizer chains whose state takes optimizer_args' dtype, and
# the state tensor each keeps in it
STATE_DTYPE_CHAINS = (
    ("Adam", {"lr": 5e-4, "mu_dtype": "bfloat16"}, "mu"),
    ("SGD", {"lr": 5e-4, "momentum": 0.9, "accumulator_dtype": "bfloat16"},
     "trace"))
STATE_STEPS = 3


def _state_bytes(opt, itemsize=None):
    """{state key: bytes} of an ``OptaxChain``'s state (each element
    ``itemsize`` bytes if given: the float32 chain's are 4)."""
    out = {}
    for st in opt.state:
        for k, v in st.items():
            out[k] = out.get(k, 0) + v.numel() * (itemsize or v.element_size())
    return out


def extras_state_dtypes():
    """(e) ``optimizer_args.mu_dtype`` (Adam) and ``accumulator_dtype``
    (SGD with momentum 0.9) at bfloat16: two small steps on the card
    against the CPU from the same weights and draws (both steps' metrics
    within rtol 1e-3, the stored moment's per-tensor relative error
    printed and within 1e-2); STATE_STEPS full-width flagship steps of
    each, the moment bfloat16 on the card, finite metrics and weights, its
    bytes beside a float32 chain's (the same elements at 4 bytes); the
    Cnn14 flagship's state bytes likewise.  Returns the card's steps taken
    with the time warp."""
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.train.trainer import Trainer

    warps = 0
    for name, args, key in STATE_DTYPE_CHAINS:
        conf, V, F, small, draws, noise = small_step_inputs()
        conf.update(optimizer=name, optimizer_args=args)
        pair = [Trainer(conf, V, F, device=d, total_iters=100)
                for d in ("cuda", "cpu")]
        pair[1].model.load_state_dict({k: v.cpu() for k, v in
                                       pair[0].model.state_dict().items()})
        metrics = []
        for step in (1, 2):
            for tr in pair:
                metrics.append({k: float(v) for k, v in tr.step(
                    small, step, 12, draws=draws, noise=noise).items()})
        warps += 2
        for (a, b) in zip(metrics[0::2], metrics[1::2]):
            for k in ("loss", "ce", "kl", "grad_norm"):
                check(math.isfinite(a[k]) and abs(a[k] - b[k])
                      <= 1e-3 * abs(b[k]) + 1e-6,
                      f"extras {name} {key} bf16: card and CPU disagree on "
                      f"{k}: {a[k]} vs {b[k]}")
        moments = [[st[key] for st in tr.optimizer.state] for tr in pair]
        check(all(t.dtype == torch.bfloat16 for ts in moments for t in ts),
              f"extras {name}: the {key} state is not bfloat16")
        rel = max(float((a.cpu().double() - b.double()).norm()
                        / max(float(b.double().norm()), 1e-30))
                  for a, b in zip(*moments))
        check(rel <= 1e-2, f"extras {name}: the card's {key} is {rel:.3g} "
                           f"off the CPU's")
        del pair
        # full width, the time warp on
        full = copy.deepcopy(FLAGSHIP_CONF)
        full.update(optimizer=name, optimizer_args=args)
        trainer = Trainer(full, VOCAB, DATA_DIM, device="cuda",
                          total_iters=ITERS_PER_EPOCH * EPOCHS)
        rng_full = np.random.default_rng(5)
        step_ms = []
        for i in range(STATE_STEPS):
            batch = make_batch(rng_full)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.step(batch, ITERS_PER_EPOCH * 11 + 1 + i, 12)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(all(math.isfinite(float(v)) for v in m.values()),
                  f"extras {name} bf16 {key}: non-finite metric at step {i + 1}")
        warps += STATE_STEPS
        check(all(st[key].dtype == torch.bfloat16 and st[key].is_cuda
                  for st in trainer.optimizer.state),
              f"extras {name}: the card's {key} state is not bfloat16")
        check(all(torch.isfinite(p).all() for p in trainer.model.parameters()),
              f"extras {name} bf16 {key}: non-finite parameters")
        got = _state_bytes(trainer.optimizer)
        ref_bytes = _state_bytes(trainer.optimizer, 4)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        del trainer
        torch.cuda.empty_cache()
        c14 = copy.deepcopy(cnn14_conf())
        c14.update(optimizer=name, optimizer_args=args)
        c14_opt = Trainer(c14, VOCAB, DATA_DIM, device="cuda",
                          total_iters=100).optimizer
        c14_bytes = _state_bytes(c14_opt)
        c14_ref = _state_bytes(c14_opt, 4)
        check(all(st[key].dtype == torch.bfloat16 for st in c14_opt.state),
              f"extras {name}: the Cnn14 flagship's {key} is not bfloat16")
        c14_params = sum(p.numel() for p in c14_opt.params)
        del c14_opt
        torch.cuda.empty_cache()
        print(f"extras state dtypes: {name} {args}: small step pair card vs "
              f"CPU: losses {metrics[0]['loss']:.6f}/{metrics[1]['loss']:.6f}, "
              f"{metrics[2]['loss']:.6f}/{metrics[3]['loss']:.6f}, the stored "
              f"{key} rel {rel:.3g}; the flagship ({n_params} params) "
              f"{STATE_STEPS} steps ms {', '.join(f'{t:.1f}' for t in step_ms)}, "
              f"{key} {got[key] / 1e6:.2f} MB bf16 against "
              f"{ref_bytes[key] / 1e6:.2f} MB float32 (state {sum(got.values()) / 1e6:.2f} "
              f"against {sum(ref_bytes.values()) / 1e6:.2f} MB); the Cnn14 "
              f"flagship ({c14_params} params) {key} "
              f"{c14_bytes[key] / 1e6:.2f} MB against "
              f"{c14_ref[key] / 1e6:.2f} MB, state "
              f"{sum(c14_bytes.values()) / 1e6:.2f} against "
              f"{sum(c14_ref.values()) / 1e6:.2f} MB ({SMI})")
    return warps


def extras_scst(cli, exp):
    """(c) ``scst`` of phase 10's experiment for an epoch at sample_n 1;
    SCST_N_ITERS N-SCST iterations at SCST_SAMPLE_N; the replay's
    log-probs against the rollout's on one batch."""
    from acvae_tpu_torch import END_IDX
    from acvae_tpu_torch.train import scst as scst_mod
    from acvae_tpu_torch.train.checkpoints import load_experiment
    from acvae_tpu_torch.train.trainer import build_optimizer

    torch.cuda.reset_peak_memory_stats()
    parts = {n: _Timed(scst_mod, n) for n in ("scst_train_step", "scst_reward")}
    made = []
    real_make = scst_mod.make_rollout

    def make_rollout(*a, **k):
        made.append(_Timed(types.SimpleNamespace(r=real_make(*a, **k)), "r"))
        return made[-1].owner.r
    scst_mod.make_rollout = make_rollout
    try:
        t0 = time.perf_counter()
        out = cli.main(["scst", str(exp), "--epochs=1", "--sample_n=1"])
        wall = time.perf_counter() - t0
    finally:
        scst_mod.make_rollout = real_make
        for t in parts.values():
            t.restore()
    it_s, cider_s = parts["scst_train_step"].times, parts["scst_reward"].times
    roll_s = made[0].times
    check(len(it_s) == CLI_ITERS and (Path(out) / "last.pt").exists()
          and (Path(out) / "scst.log").exists(),
          f"scst: {len(it_s)} iterations, files {os.listdir(out)}")
    rest = [a - b - c for a, b, c in zip(it_s, roll_s, cider_s)]
    print(f"extras scst n1: {len(it_s)} iterations, {sum(it_s):.2f} s = "
          f"{len(it_s) / sum(it_s):.2f} iterations/s; an iteration "
          f"{_ms(it_s)}: rollout {_ms(roll_s)}, host CIDEr {_ms(cider_s)}, "
          f"replay + update {_ms(rest)}; command {wall:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({SMI})")

    conf, vocab, model = load_experiment(str(exp), "best", device="cuda")
    ds, _, loader, _ = cli._build_dataloaders(cli.Config(conf), vocab)
    refs = loader.refs()
    opt = build_optimizer(dict(conf, optimizer_args={"lr": 5e-5},
                               scheduler="constant", scheduler_args={}),
                          model.named_parameters(), 1)
    gen = torch.Generator("cuda").manual_seed(1)
    batches = [cli._to_device(b, torch.device("cuda"))
               for _, b in zip(range(SCST_N_ITERS), loader)]
    b = batches[0]
    rollout = scst_mod.make_rollout(model, sample_n=1, max_length=MAX_LEN)
    ro = rollout(b.feats, b.feat_lens, gen)
    rep = model.forced_decode(b.feats, b.feat_lens, ro["sampled_seqs"],
                              eps=ro["eps"], grad=True)["sampled_logprobs"]
    seqs = ro["sampled_seqs"]
    mask = torch.cat([torch.ones_like(seqs[:, :1], dtype=torch.bool),
                      seqs[:, :-1] != END_IDX], dim=1)
    err = float((rep.detach() - ro["sampled_logprobs"]).abs()[mask].max())
    print(f"extras scst replay: max |dlogprob| {err:.2e} over {int(mask.sum())} "
          f"scored positions of a batch of {seqs.shape[0]} (atol {REPLAY_ATOL})")
    check(err <= REPLAY_ATOL, f"the SCST replay's log-probs differ by {err:.2e}")
    torch.cuda.reset_peak_memory_stats()
    rollout = scst_mod.make_rollout(model, sample_n=SCST_SAMPLE_N,
                                    max_length=MAX_LEN)
    times = []
    for b in batches:
        t0 = time.perf_counter()
        m = scst_mod.scst_train_step(model, opt, rollout, b.feats, b.feat_lens,
                                     b.audio_ids, refs, vocab, gen,
                                     sample_n=SCST_SAMPLE_N)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(math.isfinite(m["loss"]), f"N-SCST metrics {m}")
    print(f"extras scst n{SCST_SAMPLE_N}: {len(times)} iterations of "
          f"{b.feats.shape[0]}x{SCST_SAMPLE_N} rollouts, {_ms(times)} each "
          f"(the first with its warm-up); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({SMI})")


def extras_average(cli, tmp, exp):
    """(d) ``average_checkpoints best,last``, ``evaluate --checkpoint=avg``
    in bf16 and with the int8 encoder, and ``diagnose``."""
    path = cli.main(["average_checkpoints", str(exp), "--names=best,last"])
    check(Path(path) == exp / "avg.pt", f"average_checkpoints wrote {path}")
    for tag, extra in (("bf16", []), ("int8", ["--encoder_int8=true"])):
        before = read_counts()
        t0 = time.perf_counter()
        scores = cli.main(["evaluate", str(exp), "--checkpoint=avg",
                           f"--eval_caption_file={tmp}/text.json",
                           f"--tag=avg_{tag}"] + extra)
        wall = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in read_counts().items()}
        want = (per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES) if extra
                else (0, 0, 0))
        check(int8_launches(got) == want
              and all(math.isfinite(scores[k]) for k in SCORE_KEYS),
              f"evaluate avg {tag}: launches {got} (expected {want}), {scores}")
        print(f"extras evaluate --checkpoint=avg {tag}: {wall:.2f} s, CIDEr "
              f"{scores['CIDEr']:.4f}, launches {got} ({SMI})")
    t0 = time.perf_counter()
    res = cli.main(["diagnose", str(exp)])
    secs = time.perf_counter() - t0
    keys = {"exp", "checkpoint", "n_batches", "forward_mode", "ce_posterior_z",
            "ce_prior_z", "ce_prior_penalty", "kl_total", "active_units_0.01",
            "active_units_0.1", "latent_dims", "kl_dim_top8", "qp_mse",
            "q_mean_var"}
    check(set(res) == keys and res["n_batches"] == 6 and res["latent_dims"] == 512,
          f"diagnose: {res}")
    print(f"extras diagnose: {secs:.2f} s for 6 batches of 32; ce posterior "
          f"{res['ce_posterior_z']} prior {res['ce_prior_z']}, kl "
          f"{res['kl_total']}, active units {res['active_units_0.01']} "
          f"({SMI})")


# phase 14: every registered encoder at tests/test_encoders.py's widths
# (Cnn14, ResNet38 and CNN10Encoder have fixed widths), then the flagship
# recipe with PANN Cnn14 (``--encodermodel=Cnn14
# --encoder_args.embed_size=2048``, bf16) at full width
ENC_SMALL = [
    ("Cnn10", {"embed_size": 16, "channels": [4, 8, 8, 16]}),
    ("Cnn14", {"embed_size": 2048}), ("ResNet38", {}),
    ("CRNNEncoder", {"embed_size": 256}),
    ("CNN10QEncoder", {"embed_size": 16, "channels": [4, 8, 8, 16]}),
    ("CNN10DEncoder", {"embed_size": 24, "channels": [4, 8, 8, 16]}),
    ("CRNN8_Sub4", {"embed_size": 16, "channels": [4, 8, 8, 16]}),
    ("RNNEncoder", {"embed_size": 12, "hidden_size": 8}),
    ("TransformerEncoder", {"embed_size": 16, "nhead": 2, "nlayers": 1}),
    ("CNN10Encoder", {"embed_size": 512}),
    ("E2EASREncoder", {"embed_size": 24, "hidden_size": 16, "nlayers": 1}),
    ("M2TransformerEncoder", {"embed_size": 16, "nhead": 2, "nlayers": 1,
                              "dim_feedforward": 32, "memory_slots": 5}),
    ("ResNetEncoder", {"embed_size": 16, "channels": [4, 8, 8, 16]}),
    ("CNNEncoder", {"embed_size": 16}),
    ("PreTrainedCNN", {"trunk": {"name": "CNN10Encoder"}, "embed_size": 8}),
    ("CNN10CRNNEncoder", {
        "crnn": {"name": "CRNN8_Sub4", "embed_size": 16, "channels": [4, 8, 8, 16]},
        "cnn": {"name": "CNN10QEncoder", "embed_size": 16,
                "channels": [4, 8, 8, 16]}})]
# card against CPU in float32 (TF32 off): cuDNN's and the CPU's sums run in
# other orders, and a train-mode BatchNorm over a few values per channel
# magnifies that; |card - cpu| <= ENC_TOL * (1 + |cpu|)
ENC_TOL = 1e-3
ENC_STEPS = 6
# Cnn14's int8 launches a batch: the stem, 11 body convs, 5 int8 pools
CNN14_PER_BATCH = (1, 11, 5)


def cnn14_conf():
    """The flagship recipe with the PANN Cnn14 encoder (bf16), the time
    warp on."""
    from acvae_tpu_torch.configs import flagship_conf
    conf = flagship_conf(encodermodel="Cnn14", data_dim=DATA_DIM)
    conf["encoder_args"] = dict(conf["encoder_args"], embed_size=2048)
    return conf


def encoders_parity():
    """(a) Every registered encoder on the card against the CPU, same
    weights, eval and train mode (dropout off on both sides), lengths
    exact, running statistics after the train-mode forward."""
    from acvae_tpu_torch.models.encoders import ENCODERS, build_encoder

    check(sorted(ENCODERS) == sorted(n for n, _ in ENC_SMALL),
          f"phase 14 covers {sorted(n for n, _ in ENC_SMALL)}, the port "
          f"registers {sorted(ENCODERS)}")
    rng = np.random.default_rng(51)
    feats = torch.tensor(rng.normal(size=(2, 64, DATA_DIM)).astype(np.float32))
    lens = torch.tensor([64, 32])
    fn = torch.nn.functional
    real_dropout = fn.dropout
    fn.dropout = lambda x, p=0.5, training=True, inplace=False: x
    try:
        for name, args in ENC_SMALL:
            torch.manual_seed(51)
            cpu = build_encoder(name, args, DATA_DIM, device="cpu")
            gpu = build_encoder(name, args, DATA_DIM, device="cuda")
            gpu.load_state_dict(cpu.state_dict())
            errs = []
            for train in (False, True):
                with torch.no_grad():
                    a = gpu(feats.cuda(), lens.cuda(), train=train)
                    b = cpu(feats, lens, train=train)
                for k in ("audio_embeds", "audio_embeds_pooled"):
                    ref = b[k].float()
                    d = (a[k].float().cpu() - ref).abs()
                    errs.append(d.max().item())
                    check(a[k].shape == b[k].shape and bool(
                        (d <= ENC_TOL * (1 + ref.abs())).all()),
                          f"encoders {name} {k} train={train}: card vs CPU "
                          f"max |d| {errs[-1]}")
                check(torch.equal(a["audio_embeds_lens"].cpu(),
                                  b["audio_embeds_lens"]), f"encoders {name} lens")
            sa, sb = gpu.state_dict(), cpu.state_dict()
            stats = max([(sa[k].cpu() - v).abs().max().item() for k, v in sb.items()
                         if "running" in k] or [0.0])
            check(stats <= ENC_TOL * (1 + max([v.abs().max().item() for k, v in
                                               sb.items() if "running" in k] or [0])),
                  f"encoders {name}: running statistics differ by {stats}")
            print(f"encoders parity {name}: max |card - cpu| eval "
                  f"{max(errs[:2]):.2e}, train {max(errs[2:]):.2e}, running "
                  f"stats {stats:.2e}")
            del cpu, gpu
    finally:
        fn.dropout = real_dropout
    torch.cuda.empty_cache()


def cnn14_train(conf):
    """(b) ENC_STEPS Trainer steps of the Cnn14 flagship at batch 32, T_mel
    1024 ragged, the time warp on; returns the launches."""
    from acvae_tpu_torch.train.trainer import Trainer

    torch.manual_seed(7)
    trainer = Trainer(conf, VOCAB, DATA_DIM, device="cuda",
                      total_iters=ITERS_PER_EPOCH * EPOCHS)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    n_enc = sum(p.numel() for p in trainer.model.encoder.parameters())
    rng = np.random.default_rng(1)
    epoch = 12
    it0 = ITERS_PER_EPOCH * (epoch - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i in range(ENC_STEPS):
        batch = make_batch(rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch, it0 + 1 + i, epoch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"encoders Cnn14 train: non-finite metric at step {i + 1}: {vals}")
    counts = read_counts()
    check(counts == {"time_warp_1d": ENC_STEPS, "stem_conv3x3_i8": 0,
                     "conv3x3_i8": 0, "avgpool2x2_i8": 0, "bn_relu": 0,
                     "topk_rows": 0},
          f"encoders Cnn14 train: launches {counts} in {ENC_STEPS} steps")
    check(all(torch.isfinite(p).all() for p in trainer.model.parameters()),
          "encoders Cnn14 train: non-finite parameters after the steps")
    print(f"encoders Cnn14 train: {n_params} params ({n_enc} in the encoder), "
          f"batch {BATCH}, T_mel {T_MEL}, L {CAP_LEN}, bf16 encoder: step ms "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}; median of steps "
          f"2-{ENC_STEPS} {statistics.median(step_ms[1:]):.1f}; loss "
          f"{vals['loss']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{counts} ({SMI})")
    del trainer
    torch.cuda.empty_cache()
    return counts


def cnn14_serve(conf):
    """(c) The Cnn14 flagship through save_experiment/load_experiment: the
    beam-3 decode at batch 512 with the bf16 encoder, then with the v2sym
    int8 encoder calibrated from bn0's statistics (its codes card vs CPU on
    2 clips first), then CaptionService(encoder_int8=True) over HTTP.
    Returns the launches."""
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)
    from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment

    total = dict.fromkeys(kernel_fns(), 0)
    torch.manual_seed(9)
    with tempfile.TemporaryDirectory() as exp:
        save_experiment(exp, build_model(conf, VOCAB, DATA_DIM, device="cuda"),
                        conf, flagship_vocab())
        _, vocab, model = load_experiment(exp, device="cuda")
        counts, _, _ = decode_rate(
            "encoders Cnn14 bf16 decode",
            lambda f, l, g: model.inference_forward(f, l, generator=g, **BEAM_KW),
            model.encode, model, vocab)
        want = dict.fromkeys(counts, 0)
        want["bn_relu"] = CNN14_BN_RELU_PER_BATCH * (1 + DEC_TIMED)
        want["topk_rows"] = topk_per_search(BEAM_KW) * (1 + DEC_TIMED)
        check(counts == want, f"the bf16 decode launched {counts} in "
                              f"{1 + DEC_TIMED} batches (expected {want})")
        t0 = time.perf_counter()
        quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        q_cpu = copy.deepcopy(quant).to("cpu")
        rng = np.random.default_rng(43)
        x = torch.tensor(rng.normal(size=(2, 128, DATA_DIM)).astype(np.float32))
        xl = torch.tensor([128, 100])
        codes_gpu, codes_cpu = [], []
        with torch.inference_mode():
            quant(x.cuda(), xl.cuda(), codes=codes_gpu)
            q_cpu(x, xl, codes=codes_cpu)
        del q_cpu
        flipped = [int((a.cpu() != b).sum()) for a, b in zip(codes_gpu, codes_cpu)]
        check(len(flipped) == 12 and sum(flipped) == 0,
              f"encoders Cnn14 int8: codes card vs CPU differ {flipped}")
        print(f"encoders Cnn14 int8: v2sym calibrated from bn0's statistics in "
              f"{calib_s:.2f} s; codes at the 12 quantize points card vs CPU "
              f"(2 clips, T 128) differ at {flipped}")
        int8 = int8_decode_fn(model, quant, **BEAM_KW)
        counts, feats, lens = decode_rate(
            "encoders Cnn14 int8 decode",
            lambda f, l, g: int8(f, l, generator=g),
            lambda f, l: model.apply_ln(quant(f, l)), model, vocab)
        batches = 1 + DEC_TIMED
        check(int8_launches(counts) == per_batches(CNN14_PER_BATCH, batches)
              and counts["time_warp_1d"] == 0,
              f"encoders Cnn14 int8: launches {counts} in {batches} batches "
              f"(expected {CNN14_PER_BATCH} a batch)")
        for k, v in counts.items():
            total[k] += v
        with torch.inference_mode():
            a = quant(feats, lens)["audio_embeds"].flatten()
            b = model.encode(feats, lens)["audio_embeds_raw"].float().flatten()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        print(f"encoders Cnn14 int8: audio_embeds cosine to the bf16 "
              f"encoder's {cos:.5f}; int8 / bf16 captions/s "
              f"{RATES['encoders Cnn14 int8 decode'] / RATES['encoders Cnn14 bf16 decode']:.3f} ({SMI})")
        check(cos > 0.9, f"the int8 Cnn14 strays from the bf16 one: cos {cos}")
        del model, quant, int8, feats
        torch.cuda.empty_cache()
        for k, v in http_checks(exp, "encoders Cnn14 int8 serve", CNN14_PER_BATCH,
                                encoder_int8=True).items():
            total[k] += v
    return total


def cnn14_cli(tmp):
    """(d) On phase 10's corpus: a seeded state dict in PANN's Cnn14 layout
    (its frontend and tagger head included) as ``--pretrained_encoder`` of
    ``train`` (1 epoch), ``evaluate --encoder_int8``, then ``evaluate`` on
    the .npz manifest and on the same features as a kaldi .scp/.ark table
    (the same captions).  Returns the launches."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.data.kaldi import write_mat_ark
    from acvae_tpu_torch.models.encoders import build_encoder

    torch.manual_seed(61)
    enc = build_encoder("Cnn14", {}, DATA_DIM)
    n_enc = len(list(enc.parameters()))
    pann = {k: v for k, v in enc.state_dict().items() if k != "stem_pad_lanes"}
    pann.update({"fc_audioset.weight": torch.randn(527, 2048),
                 "fc_audioset.bias": torch.zeros(527),
                 "spectrogram_extractor.stft.conv_real.weight": torch.randn(257, 1, 512),
                 "logmel_extractor.melW": torch.randn(257, DATA_DIM),
                 "bn0.num_batches_tracked": torch.tensor(0)})
    pth = Path(tmp) / "Cnn14_16k_seeded.pth"
    torch.save({"model": pann}, pth)
    config = str(CONFIGS / "ac_vae.yaml")
    total = dict.fromkeys(kernel_fns(), 0)
    reset_counts()
    t0 = time.perf_counter()
    exp = Path(cli.main([
        "train", config, f"--h5_csv={tmp}/mels.csv",
        f"--caption_file={tmp}/text.json", f"--vocab_file={tmp}/vocab.pkl",
        f"--outputpath={tmp}/cnn14", "--epochs=1", "--encodermodel=Cnn14",
        "--encoder_args.embed_size=2048", f"--pretrained_encoder={pth}",
        "--augments=[timewarp,timemask,freqmask]"]))
    train_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["time_warp_1d"] == CLI_ITERS,
          f"encoders cli: time_warp_1d launched {counts['time_warp_1d']} times "
          f"in {CLI_ITERS} iterations")
    log_text = (exp / "train_caption.log").read_text()
    loaded = f"pretrained_encoder[params]: loaded {n_enc}/{n_enc} tensors"
    check(loaded in log_text and "pretrained_encoder[batch_stats]: loaded" in log_text,
          f"encoders cli: no {loaded!r} in the train log")
    m = json.loads((exp / "metrics.jsonl").read_text().splitlines()[-1])
    check(math.isfinite(m["train_loss"]), f"encoders cli: {m}")
    for k, v in counts.items():
        total[k] += v
    line = (f"encoders cli: train Cnn14 warm-started from a PANN-layout .pth "
            f"({loaded}), 1 epoch ({CLI_ITERS} iterations) {train_s:.1f} s, "
            f"epoch wall {m['epoch_wall_s']:.2f} s, loss {m['train_loss']:.4f}, "
            f"val CIDEr {m['val_cider']:.4f}")
    with np.load(Path(tmp) / "mels.npz") as z:
        write_mat_ark(f"{tmp}/mels.ark", {k: z[k] for k in z.files},
                      f"{tmp}/mels.scp")
    for tag, extra in (("int8", ["--encoder_int8"]), ("npz", ["--tag=npz"]),
                       ("scp", [f"--eval_h5_csv={tmp}/mels.scp", "--tag=scp"])):
        reset_counts()
        t0 = time.perf_counter()
        scores = cli.main(["evaluate", str(exp),
                           f"--eval_caption_file={tmp}/text.json"] + extra)
        wall = time.perf_counter() - t0
        got = read_counts()
        want = (per_batches(CNN14_PER_BATCH, CLI_EVAL_BATCHES) if tag == "int8"
                else (0, 0, 0))
        check(int8_launches(got) == want
              and got["time_warp_1d"] == 0,
              f"encoders cli evaluate {tag}: launches {got}, expected {want}")
        check(all(math.isfinite(scores[k]) for k in SCORE_KEYS),
              f"encoders cli evaluate {tag}: {scores}")
        for k, v in got.items():
            total[k] += v
        line += (f"; evaluate {tag} {wall:.2f} s ({CLI_AUDIOS / wall:.1f} clips/s "
                 f"with load and scoring), CIDEr {scores['CIDEr']:.4f}")
    caps = {t: json.loads((exp / f"eval_output_beam_3_{t}.json").read_text())
            for t in ("npz", "scp")}
    check(caps["npz"] == caps["scp"], "encoders cli: the .scp manifest's "
                                      "captions differ from the .npz one's")
    print(line + f"; .scp captions identical to .npz ({SMI})")
    return total


def encoders_phase(tmp):
    """Phase 14; returns the kernel launches of (b)-(d)."""
    encoders_parity()
    conf = cnn14_conf()
    total = dict.fromkeys(kernel_fns(), 0)
    for counts in (cnn14_train(conf), cnn14_serve(conf), cnn14_cli(tmp)):
        for k, v in counts.items():
            total[k] += v
    print(f"encoders: launches over the path {total} ({SMI})")
    return total


# phase 15: the auxiliary training stack.  configs/adverse.yaml's two stages
# and configs/sentence.yaml at their own widths (Cnn10 512 bf16, decoder
# 512, the discriminator's embed 256), the GE2E embedder at embed 512 and
# the global VAE at its defaults (batch 64, latent 512), on phase 10's corpus
AUX_STEPS = 6
AUX_TOL = 1e-4     # card vs CPU, float32 with TF32 off: |d| <= tol·(1 + |cpu|)


def aux_phase(tmp, profile_dir=None):
    """Phase 15; returns the kernel launches of (b)-(d)."""
    aux_parity()
    aux_step_parity(tmp)
    torch.cuda.empty_cache()
    total = dict.fromkeys(kernel_fns(), 0)
    for counts in (aux_adverse(tmp, profile_dir), aux_sentence(tmp),
                   aux_rest(tmp)):
        for k, v in counts.items():
            total[k] += v
    print(f"aux: launches over the path {total} ({SMI})")
    return total


def _aux_close(errs, name, card, cpu):
    a, b = card.detach().float().cpu(), cpu.detach().float()
    check(a.shape == b.shape, f"aux parity {name}: shapes {a.shape} {b.shape}")
    d = (a - b).abs()
    errs[name] = max(errs.get(name, 0.0), d.max().item())
    check(bool((d <= AUX_TOL * (1 + b.abs())).all()),
          f"aux parity {name}: card vs CPU max |d| {d.max().item()}")


def aux_parity():
    """(a) The new modules on the card against the CPU, same weights and
    noise: the discriminator's aud2cap and cap2cap (id and soft captions),
    the GE2E loss and get_cossim, the global VAE's train forward, the
    sentence head, adverse_loss (with the logits' gradient) and
    augment_loss."""
    from acvae_tpu_torch.core.config import load_config
    from acvae_tpu_torch.losses import wrappers as tw
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.discriminator import DiscriminatorModel
    from acvae_tpu_torch.models.global_vae import GlobalSentenceVAE
    from acvae_tpu_torch.models.stage1 import GE2ELoss, get_centroids, get_cossim

    rng = np.random.default_rng(61)
    V, N, T, E = 40, 4, 9, 16
    errs = {}
    cpu_t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    gpu = lambda t: t.cuda()                          # noqa: E731
    torch.manual_seed(61)
    dm = DiscriminatorModel(V, audio_dim=E, word_dim=16, hidden_size=8,
                            embed_size=12, device="cpu")
    dg = copy.deepcopy(dm).cuda()
    audio = cpu_t(rng.normal(size=(N, 7, E)).astype(np.float32))
    alens, lens = torch.tensor([7, 5, 3, 1]), torch.tensor([9, 6, 4, 2])
    ids = torch.tensor(rng.integers(0, V, size=(N, T)))
    logits = cpu_t(rng.normal(size=(N, T, V)).astype(np.float32))
    for name, caps in (("ids", ids), ("soft", torch.softmax(logits, -1))):
        b = {"audio_feats": audio, "feats_lens": alens, "caps": caps,
             "lens": lens}
        _aux_close(errs, f"aud2cap {name}",
                   dg({k: gpu(v) for k, v in b.items()}), dm(b))
        other = (caps.flip(0), lens.flip(0))
        _aux_close(errs, f"cap2cap {name}",
                   dg.cap2cap(gpu(caps), gpu(lens), *map(gpu, other)),
                   dm.cap2cap(caps, lens, *other))
    emb = cpu_t(rng.normal(size=(4, 5, E)).astype(np.float32))
    ge2e = GE2ELoss(device="cpu")
    _aux_close(errs, "ge2e", copy.deepcopy(ge2e).cuda()(gpu(emb)), ge2e(emb))
    cent = get_centroids(emb)
    _aux_close(errs, "get_cossim", get_cossim(gpu(emb), gpu(cent)),
               get_cossim(emb, cent))
    vae = GlobalSentenceVAE(V, word_dim=16, hidden_size=12, latent_size=8,
                            device="cpu")
    caps = ids.clone()
    caps[:, 0] = 1
    eps = cpu_t(rng.normal(size=(N, 8)).astype(np.float32))
    coins = torch.tensor(rng.uniform(size=(N, T - 1)) < 0.3)
    a = copy.deepcopy(vae).cuda()(gpu(caps), gpu(lens), eps=gpu(eps),
                                  coins=gpu(coins))
    b = vae(caps, lens, eps=eps, coins=coins)
    for k in ("logits", "mu", "logvar", "z"):
        _aux_close(errs, f"global_vae {k}", a[k], b[k])
    conf = load_config(str(CONFIGS / "sentence.yaml"))
    conf.update(encoder_args={"embed_size": E, "channels": [4, 8, 8, 16],
                              "conv_dropout": 0.0, "head_dropout": 0.0},
                decoder_args={"embed_size": E, "hidden_size": E, "dropout": 0.0},
                model_args={"seq_output_size": 12})
    head = build_model(conf, V, DATA_DIM, device="cpu")
    feats = cpu_t(rng.normal(size=(N, 64, DATA_DIM)).astype(np.float32))
    flens = torch.tensor([64, 48, 40, 33])
    noise = {"ss_coins": torch.ones(T - 1, dtype=torch.bool)}
    a = copy.deepcopy(head).cuda().train_forward(
        gpu(feats), gpu(flens), gpu(caps), gpu(lens), noise=noise)
    b = head.train_forward(feats, flens, caps, lens, noise=noise)
    _aux_close(errs, "sentence head", a["seq_outputs"], b["seq_outputs"])
    tg = torch.tensor(rng.integers(0, V, size=(N, T)))
    qm, ql, pm, pl = (cpu_t(rng.normal(size=(N, T, 4)).astype(np.float32))
                      for _ in range(4))
    g = cpu_t(rng.gumbel(size=(N, T, V)).astype(np.float32))
    mask = torch.arange(T)[None] < (lens - 1)[:, None]
    grads = []
    for dev, d in (("cuda", dg), ("cpu", dm)):
        x = logits.to(dev).requires_grad_(True)
        out = tw.adverse_loss(x, tg.to(dev), qm.to(dev), ql.to(dev), pm.to(dev),
                              pl.to(dev), x, torch.ones(N, device=dev),
                              lens.to(dev), d, 0.5, 0.8, "gumbel", mask.to(dev),
                              audio.to(dev), alens.to(dev), gumbel=g.to(dev))
        out[0].backward()
        grads.append((out, x.grad))
    for i, name in enumerate(("loss", "ce", "kl", "dscrm")):
        _aux_close(errs, f"adverse_loss {name}", grads[0][0][i], grads[1][0][i])
    _aux_close(errs, "adverse_loss logits grad", grads[0][1], grads[1][1])
    keep = torch.tensor([1.0, 0.0, 1.0, 1.0])
    _aux_close(errs, "augment_loss",
               tw.augment_loss(gpu(logits), gpu(tg), gpu(lens), gpu(keep), 0.1),
               tw.augment_loss(logits, tg, lens, keep, 0.1))
    print("aux parity: max |card - cpu| " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in errs.items()}))


def aux_step_parity(tmp):
    """(a') One small ``Trainer.step`` on the card and one on the CPU from
    the same weights, batch and noise, for each recipe term of the training
    path: ``adverse_loss`` (a seeded discriminator experiment read back by
    ``load_discriminator``, gumbel samples from ``noise["adv_gumbel"]``),
    ``embedding_loss: Cosine`` (``cap_embeds``) and a ``keep_mask`` batch.
    SGD at a constant lr 0.1, so each update is lr times the clipped
    gradient and the parameters after the step hold the gradients' parity.
    Metrics within phase 5's rtol 1e-3; every gradient and parameter within
    AUX_TOL·(1 + |cpu|)."""
    from acvae_tpu_torch.models.discriminator import DiscriminatorRNNModel
    from acvae_tpu_torch.train.checkpoints import save_experiment
    from acvae_tpu_torch.train.trainer import Trainer

    V, N, T, F, L, E = 25, 3, 64, 16, 8, 16
    rng = np.random.default_rng(62)
    torch.manual_seed(62)
    wrapper = torch.nn.Module()
    args = {"word_dim": 16, "hidden_size": 8, "embed_size": 12}
    wrapper.dscrm = DiscriminatorRNNModel(V, audio_dim=E, **args)
    dsc = Path(tmp) / "dscrm_small"
    save_experiment(str(dsc), wrapper, {"discriminator_audio_dim": E,
                                        "discriminator_args": args}, None)
    batch = {"feats": rng.normal(size=(N, T, F)).astype(np.float32),
             "feat_lens": np.array([64, 48, 33], np.int32),
             "caps": rng.integers(3, V, size=(N, L)).astype(np.int32),
             "cap_lens": np.array([8, 5, 3], np.int32)}
    g = torch.Generator().manual_seed(2)
    noise = {"q_eps": torch.randn((N, L - 1, E), generator=g),
             "p_eps": torch.randn((L - 1, N, E), generator=g),
             "ss_coins": torch.ones(L - 1, dtype=torch.bool),
             "dis_coins": torch.rand(L - 1, generator=g) < 0.5,
             "adv_gumbel": torch.tensor(rng.gumbel(size=(N, L - 1, V)),
                                        dtype=torch.float32)}
    cases = {
        "adverse": ({"adverse_loss": {"discriminator": str(dsc), "alpha": 1.0,
                                      "sample_method": "gumbel"}}, {}, "adverse"),
        "embedding": ({"embedding_loss": "Cosine", "dec_par": 0.5},
                      {"cap_embeds": rng.normal(size=(N, E)).astype(np.float32)},
                      "embed"),
        "keep_mask": ({}, {"keep_mask": np.array([1.0, 0.0, 1.0], np.float32)},
                      "ce")}
    errs = {}
    for case, (over, more, term) in cases.items():
        conf = small_conf()
        conf.update(augments=[], optimizer="SGD", optimizer_args={"lr": 0.1},
                    scheduler="constant", scheduler_args={}, **over)
        gpu = Trainer(conf, V, F, device="cuda", total_iters=100)
        cpu = Trainer(conf, V, F, device="cpu", total_iters=100)
        cpu.model.load_state_dict({k: v.cpu() for k, v in
                                   gpu.model.state_dict().items()})
        b = dict(batch, **more)
        m_gpu = gpu.step(b, 1, 12, noise=noise)
        m_cpu = cpu.step(b, 1, 12, noise=noise)
        check(term in m_cpu, f"aux step {case}: no {term!r} metric in {sorted(m_cpu)}")
        vals = {}
        for k in m_cpu:
            a, c = float(m_gpu[k]), float(m_cpu[k])
            vals[k] = (round(a, 6), round(c, 6))
            check(math.isfinite(a) and abs(a - c) <= 1e-3 * abs(c) + 1e-6,
                  f"aux step {case}: card and CPU disagree on {k}: {a} vs {c}")
        for (name, pg), pc in zip(gpu.model.named_parameters(),
                                  cpu.model.parameters()):
            check((pg.grad is None) == (pc.grad is None),
                  f"aux step {case}: {name} has a gradient on one side only")
            if pc.grad is not None:
                _aux_close(errs, f"{case} grads", pg.grad, pc.grad)
            _aux_close(errs, f"{case} params", pg, pc)
        print(f"aux step parity {case}: card, cpu {json.dumps(vals)}")
    print("aux step parity: max |card - cpu| " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in errs.items()}))


def _aux_steps(tag, conf, extra=None, profile_dir=None):
    """AUX_STEPS Trainer steps of ``conf`` at batch 32, T_mel 1024, L 22,
    vocab 4981 (phase 5's batches; ``extra`` adds arrays to each); prints
    the median ms of steps 2-6 beside phase 5's; with ``profile_dir``,
    traces two more (``profile_steps``)."""
    from acvae_tpu_torch.train.trainer import Trainer

    torch.manual_seed(7)
    trainer = Trainer(conf, VOCAB, DATA_DIM, device="cuda",
                      total_iters=ITERS_PER_EPOCH * EPOCHS)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    rng = np.random.default_rng(1)
    epoch = 12
    it0 = ITERS_PER_EPOCH * (epoch - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(AUX_STEPS):
        batch = make_batch(rng)
        if extra is not None:
            batch.update(extra(rng))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch, it0 + 1 + i, epoch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"aux {tag} step {i + 1}: non-finite metric {vals}")
    check(all(torch.isfinite(p).all() for p in trainer.model.parameters()),
          f"aux {tag}: non-finite parameters after the steps")
    med = statistics.median(step_ms[1:])
    STEP_MS[tag] = med
    term = {k: round(vals[k], 4) for k in ("adverse", "embed") if k in vals}
    print(f"aux {tag} train: {n_params} params, batch {BATCH}, T_mel {T_MEL}, "
          f"L {CAP_LEN}, vocab {VOCAB}: step ms "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}; median of steps "
          f"2-{AUX_STEPS} {med:.1f} against phase 5's flagship step "
          f"{STEP_MS.get('flagship', float('nan')):.1f}; loss "
          f"{vals['loss']:.4f} {term}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({SMI})")
    if profile_dir:
        profile_steps(trainer, rng, it0 + AUX_STEPS, epoch, step_ms,
                      profile_dir, tag=f"{tag}_step", extra=extra)
    del trainer
    torch.cuda.empty_cache()


def _cli_args(tmp, out):
    return [f"--h5_csv={tmp}/mels.csv", f"--caption_file={tmp}/text.json",
            f"--vocab_file={tmp}/vocab.pkl", f"--outputpath={tmp}/{out}"]


def _epoch_line(exp):
    m = json.loads((Path(exp) / "metrics.jsonl").read_text().splitlines()[-1])
    check(math.isfinite(m["train_loss"]), f"aux: {exp}: {m}")
    return (f"epoch wall {m['epoch_wall_s']:.2f} s, loss {m['train_loss']:.4f}, "
            f"val CIDEr {m['val_cider']:.4f}")


def aux_adverse(tmp, profile_dir=None):
    """(b) configs/adverse.yaml: ``train_discriminator --mode=aud2cap`` (1
    epoch), AUX_STEPS timed train steps with ``adverse_loss`` (a seeded
    discriminator at vocab 4981, gumbel samples) and AUX_STEPS of the
    same recipe without the term (both traced with ``profile_dir``), 1 CLI
    epoch of stage 2
    with the trained discriminator, ``evaluate --encoder_int8`` of it (8
    ``conv3x3_i8`` + 3 ``avgpool2x2_i8`` a batch).  Returns the launches."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.core.config import load_config
    from acvae_tpu_torch.models.discriminator import DiscriminatorRNNModel
    from acvae_tpu_torch.train.checkpoints import save_experiment

    config = str(CONFIGS / "adverse.yaml")
    reset_counts()
    t0 = time.perf_counter()
    dsc = Path(cli.main(["train_discriminator", config, "--mode=aud2cap",
                         "--epochs=1"] + _cli_args(tmp, "dscrm")))
    dsc_s = time.perf_counter() - t0
    rows = [line.split("] - ", 1)[-1] for line in
            (dsc / "train_dscrm.log").read_text().splitlines()][-1:]
    check((dsc / "best.pt").exists() and (dsc / "last.pt").exists(),
          f"aux: train_discriminator wrote {sorted(os.listdir(dsc))}")
    print(f"aux train_discriminator aud2cap: 1 epoch ({CLI_ITERS} iterations, "
          f"Cnn10 512 bf16 + discriminator embed 256) {dsc_s:.1f} s; "
          f"epoch/train loss/acc/val loss {rows} ({SMI})")
    torch.manual_seed(3)
    wrapper = torch.nn.Module()
    args = {"embed_size": 256}
    wrapper.dscrm = DiscriminatorRNNModel(VOCAB, audio_dim=512, **args)
    seeded = Path(tmp) / "dscrm_4981"
    save_experiment(str(seeded), wrapper, {"discriminator_audio_dim": 512,
                                           "discriminator_args": args}, None)
    conf = json.loads(json.dumps(load_config(config)))
    conf.update(data_dim=DATA_DIM, adverse_loss=dict(
        conf["adverse_loss"], discriminator=str(seeded)))
    _aux_steps("adverse", conf, profile_dir=profile_dir)
    # the same recipe, batches and draws without the term: the term's cost
    off = {k: v for k, v in conf.items() if k != "adverse_loss"}
    _aux_steps("adverse_off", off, profile_dir=profile_dir)
    t0 = time.perf_counter()
    exp = Path(cli.main(["train", config, "--epochs=1",
                         f"--adverse_loss.discriminator={dsc}"]
                        + _cli_args(tmp, "adverse")))
    train_s = time.perf_counter() - t0
    check("adverse_loss: discriminator from" in
          (exp / "train_caption.log").read_text(), "aux: no adverse_loss line")
    line = (f"aux adverse CLI: train 1 epoch {train_s:.1f} s, {_epoch_line(exp)}")
    before = read_counts()
    t0 = time.perf_counter()
    scores = cli.main(["evaluate", str(exp), "--encoder_int8"])
    wall = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in read_counts().items()}
    want = per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES)
    check(int8_launches(got) == want,
          f"aux evaluate --encoder_int8: launches {got}, expected {want}")
    check(all(math.isfinite(scores[k]) for k in SCORE_KEYS),
          f"aux evaluate --encoder_int8: {scores}")
    print(line + f"; evaluate --encoder_int8 {wall:.2f} s ({CLI_AUDIOS / wall:.1f} "
          f"clips/s with load and scoring), CIDEr {scores['CIDEr']:.4f}, "
          f"launches {got} ({SMI})")
    return read_counts()


def aux_sentence(tmp):
    """(c) configs/sentence.yaml: ``stage1`` (2 epochs, embed 512),
    ``stage1_test`` (the EER), ``extract_embedding`` (the 512-dim tree),
    AUX_STEPS timed Seq2SeqAttnModel steps with ``embedding_loss: Cosine``,
    1 CLI epoch with ``embedding_path``, then ``evaluate``."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.core.config import load_config

    text, vocab = f"{tmp}/text.json", f"{tmp}/vocab.pkl"
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["stage1", text, vocab, f"--output_dir={tmp}/stage1", "--epochs=2",
              "--embed_size=512"])
    s1_s = time.perf_counter() - t0
    losses = re.findall(r"GE2E loss ([-\d.]+)",
                        (Path(tmp) / "stage1" / "stage1.log").read_text())
    check(len(losses) == 2 and all(math.isfinite(float(v)) for v in losses),
          f"aux stage1: losses {losses}")
    t0 = time.perf_counter()
    eer = cli.main(["stage1_test", f"{tmp}/stage1", text, vocab,
                    "--embed_size=512"])
    test_s = time.perf_counter() - t0
    check(0.0 <= eer <= 1.0, f"aux stage1_test: EER {eer}")
    t0 = time.perf_counter()
    cli.main(["extract_embedding", f"{tmp}/stage1", text, vocab, f"{tmp}/emb",
              "--embed_size=512"])
    ext_s = time.perf_counter() - t0
    files = list((Path(tmp) / "emb").rglob("*.npy"))
    check(len(files) == CLI_AUDIOS * 6 and np.load(files[0]).shape == (512,),
          f"aux extract_embedding: {len(files)} files")
    print(f"aux stage1: 2 epochs {s1_s:.1f} s, GE2E loss {losses}; stage1_test "
          f"{test_s:.1f} s, EER {eer:.4f}; extract_embedding {ext_s:.1f} s, "
          f"{len(files)} files ({SMI})")
    config = str(CONFIGS / "sentence.yaml")
    conf = json.loads(json.dumps(load_config(config)))
    conf["data_dim"] = DATA_DIM
    _aux_steps("sentence", conf, lambda rng: {"cap_embeds": rng.normal(
        size=(BATCH, 512)).astype(np.float32)})
    t0 = time.perf_counter()
    exp = Path(cli.main(["train", config, "--epochs=1",
                         f"--embedding_path={tmp}/emb"]
                        + _cli_args(tmp, "sentence")))
    train_s = time.perf_counter() - t0
    line = f"aux sentence CLI: train 1 epoch {train_s:.1f} s, {_epoch_line(exp)}"
    t0 = time.perf_counter()
    scores = cli.main(["evaluate", str(exp)])
    wall = time.perf_counter() - t0
    check(all(math.isfinite(scores[k]) for k in SCORE_KEYS),
          f"aux sentence evaluate: {scores}")
    print(line + f"; evaluate {wall:.2f} s ({CLI_AUDIOS / wall:.1f} clips/s), "
          f"CIDEr {scores['CIDEr']:.4f} ({SMI})")
    return read_counts()


def aux_rest(tmp):
    """(d) ``global_vae`` (2 epochs at its defaults), one epoch of
    configs/ac_vae.yaml warm-started from it (``pretrained_global``: the
    loaded N/M line) with ``use_aug_prob: 0.5`` on a caption file whose
    copies are tagged "aug", ``extract_sentence_embedding`` from a seeded
    512-dim .npy matrix and ``export_embeddings``."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.data.vocab import Vocabulary

    text, vocab = f"{tmp}/text.json", f"{tmp}/vocab.pkl"
    reset_counts()
    t0 = time.perf_counter()
    gv = Path(cli.main(["global_vae", text, vocab, f"--output_dir={tmp}/gvae",
                        "--epochs=2"]))
    gv_s = time.perf_counter() - t0
    losses = re.findall(r"loss ([-\d.]+)", (gv / "global_vae.log").read_text())
    check(len(losses) == 2 and all(math.isfinite(float(v)) for v in losses),
          f"aux global_vae: losses {losses}")
    info = json.loads(Path(text).read_text())
    for audio in info["audios"]:
        audio["captions"] += [dict(c, cap_id=f"aug_{i}")
                              for i, c in enumerate(audio["captions"][:2])]
    Path(f"{tmp}/text_aug.json").write_text(json.dumps(info))
    t0 = time.perf_counter()
    exp = Path(cli.main(["train", str(CONFIGS / "ac_vae.yaml"), "--epochs=1",
                         f"--pretrained_global={gv}/global_vae_params.pt",
                         "--use_aug_prob=0.5"] + _cli_args(tmp, "aug")
                        + [f"--caption_file={tmp}/text_aug.json"]))
    train_s = time.perf_counter() - t0
    loaded = re.findall(r"pretrained_global\[params\]: loaded \d+/\d+ tensors",
                        (exp / "train_caption.log").read_text())
    check(len(loaded) == 1, "aux: no pretrained_global line in the train log")
    n_vocab = len(Vocabulary.load(vocab))
    np.save(f"{tmp}/wv512.npy", np.random.default_rng(5).normal(
        size=(n_vocab, 512)).astype(np.float32))
    t0 = time.perf_counter()
    cli.main(["extract_sentence_embedding", text, vocab, f"{tmp}/wv512.npy",
              f"{tmp}/semb"])
    cli.main(["export_embeddings", f"{tmp}/semb", f"{tmp}/proj"])
    emb_s = time.perf_counter() - t0
    rows = Path(f"{tmp}/proj_vectors.tsv").read_text().splitlines()
    check(len(rows) == CLI_AUDIOS * 5 and len(rows[0].split("\t")) == 512,
          f"aux export_embeddings: {len(rows)} rows")
    hf = aux_hf_embedding(tmp, text)
    print(f"aux global_vae: 2 epochs (batch 64, latent 512) {gv_s:.1f} s, loss "
          f"{losses}; ac_vae.yaml 1 epoch with use_aug_prob 0.5 (7 captions a "
          f"clip, 2 tagged aug) {train_s:.1f} s, {_epoch_line(exp)}, "
          f"{loaded[0]}; extract_sentence_embedding + export_embeddings "
          f"{emb_s:.1f} s, {len(rows)} rows; {hf} ({SMI})")
    return read_counts()


def aux_hf_embedding(tmp, text):
    """``extract_sentence_embedding`` from a local HuggingFace directory (a
    seeded 2-layer BERT, hidden 256, over the corpus's words) on the card
    and on the CPU for 16 clips: the same files within AUX_TOL.  Needs the
    transformers package; without it the branch raises ImportError, and
    this says it was not driven."""
    if importlib.util.find_spec("transformers") is None:
        return "HF extract_sentence_embedding not driven: no transformers package"
    from transformers import BertConfig, BertModel, BertTokenizerFast

    from acvae_tpu_torch.cli import main as cli

    info = json.loads(Path(text).read_text())["audios"][:16]
    Path(f"{tmp}/text16.json").write_text(json.dumps({"audios": info}))
    words = sorted({w for a in info for c in a["captions"]
                    for w in c["tokens"].split()})
    mdir = Path(tmp) / "bert"
    mdir.mkdir()
    (mdir / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words))
    tok = BertTokenizerFast(vocab_file=str(mdir / "vocab.txt"))
    tok.save_pretrained(str(mdir))
    torch.manual_seed(8)
    BertModel(BertConfig(vocab_size=len(tok), hidden_size=256,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=1024)).save_pretrained(str(mdir))
    t0 = time.perf_counter()
    cli.main(["extract_sentence_embedding", f"{tmp}/text16.json", "unused",
              str(mdir), f"{tmp}/hf_card"])
    card_s = time.perf_counter() - t0
    cli.main(["extract_sentence_embedding", f"{tmp}/text16.json", "unused",
              str(mdir), f"{tmp}/hf_cpu", "--device=cpu"])
    files = sorted(p.relative_to(f"{tmp}/hf_cpu")
                   for p in Path(f"{tmp}/hf_cpu").rglob("*.npy"))
    check(len(files) == 16 * 6, f"aux HF embedding: {len(files)} files")
    errs = {}
    for rel in files:
        _aux_close(errs, "hf embedding",
                   torch.tensor(np.load(Path(f"{tmp}/hf_card") / rel)),
                   torch.tensor(np.load(Path(f"{tmp}/hf_cpu") / rel)))
    return (f"HF extract_sentence_embedding (BERT 2x256) on the card "
            f"{card_s:.2f} s for 16 clips, {len(files)} files, max |card - cpu| "
            f"{errs['hf embedding']:.3g}")


# phase 16: the seeded wavs of prepare_data (name -> rate, seconds,
# channels): 32 kHz mono and stereo, and 16 kHz (resampled), int16
EXPORT_WAVS = {"mono.wav": (32000, 10.0, 1), "stereo.wav": (32000, 7.3, 2),
               "rate16k.wav": (16000, 5.1, 1)}


def export_phase(tmp):
    """Phase 16, the deployment path; returns the kernel launches over all
    of it."""
    from acvae_tpu_torch.cli import main as cli
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.train.checkpoints import save_experiment

    reset_counts()
    torch.manual_seed(7)    # phase 9's seeded weights
    exp = f"{tmp}/export_exp"
    conf = copy.deepcopy(FLAGSHIP_CONF)
    save_experiment(exp, build_model(conf, VOCAB, DATA_DIM, device="cuda"),
                    conf, flagship_vocab())
    arts = {}
    for tag, flags in (("int8", ["--encoder_int8", "--platforms=cuda,cpu"]),
                       ("bf16", ["--decode_dtype=bfloat16"])):
        before = read_counts()
        t0 = time.perf_counter()
        arts[tag] = cli.main(["export_model", exp, f"--t_mel={T_MEL}",
                              f"--max_length={MAX_LEN}", f"--beam_size={BEAM}",
                              f"--output_dir={tmp}/export_{tag}", *flags])
        secs = time.perf_counter() - t0
        meta = json.load(open(f"{arts[tag]}/meta.json"))
        check(meta["batch"] == "symbolic", f"export {tag}: batch {meta['batch']}")
        check(read_counts() == before, f"export {tag}: the trace launched kernels")
        print(f"export {tag}: cli export_model {secs:.1f} s (calibration, trace, "
              f"save{', load on cpu and cuda' if tag == 'int8' else ''}); "
              f"decode.pt2 {meta['artifact_bytes']} bytes; noise "
              f"{meta['noise']} ({SMI})")
    counts = export_decodes(exp, conf, arts)
    export_service(arts["int8"])
    export_prepare_data(cli, tmp)
    total = read_counts()
    print(f"export: launches over the path {total} ({SMI})")
    check(total == {k: counts[k] for k in total},
          f"export: launches outside the decodes {total} vs {counts}")
    return total


def export_decodes(exp, conf, arts):
    """Each artifact in a new ``load_exported`` on the card against the
    eager decode of the same experiment: one warm-up and DEC_TIMED timed
    batches of 512 each, in turns, on the same noise; tokens identical,
    scores within 1e-6 (float32 on the same kernels).  Returns the
    launches of these batches: 1 + 7 + 3 an int8 batch and 8 bn_relu a
    bf16 one, and 20 topk_rows either, either way."""
    from acvae_tpu_torch.export import load_exported
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)
    from acvae_tpu_torch.ops.amp import cast_floats_for_decode
    from acvae_tpu_torch.train.checkpoints import load_experiment

    _, vocab, model = load_experiment(exp, device="cuda")
    g = torch.Generator("cuda").manual_seed(17)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.randint(T_MEL // 2, T_MEL + 1, (DEC_BATCH,), generator=g,
                         device="cuda").to(torch.int32)
    counts = dict.fromkeys(kernel_fns(), 0)
    for tag, art in arts.items():
        t0 = time.perf_counter()
        decode, meta = load_exported(art)       # the card by default
        load_s = time.perf_counter() - t0
        check(decode.device.type == "cuda", f"load_exported: {decode.device}")
        enc_ms = []
        if tag == "int8":
            quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))

            def timed_quant(f, l):
                """The eager decode's int8 encoder, timed with CUDA events
                (the same operators as the exported program's)."""
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = quant(f, l)
                end.record()
                end.synchronize()
                enc_ms.append(start.elapsed_time(end))
                return out
            eager = int8_decode_fn(model, timed_quant, **BEAM_KW)
        else:
            cast = cast_floats_for_decode(model, torch.bfloat16)
            eager = functools.partial(cast.inference_forward, **BEAM_KW)
        ms = {"exported": [], "eager": []}
        got = {arm: dict.fromkeys(kernel_fns(), 0) for arm in ms}
        for i in range(1 + DEC_TIMED):
            noise = decode.noise(DEC_BATCH, seed=100 + i)
            outs = {}
            for arm, run in (("exported", lambda: decode.program(feats, lens,
                                                                 *noise)),
                             ("eager", lambda: eager(feats, lens, eps=noise[0]))):
                before = read_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                outs[arm] = run()
                torch.cuda.synchronize()
                ms[arm].append((time.perf_counter() - t1) * 1e3)
                got[arm] = {k: got[arm][k] + v - before[k]
                            for k, v in read_counts().items()}
            a, b = outs["exported"], outs["eager"]
            check(tuple(a["seqs"].shape) == (DEC_BATCH, BEAM, MAX_LEN),
                  f"export {tag}: seqs {tuple(a['seqs'].shape)}")
            differ = int((a["seqs"] != b["seqs"]).any(-1).any(-1).sum())
            check(differ == 0, f"export {tag}: batch {i}: {differ} clips' "
                               f"tokens differ from the eager decode's")
            err = (a["scores"] - b["scores"]).abs().max().item()
            check(err <= 1e-6 * (1 + b["scores"].abs().max().item()),
                  f"export {tag}: scores differ by {err}")
        n = 1 + DEC_TIMED
        want = ((per_batches(CNN10_PER_BATCH, n) if tag == "int8" else (0, 0, 0))
                + (0, 0 if tag == "int8" else CNN10_BN_RELU_PER_BATCH * n,
                   topk_per_search(BEAM_KW) * n))
        for arm, c in got.items():
            check(int8_launches(c) + (c["time_warp_1d"], c["bn_relu"],
                                      c["topk_rows"]) == want,
                  f"export {tag} {arm}: launches {c} in {n} batches (expected {want})")
            counts = {k: counts[k] + c[k] for k in counts}
        rates = {arm: DEC_BATCH * DEC_TIMED / (sum(v[1:]) / 1e3)
                 for arm, v in ms.items()}
        RATES[f"export {tag}"] = rates["exported"]
        if enc_ms:
            enc = statistics.median(enc_ms[1:])
            print(f"export int8 split (the eager decode, the same operators): "
                  f"encoder {enc:.1f} ms, the rest {statistics.median(ms['eager'][1:]) - enc:.1f} "
                  f"ms of a batch; the exported program's batch "
                  f"{statistics.median(ms['exported'][1:]):.1f} ms ({SMI})")
        top = a["seqs"][:2, 0].cpu().numpy()
        print(f"export {tag}: load_exported {load_s:.1f} s; batch {DEC_BATCH} "
              f"beam {BEAM} T_mel {T_MEL} max_length {MAX_LEN}, tokens identical "
              f"in {1 + DEC_TIMED} batches, scores max |diff| {err:.3g}; "
              f"exported {rates['exported']:.1f} captions/s (batch ms "
              f"{', '.join(f'{t:.1f}' for t in ms['exported'])}), eager "
              f"{rates['eager']:.1f} ({', '.join(f'{t:.1f}' for t in ms['eager'])}"
              f"); launches of the exported program {got['exported']}; first "
              f"captions: "
              + " | ".join(" ".join(vocab.decode(s)) for s in top) + f" ({SMI})")
        del decode, eager
        torch.cuda.empty_cache()
    return counts


def export_service(art):
    """``cli serve --exported=<the int8 artifact>`` as a process of its own
    (its output in ``<art>/serve.log``): /health, then POST /caption with a
    float32 JSON mel, a binary uint8 one and a wav; the process is stopped
    after."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    log = open(f"{art}/serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acvae_tpu_torch.cli", "serve",
         f"--exported={art}", f"--port={port}", "--batch_size=16"],
        cwd=str(Path(__file__).resolve().parent), stdout=log,
        stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        while True:
            check(proc.poll() is None,
                  f"cli serve --exported exited {proc.returncode}: "
                  f"{open(f'{art}/serve.log').read()[-2000:]}")
            check(time.perf_counter() - t0 < 300, "cli serve: no /health in 300 s")
            try:
                code, health = _http(base + "/health", timeout=10)
                break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                time.sleep(0.5)
        ready = time.perf_counter() - t0
        check(code == 200 and health["status"] == "ok"
              and health["mel_bucket"] == T_MEL, f"/health: {health}")
        rng = np.random.default_rng(8)
        mel = rng.normal(size=(T_MEL, DATA_DIM)).astype(np.float32)
        lo, hi = float(mel.min()), float(mel.max())
        scale = (hi - lo) / 255.0
        q = np.clip(np.round((mel - lo) / scale), 0, 255).astype(np.uint8)
        wav = (rng.normal(size=96000) * 0.1).astype(np.float32)
        js = {"Content-Type": "application/json"}
        for name, data, headers in (
                ("json f32 mel", json.dumps({"mel": mel.tolist()}).encode(), js),
                ("binary uint8 mel", q.tobytes(), {
                    "Content-Type": "application/octet-stream",
                    "X-Mel-Frames": str(T_MEL), "X-Mel-Bins": str(DATA_DIM),
                    "X-Mel-Dtype": "uint8", "X-Mel-Scale": str(scale),
                    "X-Mel-Offset": str(lo)}),
                ("json wav 3 s", json.dumps({"wav": wav.tolist(),
                                             "sr": 32000}).encode(), js)):
            t1 = time.perf_counter()
            code, reply = _http(base + "/caption", data, headers)
            check(code == 200 and isinstance(reply.get("caption"), str),
                  f"cli serve --exported: {name}: {code} {reply}")
            print(f"export serve: {name}: 200 in "
                  f"{(time.perf_counter() - t1) * 1e3:.1f} ms: "
                  f"{reply['caption'][:60]!r}")
        code, stats = _http(base + "/stats")
        check(code == 200 and stats["ok"] == 3 and stats["server_errors"] == 0,
              f"cli serve --exported /stats: {stats}")
        print(f"export serve: cli serve --exported ready in {ready:.1f} s "
              f"(process start, load, warm-up); /stats "
              + json.dumps({k: stats.get(k) for k in ("requests", "ok",
                                                      "latency_ms_p50")}))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def export_prepare_data(cli, tmp):
    """``cli prepare_data`` on seeded wavs, on the card and with
    ``--device=cpu``: the same clips and frames; mels within atol 1e-4 dB
    (the frontend computes in float64), the largest gap printed apart for
    the bands more than 60 dB below their frame's peak."""
    from scipy.io import wavfile

    wav_dir = Path(tmp) / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(9)
    for i, (name, (sr, dur, ch)) in enumerate(EXPORT_WAVS.items()):
        t = np.arange(int(sr * dur)) / sr
        wave = (0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t)[:, None]
                + 0.05 * rng.normal(size=(len(t), ch)))
        data = (wave * 32767).astype(np.int16)
        wavfile.write(str(wav_dir / name), sr, data[:, 0] if ch == 1 else data)
    secs, mels = [], []
    for i, dev in enumerate(("cuda", "cpu")):
        t0 = time.perf_counter()
        cli.main(["prepare_data", str(wav_dir), f"{tmp}/mels{i}.npz",
                  f"{tmp}/mels{i}.csv", f"--device={dev}"])
        secs.append(time.perf_counter() - t0)
        mels.append(np.load(f"{tmp}/mels{i}.npz"))
    card, cpu = mels
    check(sorted(card.files) == sorted(cpu.files) == sorted(EXPORT_WAVS),
          f"prepare_data clips {card.files} {cpu.files}")
    errs = []
    for name in EXPORT_WAVS:
        a, b = card[name], cpu[name]
        check(a.shape == b.shape and a.shape[1] == DATA_DIM,
              f"prepare_data {name}: {a.shape} vs {b.shape}")
        floor = b < b.max(axis=1, keepdims=True) - 60.0
        d = np.abs(a - b)
        e = (float(d[~floor].max()), float(d[floor].max()) if floor.any() else 0.0)
        check(max(e) <= 1e-4, f"prepare_data {name}: card vs cpu {e[0]:.3g} "
                              f"dB, {e[1]:.3g} at the noise floor (1e-4)")
        errs.append(f"{name} {a.shape[0]} frames {e[0]:.3g}/{e[1]:.3g}")
    print(f"export prepare_data: card {secs[0]:.2f} s, cpu {secs[1]:.2f} s; "
          f"max |card - cpu| dB (above / at the noise floor): " + ", ".join(errs))


# phase 17: (b)'s subset of phase 10's clips (96 of 320: 14 train iterations
# of 32 an epoch at train_percent 90, one validation batch) and epochs
TOOLS_AUDIOS, TOOLS_EPOCHS = 96, 2


def tools_phase(tmp, exp):
    """Phase 17, the rest of the CLI on phase 10's corpus and experiment;
    returns the kernel launches over all of it."""
    from acvae_tpu_torch.cli import main as cli

    reset_counts()
    torch.cuda.empty_cache()
    root = Path(tmp) / "tools"
    root.mkdir()
    config = str(CONFIGS / "ac_vae.yaml")
    data = [f"--h5_csv={tmp}/mels.csv", f"--caption_file={tmp}/text.json",
            f"--vocab_file={tmp}/vocab.pkl"]
    tools_isolated_sweep(cli, config, data, root)
    tools_tpe_sweep(cli, config, data, tmp, root)
    counts = tools_import(cli, config, tmp, exp, root)
    tools_host(cli, tmp, exp, root)
    tools_doctor(cli)
    total = read_counts()
    print(f"tools: launches over the path {total} ({SMI})")
    # bn_relu runs wherever a PANN encoder infers and topk_rows wherever a
    # beam search runs, the sweeps' validation too
    outside = {k: total[k] - counts[k] for k in total
               if k not in ("bn_relu", "topk_rows")}
    check(not any(outside.values()), f"tools: launches outside the evaluates "
                                     f"{total} vs {counts}")
    return total


def _timed_calls(owner, name, log):
    """Wrap ``owner.<name>`` to append each call's wall seconds to ``log``;
    returns the undo."""
    real = getattr(owner, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        log.append(time.perf_counter() - t0)
        return out
    setattr(owner, name, timed)
    return lambda: setattr(owner, name, real)


def tools_isolated_sweep(cli, config, data, root):
    """(a) ``sweep --param=beta --values=0.5,0.4 --epochs=1
    --isolate_trials=true``: each trial a ``cli train`` process of its own
    on the card (its log names the card), one epoch of 45 iterations."""
    walls = []
    undo = _timed_calls(cli, "_trial_subprocess", walls)
    t0 = time.perf_counter()
    try:
        res = cli.main(["sweep", config, "--param=beta", "--values=0.5,0.4",
                        "--epochs=1", "--isolate_trials=true", *data,
                        f"--outputpath={root}/iso"])
    finally:
        undo()
    wall = time.perf_counter() - t0
    check(len(res) == 2, f"isolated sweep: {len(res)} trials")
    for (tag, r), secs in zip(res.items(), walls):
        exp = Path(r["exp_dir"])
        log = (exp / "train_caption.log").read_text()
        check("device: cuda" in log and "H100" in log,
              f"isolated sweep {tag}: the trial did not train on the card: "
              + "".join(line for line in log.splitlines(True) if "device" in line))
        m = [json.loads(line) for line in
             (exp / "metrics.jsonl").read_text().splitlines()]
        check(len(m) == 1 and math.isfinite(m[0]["train_loss"])
              and (exp / "last.pt").exists(), f"isolated sweep {tag}: {m}")
        print(f"tools sweep --isolate_trials {tag}: process {secs:.1f} s "
              f"(start, load, {CLI_ITERS} iterations, validation, saves); "
              f"epoch wall {m[0]['epoch_wall_s']:.2f} s, loss "
              f"{m[0]['train_loss']:.4f}, val CIDEr {r['best']:.4f} ({SMI})")
    print(f"tools sweep --isolate_trials: {wall:.1f} s for 2 trials ({SMI})")


def tools_tpe_sweep(cli, config, data, tmp, root):
    """(b) the in-process TPE sweep with the median assessor on a subset of
    phase 10's clips, at full width."""
    info = json.loads(Path(f"{tmp}/text.json").read_text())["audios"]
    sub = root / "sub_text.json"
    sub.write_text(json.dumps({"audios": info[:TOOLS_AUDIOS]}))
    walls = []
    undo = _timed_calls(cli, "train", walls)
    t0 = time.perf_counter()
    try:
        res = cli.main(["sweep", config, "--mode=tpe", "--n_trials=3",
                        "--space={beta: [0.3, 0.5], smoothing: [0.05, 0.1]}",
                        "--assessor=median", "--assessor_min_trials=1",
                        "--assessor_min_epochs=1", f"--epochs={TOOLS_EPOCHS}",
                        *data[:1], f"--caption_file={sub}", *data[2:],
                        f"--outputpath={root}/tpe"])
    finally:
        undo()
    wall = time.perf_counter() - t0
    check(len(res) == 3 and len(walls) == 3, f"tpe sweep: {len(res)} trials")
    for (tag, r), secs in zip(res.items(), walls):
        exp = Path(r["exp_dir"])
        n = len((exp / "metrics.jsonl").read_text().splitlines())
        stopped = bool(r.get("stopped_early"))
        check(math.isfinite(r["best"]) and (exp / "last.pt").exists()
              and (n <= TOOLS_EPOCHS if stopped else n == TOOLS_EPOCHS),
              f"tpe sweep {tag}: {r}, {n} epochs")
        if stopped:   # after epoch n's saves
            check(f"assessor: trial stopped early at epoch {n} "
                  in (exp / "train_caption.log").read_text(),
                  f"tpe sweep {tag}: no assessor line for epoch {n} in the log")
        print(f"tools sweep tpe {tag}: suggested {r['params']}, {secs:.1f} s, "
              f"{n} epochs, best val CIDEr {r['best']:.4f}, stopped_early "
              f"{stopped} ({SMI})")
    print(f"tools sweep tpe: {wall:.1f} s for 3 trials of {TOOLS_AUDIOS} "
          f"clips ({SMI})")


def tools_import(cli, config, tmp, exp, root):
    """(c) phase 10's best weights as a reference ``.pth`` (``{"model":
    ...}``, DDP's ``module.`` prefix) through ``cli import_torch``, then
    ``evaluate --encoder_int8`` of the import and of its source in turns:
    the same captions and scores, 1 + 7 + 3 launches an eval batch (calibration
    apart).  Returns the launches of the two evaluates."""
    sd = torch.load(Path(exp) / "best.pt", map_location="cpu",
                    weights_only=True)["state_dict"]
    pth = root / "best.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()
                          if not k.endswith("stem_pad_lanes")}}, pth)
    t0 = time.perf_counter()
    counts = cli.main(["import_torch", str(pth), config, f"{root}/imported",
                       f"{tmp}/vocab.pkl", f"--data_dim={DATA_DIM}"])
    secs = time.perf_counter() - t0
    check(counts["params_loaded"] == counts["params_total"]
          and counts["stats_loaded"] == counts["stats_total"],
          f"import_torch: {counts}")
    ours = torch.load(f"{root}/imported/best.pt", map_location="cpu",
                      weights_only=True)["state_dict"]
    check(ours.keys() == sd.keys() and all(torch.equal(ours[k], sd[k]) for k in sd),
          "import_torch: the imported weights differ from the source's")
    print(f"tools import_torch: {counts} in {secs:.1f} s, every tensor equal "
          f"to the source's ({SMI})")
    real, calib = cli.quant_encoder_for, []

    def quant(*a, **k):
        before = read_counts()
        q = real(*a, **k)
        calib.append({n: c - before[n] for n, c in read_counts().items()})
        return q
    cli.quant_encoder_for = quant
    outs, total = {}, dict.fromkeys(kernel_fns(), 0)
    try:
        for tag, path in (("imported", f"{root}/imported"), ("source", str(exp))):
            before = read_counts()
            t0 = time.perf_counter()
            scores = cli.main(["evaluate", path, f"--eval_h5_csv={tmp}/mels.csv",
                               f"--eval_caption_file={tmp}/text.json",
                               "--encoder_int8", "--tag=tools"])
            secs = time.perf_counter() - t0
            got = {k: v - before[k] for k, v in read_counts().items()}
            total = {k: total[k] + got[k] for k in total}
            want = per_batches(CNN10_PER_BATCH, CLI_EVAL_BATCHES) + (0,)
            c = calib[-1]
            check(int8_launches(got, c) + (got["time_warp_1d"],) == want,
                  f"evaluate {tag}: launches {got} (calibration {c}), "
                  f"expected {want} in {CLI_EVAL_BATCHES} batches")
            outs[tag] = [(Path(path) / f"{kind}_beam_3_int8_tools.{ext}").read_text()
                         for kind, ext in (("eval_output", "json"), ("scores", "txt"))]
            print(f"tools evaluate --encoder_int8 {tag}: {secs:.2f} s for "
                  f"{CLI_AUDIOS} clips; CIDEr {scores['CIDEr']:.4f}; launches "
                  f"{got}, of which calibration {c} ({SMI})")
    finally:
        cli.quant_encoder_for = real
    check(outs["imported"] == outs["source"],
          "the imported experiment's int8 captions or scores differ from its "
          "source's")
    preds = json.loads(outs["source"][0])["predictions"]
    check(len(preds) == CLI_AUDIOS, f"evaluate: {len(preds)} captions")
    print(f"tools: the import and its source wrote identical captions "
          f"({len(preds)}) and scores; first: {preds[0]['caption']!r}")
    return total


def tools_host(cli, tmp, exp, root):
    """(d) report_results over two seed dirs holding (c)'s scores,
    split_dataset, concat_json and concat_csv on the corpus files, and tsne
    (which needs scikit-learn and matplotlib)."""
    score = "scores_beam_3_int8_tools.txt"
    t0 = time.perf_counter()
    for i, src in enumerate((f"{root}/imported", exp)):
        d = root / "report" / f"seed_{i + 1}"
        d.mkdir(parents=True)
        (d / score).write_text((Path(src) / score).read_text())
    values = cli.main(["report_results", str(root / "report"),
                       f"--score_file={score}"])
    check(values and all(len(v) == 2 and v[0] == v[1] for v in values.values())
          and (root / "report" / f"aggregated_{score}").exists(),
          f"report_results: {values}")
    cli.main(["split_dataset", f"{tmp}/text.json", f"{root}/split"])
    halves = [json.loads(Path(f"{root}/split_{h}.json").read_text())["audios"]
              for h in ("hard", "easy")]
    check([len(h) for h in halves] == [CLI_AUDIOS // 2] * 2,
          f"split_dataset: {[len(h) for h in halves]}")
    cli.main(["concat_json", f"{root}/split_hard.json", f"{root}/split_easy.json",
              f"--output={root}/joined.json"])
    joined = json.loads((root / "joined.json").read_text())["audios"]
    check(sorted(a["audio_id"] for a in joined)
          == sorted(a["audio_id"] for a in json.loads(
              Path(f"{tmp}/text.json").read_text())["audios"]),
          "concat_json: the halves do not join to the corpus")
    cli.main(["concat_csv", f"{tmp}/mels.csv", f"{tmp}/mels.csv",
              f"--output={root}/joined.csv"])
    lines = (root / "joined.csv").read_text().splitlines()
    check(lines[0] == "audio_id\thdf5_path" and len(lines) == 1 + 2 * CLI_AUDIOS,
          f"concat_csv: {len(lines)} lines")
    rng = np.random.default_rng(5)
    for a in range(6):
        d = root / "emb" / f"aud{a}"
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"{i}.npy", rng.normal(size=16).astype(np.float32))
    try:
        pngs = cli.main(["tsne", str(root / "emb"),
                         f"--output_prefix={root}/tsne"])
        check(len(pngs) == 1 and Path(pngs[0]).exists(), f"tsne: {pngs}")
        tsne = f"wrote {pngs[0]}"
    except ImportError as e:
        check("scikit-learn and matplotlib" in str(e), f"tsne: {e}")
        tsne = f"refused: {e}"
    print(f"tools host commands: report_results {dict(values)}; split_dataset "
          f"{CLI_AUDIOS // 2}/{CLI_AUDIOS // 2}; concat_json {len(joined)} "
          f"audios; concat_csv {len(lines) - 1} rows; tsne {tsne}; "
          f"{time.perf_counter() - t0:.2f} s")


def tools_doctor(cli):
    """(e) ``doctor`` on the card: the probe names the card, and the build
    directory holds the kernels' libraries."""
    report = cli.main(["doctor"])
    dev = report["device"]
    check(report["ok"] and dev["type"] == "cuda" and "H100" in dev["name"]
          and report["kernel_build"]["entries"] >= 2, f"doctor: {report}")
    print(f"tools doctor: {dev['name']} x{dev['count']}, torch "
          f"{report['torch_version']} cuda {report['cuda_runtime']}, first "
          f"matmul {dev['first_call_s']} s, matmul p50 {dev['matmul_ms_p50']} "
          f"ms, kernel build {report['kernel_build']}, probe "
          f"{report['probe_wall_s']} s ({SMI})")


# phase 18: the flagship at full width, its vocabulary padded to a multiple
# of the model axis (build_vocab --pad_to_multiple=2: 4981 -> 4982)
PAR_VOCAB = VOCAB + 1
PAR_EPOCH = 12


# the encoders that take no dtype (float32 in both packages)
PAR_TRANSFORMERS = ("TransformerEncoder", "M2TransformerEncoder")


def par_conf(dtype, encoder="Cnn10"):
    """The flagship with its dropouts off, ``encoder`` in ``dtype``, and
    one Adam step at lr 1e-4: Cnn10 as the recipe has it; the PANN Cnn14
    or ResNet38 with a 2048-wide pooled embedding, as phase 14 sets Cnn14
    up; any other encoder at its own default widths (the transformers,
    which take no dtype, in float32).  The encoders but Cnn10 hard-code
    their dropouts or default them on: the steps turn every dropout off
    (``parity.dropout_off``)."""
    from acvae_tpu_torch.configs import flagship_conf
    conf = flagship_conf(scheduler="constant", scheduler_args={},
                         optimizer_args={"lr": 1e-4}, encodermodel=encoder)
    if encoder == "Cnn10":
        conf["encoder_args"] = dict(conf["encoder_args"], dtype=dtype,
                                    conv_dropout=0.0, head_dropout=0.0)
    elif encoder in ("Cnn14", "ResNet38"):
        conf["encoder_args"] = dict(conf["encoder_args"], dtype=dtype,
                                    embed_size=2048)
    elif encoder in PAR_TRANSFORMERS:
        check(dtype == "float32", f"{encoder} has no {dtype} mode")
        conf["encoder_args"] = {}
    else:
        conf["encoder_args"] = {"dtype": dtype}
    conf["decoder_args"] = dict(conf["decoder_args"], dropout=0.0)
    return conf


def par_rank_step(*args, **kwargs):
    """A pool job: ``train_step_case`` with TF32 off, as in this process,
    and every dropout off; the rank's cached blocks are freed after it, so
    that the next job's ranks and unsplit step find the card empty."""
    import gc

    from acvae_tpu_torch.parallel.parity import train_step_case
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return train_step_case(*args, dropout=False, **kwargs)
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def par_rank_step_faulty(fault, *args, **kwargs):
    """A pool job with a planted fault of ``parity.FAULTS``: the halo
    exchange's backward returning zeros (the neighbours' edge gradients
    lost), or the transformers' keys and values gathered with
    ``gather_replicated`` (each frame's gradient from its own rank's
    queries only); the gradient check must catch either."""
    from acvae_tpu_torch.parallel.parity import FAULTS
    with FAULTS[fault]():
        return par_rank_step(*args, **kwargs)


def _warm_step(trainer, batch, it, epoch, start):
    """One step after a warm-up step from ``start`` (the trainer's state,
    on the CPU): (metrics, ms); the peak memory counter restarts at the
    timed step."""
    trainer.step(batch, it, epoch)
    trainer.load_state(start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = trainer.step(batch, it, epoch)
    torch.cuda.synchronize()
    return m, (time.perf_counter() - t0) * 1e3


# Per encoder dtype: the loss's rtol against the unsplit step, and the
# limits of the largest per-tensor relative error ||split - unsplit|| /
# ||unsplit|| of the gradients before Adam and of the step's update of the
# weights.  Set from the readings on 1 and 4 cards (PERF.md, §6): in
# float32 the splits' gradients read at most 9.3e-4 (at bn0.weight, where
# the unsplit step itself is 7.5e-4 off its float64-BatchNorm twin) and
# the planted faults at least 0.26 (the halo exchange's backward dropped)
# and 0.5 (gradients averaged instead of summed); the updates 0.026
# against the dropped halo's 0.72.  With bf16 convs each split rounds
# other bf16 activations: gradients up to 0.083 against 0.50 averaged; bf16
# alone moves the unsplit loss 2.1e-4 off the float32 one, and the update
# (Adam's first step is lr·sign(g)) reads the sign flips of the smallest
# gradients, up to 0.43.
PAR_DTYPES = {"float32": {"loss": 1e-5, "grad": 5e-3, "update": 0.1},
              "bfloat16": {"loss": 1e-4, "grad": 0.25, "update": 1.0}}
# Cnn14's bf16 step is far more sensitive to any rounding than Cnn10's:
# the unsplit step itself, with only its BatchNorms in float64 instead of
# float32, moves its loss 9.28e-4 and its gradients 0.367 (at
# decoder.word_embeddings.weight; the decoder is fed its own argmax at
# ss_ratio 0.13).  Its splits read a loss 2.29e-4 / 4.29e-4 off and
# gradients 0.318 / 0.417 (T_mel 1024 / 3072), gradients averaged instead
# of summed 0.539 / 0.542 (PERF.md §5): limits between the two.
PAR_LIMITS = {("Cnn14", "bfloat16"): {"loss": 2e-3, "grad": 0.47,
                                      "update": 1.0}}
HELD = ("loss", "grad", "update")
F32_PROBED = ("float32", HELD, False, True, False)
# (encoder, its cases, its passes): a pass is (dtype, held, BatchNorm in
# float64, probed, timed).  The flagship's Cnn10 takes a DP, a TP and an SP
# step, every other encoder an SP step; a timed pass takes a warm-up step
# first, and a probed float32 SP pass of an encoder in PAR_FAULTS also
# takes its planted fault.  Cnn14's and ResNet38's float32 BatchNorms
# round 5x as far as Cnn10's (the unsplit step against its float64-BN
# twin 4.06e-3 per tensor, Cnn10 7.5e-4; PERF.md §6), enough to move
# Adam's first update (lr·sign(g)) past its limit with no fault (0.112
# against 0.1): their float32 step with the port's BatchNorm holds the
# loss and the gradients, and a second pass with BatchNorm in float64 on
# both sides (``parity.batchnorm_float64``) holds the update.  The
# encoders split since (ResNetEncoder, CNNEncoder, CNN10Encoder,
# E2EASREncoder and the transformers, one of each way to split) take one
# float32 pass each; TransformerEncoder's is timed, for its memory a rank.
PAR_MODELS = (("Cnn10", ("dp", "tp", "sp"),
               (F32_PROBED, ("bfloat16", HELD, False, False, True))),
              ("Cnn14", ("sp",), (("float32", ("loss", "grad"), False, True, False),
                                  ("float32", HELD, True, False, False),
                                  ("bfloat16", HELD, False, True, True))),
              ("ResNet38", ("sp",), (("float32", ("loss", "grad"), False, True,
                                      False),
                                     ("float32", HELD, True, False, False))),
              ("ResNetEncoder", ("sp",), (F32_PROBED,)),
              ("CNNEncoder", ("sp",), (F32_PROBED,)),
              ("CNN10Encoder", ("sp",), (F32_PROBED,)),
              ("E2EASREncoder", ("sp",), (F32_PROBED,)),
              ("TransformerEncoder", ("sp",), (("float32", HELD, False, True,
                                                True),)),
              ("M2TransformerEncoder", ("sp",), (F32_PROBED,)))
# The encoders whose norms' scales and biases are drawn from a seed (as a
# trained model has them) before the unsplit step writes the weights the
# ranks load.  At init (scale 1, bias 0) CNN10Encoder's first BatchNorm,
# over the one mel channel, reaches the next BatchNorm through a conv and a
# leaky relu alone, which normalize its scale away: the scale's gradient
# is zero in exact arithmetic and all rounding (`b0_1_bn.weight` moved
# 1.19e-2 when only cuDNN's conv algorithms changed, 8.5e-3 with
# BatchNorm in float64; PERF.md §6), which no relative check can
# hold.  The other encoders keep the init's norms: drawn, ResNetEncoder's
# 20 BatchNorms of scales up to 2 compound through its residuals and its
# unsplit step's float32 BatchNorm moved 9.8e-3 off its float64 twin.  The
# CPU tests draw every new encoder's norms
# (tests/test_torch_parallel_encoders.py).
PAR_DRAWN_NORMS = ("CNN10Encoder",)
# the planted fault each encoder's probed float32 SP pass must fail
PAR_FAULTS = {"Cnn10": "halo_dropped", "Cnn14": "halo_dropped",
              "ResNet38": "halo_dropped", "ResNetEncoder": "halo_dropped",
              "TransformerEncoder": "kv_replicated"}
PAR_CASES = {"dp": (1, False), "tp": (2, False), "sp": (2, True)}
# the largest mel bucket (data/dataset.py DEFAULT_BUCKETS), where Cnn14's
# activations and the transformer's [N, 8, T, T] attention buffers peak;
# the timed SP steps taken there, memory a rank against the unsplit step's
T_MEL_MAX = 3072
PAR_LONG = (("Cnn14", "bfloat16"), ("TransformerEncoder", "float32"))


def _rel(err):
    return (f"{err['rel']:.3g} at {err['rel_at']} (top "
            f"{[(k, float(f'{v:.3g}')) for k, v in err['rel_top']]})")


def _gib(b):
    return "n/a" if b is None else f"{b / 2**30:.3f}"


def _draw_norms(model, seed=17):
    """Every BatchNorm's and LayerNorm's scale drawn from U(0.5, 2) and
    bias from N(0, 0.3) with a generator of ``seed``, in place."""
    from acvae_tpu_torch.models.encoders import BatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, torch.nn.LayerNorm)):
                shape = m.weight.shape
                m.weight.copy_(torch.rand(shape, generator=g) * 1.5 + 0.5)
                m.bias.copy_(torch.randn(shape, generator=g) * 0.3)


def _unsplit_reference(conf, batch, it, total, tmp, timed, probe,
                       bn64=False, draw_norms=False):
    """The unsplit step on the card (BatchNorm in float64 with ``bn64``;
    the encoder's norms drawn by :func:`_draw_norms` with ``draw_norms``):
    writes its start weights, gradients and weights after the step;
    returns (loss, ms or None, peak bytes of the timed step above what
    this process held before, probes).  With ``probe``, the same step again from the
    same state twice, its loss and each gradient against the first step's
    (``errors``): ``cudnn`` with cuDNN's benchmarked conv algorithms (the
    convs' sums in another order), and ``bn64`` with every BatchNorm's
    statistics and normalization in float64 (``bn32``: in float32, as the
    port runs, when the step itself is ``bn64``): the rounding a split
    reorders.  Every dropout is off."""
    from acvae_tpu_torch.parallel.parity import (batchnorm_float64,
                                                 dropout_off, errors,
                                                 state_on_cpu)
    from acvae_tpu_torch.train.trainer import Trainer
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    single = Trainer(conf, PAR_VOCAB, DATA_DIM, device="cuda",
                     total_iters=total)
    if draw_norms:
        _draw_norms(single.model.encoder)
    torch.save({k: v.cpu() for k, v in single.model.state_dict().items()},
               f"{tmp}/par_state.pt")
    start = state_on_cpu(single.state()) if timed or probe else None
    with dropout_off(), batchnorm_float64(bn64):
        if timed:
            m, ms = _warm_step(single, batch, it, PAR_EPOCH, start)
            peak = torch.cuda.max_memory_allocated() - base
        else:
            m, ms, peak = single.step(batch, it, PAR_EPOCH), None, None
    loss = float(m["loss"])
    grads = {k: p.grad.clone() for k, p in single.model.named_parameters()
             if p.grad is not None}
    torch.save({"grads": {k: g.cpu() for k, g in grads.items()},
                "weights": {k: v.cpu() for k, v in
                            single.model.state_dict().items()}},
               f"{tmp}/par_ref.pt")
    probes = {}
    for name in (("cudnn", "bn32" if bn64 else "bn64") if probe else ()):
        single.load_state(start)
        torch.backends.cudnn.benchmark = name == "cudnn"
        try:
            with dropout_off(), batchnorm_float64(bn64 == (name == "cudnn")):
                pm = single.step(batch, it, PAR_EPOCH)
        finally:
            torch.backends.cudnn.benchmark = False
        probes[name] = errors({k: p.grad for k, p in
                               single.model.named_parameters()
                               if p.grad is not None}, grads, 1e-3, 2e-6)
        probes[name]["loss_rel"] = abs(float(pm["loss"]) - loss) / abs(loss)
    del single, grads, start
    torch.cuda.empty_cache()
    return loss, ms, peak, probes


def parallel_steps(tmp, devices, backend, label):
    """Phase 18 (a)/(d): the passes of ``PAR_MODELS`` on ``len(devices)``
    ranks against the unsplit step on the card from the same weights and
    global draws (the generators' whole-batch draws, each rank keeping its
    rows), with the encoder in float32 and in bf16 as the recipe has it
    (timed after a warm-up step, the peak memory of the unsplit step and
    of each rank in the timed step printed): the loss, the gradients
    before Adam and the step's update of the weights within
    ``PAR_DTYPES``'s limits where a pass holds them, and the planted faults
    outside them; then ``PAR_LONG``'s timed SP steps at T_MEL_MAX, their
    peak memory a rank against the unsplit step's.  Returns the ranks'
    time_warp_1d launches."""
    from acvae_tpu_torch.parallel.pool import RankPool

    world = len(devices)
    it, total = ITERS_PER_EPOCH * (PAR_EPOCH - 1) + 1, ITERS_PER_EPOCH * EPOCHS
    launches = 0
    with RankPool(backend, devices) as pool:
        for encoder, names, passes in PAR_MODELS:
            cases = [(n,) + PAR_CASES[n] for n in names
                     if PAR_CASES[n][0] == 1 or world % 2 == 0]
            for dtype, held, bn64, probe, timed in passes:
                launches += _par_model_steps(
                    pool, tmp, world, label, encoder, cases, dtype,
                    make_batch(np.random.default_rng(18)), it, total,
                    held=held, bn64=bn64, probe=probe, timed=timed)
        for encoder, dtype in PAR_LONG if world % 2 == 0 else ():
            launches += _par_model_steps(   # the largest bucket: memory a rank
                pool, tmp, world, label, encoder, [("sp",) + PAR_CASES["sp"]],
                dtype, make_batch(np.random.default_rng(18), T_MEL_MAX),
                it, total, held=HELD, timed=True)
    return launches


def _par_model_steps(pool, tmp, world, label, encoder, cases, dtype, batch,
                     it, total, held, bn64=False, probe=False, timed=False):
    """``cases`` of ``encoder`` in ``dtype`` on the pool's ranks against
    the unsplit step (see :func:`parallel_steps`), both with BatchNorm in
    float64 if ``bn64`` and ``timed`` after a warm-up step; returns the
    ranks' time_warp_1d launches.  The ``held`` errors (of ``loss``,
    ``grad``, ``update``) must be within ``PAR_LIMITS``'s or
    ``PAR_DTYPES``'s limits, the others are printed; a pass holding the
    gradients also fails the averaged ones.  With ``probe`` the unsplit
    step is probed, and a float32 split takes the encoder's planted fault
    of ``PAR_FAULTS``."""
    lim = PAR_LIMITS.get((encoder, dtype), PAR_DTYPES[dtype])
    conf = par_conf(dtype, encoder)
    T = batch["feats"].shape[1]
    ref_loss, single_ms, single_peak, probes = _unsplit_reference(
        conf, batch, it, total, tmp, timed, probe=probe, bn64=bn64,
        draw_norms=encoder in PAR_DRAWN_NORMS)
    what = (f"{encoder}, T_mel {T}, {dtype} encoder"
            + (", norms drawn" if encoder in PAR_DRAWN_NORMS else "")
            + (", BatchNorm in float64" if bn64 else ""))
    print(f"parallel {label}, {what}: the unsplit step on cuda:0 loss "
          f"{ref_loss:.6f}" + (
              f", {single_ms:.1f} ms, {BATCH / single_ms * 1e3:.1f} "
              f"samples/s, peak {_gib(single_peak)} GiB" if timed else "")
          + f" ({SMI})")
    for name, pr in probes.items():
        print(f"parallel {label}, {what}: the unsplit step again, probe "
              f"{name}: loss rel {pr['loss_rel']:.3g}; gradients rel "
              f"{_rel(pr)}, elementwise worst {pr['worst']:.3g} at "
              f"{pr['at']} ({SMI})")
    step_args = (conf, PAR_VOCAB, DATA_DIM, f"{tmp}/par_state.pt", batch)
    step_kw = dict(iteration=it, epoch=PAR_EPOCH, total_iters=total,
                   reference=f"{tmp}/par_ref.pt", bn64=bn64)
    launches = 0
    for name, mp, seq in cases:
        ranks = pool.run(par_rank_step, *step_args, model_parallel=mp,
                         seq=seq, warmup=int(timed), **step_kw)
        r0 = ranks[0]
        loss = r0["metrics"]["loss"]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        grid = f"{world // mp} data x {mp} model" + (" + seq" if seq else "")
        tag = f"parallel {name} ({grid}, {what})"
        g, avg, upd = r0["grad_err"], r0["grad_err_averaged"], r0["update_err"]
        check(all(r["metrics"] == r0["metrics"] for r in ranks),
              f"{tag}: the ranks disagree")
        check(math.isfinite(loss), f"{tag}: loss {loss}")
        summed = world // mp if not seq else world
        if "loss" in held:
            check(rel <= lim["loss"], f"{tag}: loss {loss} vs the unsplit "
                                      f"{ref_loss} (rtol {lim['loss']})")
        if "grad" in held:
            check(g["rel"] <= lim["grad"], f"{tag}: gradients {g}")
            if summed > 1:   # a step that averaged would be caught
                check(avg["rel"] > lim["grad"],
                      f"{tag}: averaged gradients pass the check {avg}")
        if "update" in held:
            check(upd["rel"] <= lim["update"], f"{tag}: update {upd}")
        check(r0["seq_split"] == seq and r0["vocab_rows"] == PAR_VOCAB // mp,
              f"{tag}: not split as asked")
        check(all(r["launches"] == 1 + int(timed) for r in ranks),
              f"{tag}: time_warp_1d launches {[r['launches'] for r in ranks]} "
              f"({1 + int(timed)} steps a rank)")
        launches += sum(r["launches"] for r in ranks)
        ms = [r["ms"] for r in ranks]
        speed = (f"step ms per rank {[round(x, 1) for x in ms]} ({label}), "
                 f"{BATCH / max(ms) * 1e3:.1f} samples/s; peak GiB per rank "
                 f"{[_gib(r['peak_bytes']) for r in ranks]} against the "
                 f"unsplit {_gib(single_peak)}; " if timed else "")

        def lim_of(k):
            return f"limit {lim[k]}" if k in held else "not held"
        print(f"{tag}: loss {loss:.6f} (rel {rel:.2e}, {lim_of('loss')}); "
              f"{speed}gradients rel {_rel(g)} ({lim_of('grad')}; elementwise "
              f"worst {g['worst']:.3g} at {g['at']}, max abs "
              f"{g['max_abs']:.3g}); averaged instead of summed "
              + (f"rel {avg['rel']:.3g}" if summed > 1 else "n/a")
              + f"; update rel {_rel(upd)} ({lim_of('update')}); "
              f"time_warp_1d launches per rank "
              f"{[r['launches'] for r in ranks]} ({SMI})")
        fault = PAR_FAULTS.get(encoder)
        if seq and dtype == "float32" and probe and fault:
            faulty = pool.run(par_rank_step_faulty, fault, *step_args,
                              model_parallel=mp, seq=seq, **step_kw)[0]
            fg, fu = faulty["grad_err"], faulty["update_err"]
            check(fg["rel"] > lim["grad"] and fu["rel"] > lim["update"],
                  f"{tag}: the planted fault {fault} passes the checks: "
                  f"gradients {fg}, update {fu}")
            print(f"{tag}, {fault} (a planted fault): gradients rel "
                  f"{_rel(fg)}; update rel {_rel(fu)} ({SMI})")
    return launches


def _par_train_args(tmp):
    config = str(Path(__file__).resolve().parent / "configs" / "ac_vae.yaml")
    return [config, f"--h5_csv={tmp}/mels.csv", f"--caption_file={tmp}/text.json",
            f"--vocab_file={tmp}/vocab.pkl", f"--outputpath={tmp}",
            "--augments=[timewarp,timemask,freqmask]"]


def parallel_cli(tmp):
    """Phase 18 (b): ``cli train --distributed=true`` for one epoch on phase
    10's corpus: one card runs unsharded, D cards a worker each (NCCL).
    Returns the experiment dir and the launches in this process."""
    from acvae_tpu_torch.cli import main as cli
    D = torch.cuda.device_count()
    before = read_counts()
    t0 = time.perf_counter()
    exp = Path(cli.main(["train"] + _par_train_args(tmp) + [
        "--epochs=1", "--distributed=true", "--remark=parallel"]))
    wall = time.perf_counter() - t0
    log = (exp / "train_caption.log").read_text()
    want = ("distributed=true with a single device: running unsharded"
            if D == 1 else f"data-parallel mesh: {{'data': {D}}}")
    check(want in log, f"parallel train: the log has no {want!r}")
    (rec,) = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    check(math.isfinite(rec["train_loss"]), f"parallel train: {rec}")
    counts = {k: v - before[k] for k, v in read_counts().items()}
    print(f"parallel cli train --distributed=true on {D} card(s): {want!r}; "
          f"epoch wall {rec['epoch_wall_s']:.2f} s, command {wall:.2f} s, loss "
          f"{rec['train_loss']:.4f}; launches here {counts} ({SMI})")
    return exp, counts


def parallel_evaluate(tmp, exp):
    """Phase 18 (c): ``evaluate --distributed --encoder_int8`` against the
    plain ``evaluate --encoder_int8``: the same files, byte for byte; the
    int8 kernels' launches counted per card (1 + 7 + 3 a shard-batch on
    each card that got one, the calibration's on card 0)."""
    from acvae_tpu_torch.cli import main as cli
    fns = [kernel_fns()[k] for k in INT8_KERNELS]
    D = torch.cuda.device_count()
    files = ("eval_output_beam_3_int8.json", "scores_beam_3_int8.txt")
    out, per_card, walls = {}, {}, {}
    before_all = read_counts()
    # each twice: the first runs warm the cards up
    for dist_flag in (False, True, "warm", "warm_dist"):
        by_dev = [dict(f.launches_by_device) for f in fns]
        t0 = time.perf_counter()
        cli.main(["evaluate", str(exp), f"--eval_caption_file={tmp}/text.json",
                  "--encoder_int8",
                  f"--distributed={str(dist_flag in (True, 'warm_dist')).lower()}"])
        walls[dist_flag] = time.perf_counter() - t0
        out[dist_flag] = [(exp / f).read_bytes() for f in files]
        per_card[dist_flag] = [
            {d: n - b.get(d, 0) for d, n in f.launches_by_device.items()
             if n - b.get(d, 0)} for f, b in zip(fns, by_dev)]
    check(out[True] == out[False] == out["warm"] == out["warm_dist"],
          "evaluate --distributed --encoder_int8 wrote other files than the "
          "plain int8 evaluate")
    nb = CLI_EVAL_BATCHES
    per_nb = per_batches(CNN10_PER_BATCH, nb)
    calib = tuple(k.get(0, 0) - n for k, n in zip(per_card[False], per_nb))
    for d in range(D):
        want = tuple(n + (c if d == 0 else 0) for n, c in zip(per_nb, calib))
        got = tuple(k.get(d, 0) for k in per_card[True])
        check(got == want, f"evaluate --distributed: card {d} launched "
                           f"{got}, expected {want}")
    print(f"parallel evaluate --encoder_int8: plain {walls[False]:.2f} s "
          f"cold, {walls['warm']:.2f} s warm ({CLI_AUDIOS / walls['warm']:.1f} "
          f"captions/s of command wall), "
          f"--distributed over {D} card(s) {walls[True]:.2f} s cold, "
          f"{walls['warm_dist']:.2f} s warm "
          f"({CLI_AUDIOS / walls['warm_dist']:.1f} captions/s); files identical; "
          f"stem_conv3x3_i8/conv3x3_i8/avgpool2x2_i8 launches per card "
          f"{'/'.join(map(str, per_card[True]))} "
          f"(calibration on card 0 {calib}) ({SMI})")
    return {k: v - before_all[k] for k, v in read_counts().items()}


def parallel_phase(tmp):
    """Phase 18, parallelism: (a) 2 ranks sharing the card over gloo take a
    DP, a TP and an SP step of the full-width flagship, and an SP step with
    the PANN Cnn14 and ResNet38, against the unsplit step; (b) ``cli train
    --distributed=true``; (c) ``evaluate --distributed --encoder_int8``
    against the plain int8 evaluate; (d)
    with 2 or more cards, (a) over NCCL on all of them.  Returns the
    launches over the path (the ranks' included)."""
    reset_counts()
    launches = parallel_steps(tmp, ["cuda:0"] * 2, "gloo",
                              "gloo, 2 ranks on one card, not a speed figure")
    exp, train_counts = parallel_cli(tmp)
    eval_counts = parallel_evaluate(tmp, exp)
    if torch.cuda.device_count() >= 2:
        D = torch.cuda.device_count()
        launches += parallel_steps(tmp, [f"cuda:{i}" for i in range(D)],
                                   "nccl", f"nccl over {D} cards")
    counts = {k: train_counts[k] + eval_counts[k] for k in train_counts}
    counts["time_warp_1d"] += launches
    print(f"parallel: launches over the path {counts} ({SMI})")
    return counts


def build_phase():
    """Every CUDA source of the port, one nvcc each, all started together;
    then the conv kernels' instructions (``sass_counts``)."""
    from acvae_tpu_torch.ops.cuda.build import CSRC, build

    def one(src):
        t0 = time.perf_counter()
        log = build(src.stem)
        return src, time.perf_counter() - t0, log
    srcs = sorted(CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        for src, secs, log in pool.map(one, srcs):
            print(f"build {src.name}: {secs:.1f} s; " + " | ".join(
                line.strip() for line in log.splitlines() if "registers" in line
                or "spill" in line or "Compiling entry" in line
                or "warning" in line))
            if src.stem == "conv_i8":
                spilled = stem_spills(log)
                print(f"ptxas: the stem kernels spill {spilled} bytes")
                check(spilled == 0, f"the stem kernels spill registers: {spilled} B")
    counts = sass_counts()
    for name, c in counts.items():
        print(f"sass {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    body = counts.get("conv3x3_i8_kernel", {})
    check(body.get("IGMMA", 0) > 0 and body.get("IMMA", 0) == 0,
          f"the conv body kernel is not on wgmma (IGMMA) alone: {body}")
    check(body.get("IDP4A", 0) == 0, f"the conv body kernel still has IDP4A: {body}")
    stem = counts.get("conv3x3_c1_kernel", {})
    check(stem.get("IMMA", 0) > 0, f"the stem kernel is not on the tensor cores: {stem}")


def stem_spills(log):
    """Bytes of spill stores ptxas reports over the stem kernels
    (conv3x3_c1_kernel's instantiations) in a build log."""
    total, cur = 0, False
    for line in log.splitlines():
        if "Compiling entry" in line:
            cur = "conv3x3_c1_kernel" in line
        elif cur and "spill stores" in line:
            total += int(re.search(r"(\d+) bytes spill stores", line).group(1))
    return total


SASS_OPS = {"IGMMA": r"\bIGMMA\b", "IMMA": r"\bIMMA\b",
            "IDP4A": r"\bIDP4A\b|\bIDP\.4A\b"}


def sass_counts():
    """{kernel: {op: count}} over every instantiation of the two conv
    kernels in the built conv_i8 library (``cuobjdump -sass``)."""
    import re
    from acvae_tpu_torch.ops.cuda.build import _lib_path, _nvcc
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_lib_path("conv_i8"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = next((k for k in ("conv3x3_i8_kernel", "conv3x3_c1_kernel")
                        if k in line), None)
            counts.setdefault(cur, dict.fromkeys(SASS_OPS, 0))
        elif cur:
            for op, pat in SASS_OPS.items():
                counts[cur][op] += len(re.findall(pat, line))
    counts.pop(None, None)
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace two more train steps (phase 5's flagship "
                         "and phase 15's adverse step) and one full-width "
                         "decode batch of each serving path and of the int8 "
                         "dbs decode into DIR")
    ap.add_argument("--only", choices=["parallel"],
                    help="run phases 1, 2 and this one alone (the corpus of "
                         "phase 10 made here)")
    args = ap.parse_args()
    t0 = time.perf_counter()

    device_phase()
    torch.manual_seed(0)   # the dropouts draw from the global generator
    phase("build", build_phase)
    if args.only == "parallel":
        from acvae_tpu_torch.cli import main as cli
        with tempfile.TemporaryDirectory() as tmp:
            cli.main(["make_synthetic", tmp, "--rich",
                      f"--num_audios={CLI_AUDIOS}", "--mel_frames=1024"])
            by_path = {"parallel": phase("parallel", parallel_phase, tmp)}
        print(f"kernel launches by path {by_path}")
        print(f"chip_smoke: --only parallel {time.perf_counter() - t0:.1f} s "
              f"({SMI})")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [phase("kernels", kernel_phase, flush)]
    kernels += phase("int8 kernels", int8_kernel_phase, flush)
    kernels.append(phase("bn_relu kernel", bn_relu_kernel_phase, flush))
    kernels.append(phase("topk kernel", topk_kernel_phase, flush))
    guard_plain_fma()
    del flush
    torch.cuda.empty_cache()
    phase("parity", parity_phase)
    by_path = {"train": phase("train", train_phase, STEPS, args.profile)}
    phase("decode parity", decode_parity_phase)
    by_path["serve"] = phase("serve", serve_phase, args.profile)
    phase("int8 decode parity", int8_decode_parity_phase)
    by_path["int8_serve"] = phase("int8 serve", int8_serve_phase, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["cli"], exp = phase("cli", cli_phase, tmp)
        by_path["diverse"] = phase("diverse", diverse_phase, tmp, exp,
                                   args.profile)
        by_path["families"] = phase("families", families_phase, tmp)
        by_path["extras"] = phase("extras", extras_phase, tmp, exp)
        by_path["encoders"] = phase("encoders", encoders_phase, tmp)
        by_path["aux"] = phase("aux", aux_phase, tmp, args.profile)
        by_path["export"] = phase("export", export_phase, tmp)
        by_path["tools"] = phase("tools", tools_phase, tmp, exp)
        by_path["parallel"] = phase("parallel", parallel_phase, tmp)
    own = {"time_warp_1d": "train", "stem_conv3x3_i8": "int8_serve",
           "conv3x3_i8": "int8_serve", "avgpool2x2_i8": "int8_serve",
           "bn_relu": "serve", "topk_rows": "serve"}
    for k in kernels:
        k["launches"] = by_path[own[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: by_path[p][k["name"]] for p in PATHS}
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(f"kernel launches by path {by_path}")
    print(f"plain float64 FMAs (ops/int8.py fma_f32) on card tensors after "
          f"phase 3: {PLAIN_FMA_ON_CARD[0]}")
    check(PLAIN_FMA_ON_CARD[0] == 0, "a path ran the plain float64 FMA on the "
                                     "card (the stem's quantization is the kernel's)")
    print(f"chip_smoke: whole script {time.perf_counter() - t0:.1f} s ({SMI})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
