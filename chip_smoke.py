#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``acvae_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits nonzero on failure:

1. device: a CUDA card is required (no CPU fallback); TF32 is turned off for
   matmuls and cuDNN; prints the card's name and power limit.
2. build: compiles every CUDA source of the port, one nvcc each, all
   started together; counts the tensor-core MMAs (``IGMMA``/``IMMA``) and
   ``IDP4A`` in each conv kernel's SASS (``cuobjdump -sass``) and fails if
   the conv body has no MMA or any ``IDP4A``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases; times the kernel, the plain
   version and the library call that computes the same function with CUDA
   events (median, L2 flushed).  ``time_warp_1d``: max |error| <= 1e-6.
   ``conv3x3_i8`` (every conv of the int8 encoder at batch 512, block 1's
   2^31-element tensors included, and the ragged edges of its tiles) and
   ``avgpool2x2_i8`` (its 3 pools): max |error| 0, and each beside cuDNN's
   bf16 ``conv2d``/``avg_pool2d`` at the same shapes, channels-last, and
   each body conv beside ``torch._int_mm`` of its im2col (labelled
   comparisons, not the same function); the body (7 convs) and the stem
   reported apart.
4. parity: one small train step on the card against the same step on the
   CPU (plain versions), same weights and draws.
5. train: the train path — ``Trainer`` on the flagship recipe at full
   width (Cnn10 64->512 in bf16, embed/hidden 512, vocab 4981, batch 32,
   T_mel 1024 ragged, F 64, L 22) with ``augments: [timewarp, timemask,
   freqmask]`` for 5 steps on seeded random batches; every metric
   finite; each kernel launched on that path.
6. decode parity: a small flagship's beam-3 and greedy decodes on the card
   against the CPU (same weights and prior noise): tokens identical,
   scores within rtol 1e-4; ``beam_topk``'s tie order on the card.
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
   peak memory, and 8 ``conv3x3_i8`` + 3 ``avgpool2x2_i8`` launches a batch;
   (b) ``CaptionService(encoder_int8=True)`` behind ``run_server`` over
   HTTP as in phase 7, its launches counted against its batches.

Kernel launches are counted from 0 over each path (train, serve, int8
serve).  Prints a ``{"kernels": [...]}`` JSON line (``launches`` on each
kernel's own path, ``launches_by_path`` on all three), then, last, the
``{"ok": true, "device": ...}`` line.  ``--profile DIR`` also traces two
more train steps and one full-width decode batch of each serving path with
torch.profiler and writes the traces and op tables into DIR.
"""
import argparse
import concurrent.futures
import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
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
PATHS = ("train", "serve", "int8_serve")


def kernel_fns():
    """Every kernel wrapper of the port, by kernel name."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import avgpool2x2_i8, conv3x3_i8
    from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d
    return {"time_warp_1d": time_warp_1d, "conv3x3_i8": conv3x3_i8,
            "avgpool2x2_i8": avgpool2x2_i8}


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])


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
    # the stem's tile (512 pixels of rows of at most 128 columns)
    (2, 5, 200, 1, 64, "offset", -128), (2, 13, 7, 1, 192, "f32", -128),
    (1, 9, 33, 1, 512, "sym", -128), (2, 1, 1, 1, 64, "f32", 0)]
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


def int8_kernel_phase(flush):
    """conv3x3_i8 and avgpool2x2_i8 against their plain versions: every
    shape of a batch of 512 and the edge cases, max |err| 0; times summed
    over a batch's 7 body convs, its stem and its 3 pools."""
    from acvae_tpu_torch.ops.cuda.conv_i8_kernel import avgpool2x2_i8, conv3x3_i8
    from acvae_tpu_torch.ops.int8 import avgpool2x2_i8_ref, conv3x3_i8_ref

    F = torch.nn.functional
    g = torch.Generator("cuda").manual_seed(2)
    part = {k: dict(ms=0.0, plain=0.0, bound=0.0, bf16=0.0, int_mm=0.0, ops=0.0,
                    by={"operations": 0.0, "bytes": 0.0}, convs=0)
            for k in ("body", "stem")}
    err_all = 0.0
    for k, (H, W, ci, co) in enumerate(CONV_SHAPES, 1):
        mode = "f32relu" if k == len(CONV_SHAPES) else "sym"
        x, w, A, B = conv_inputs(DEC_BATCH, H, W, ci, co, g)
        w_hwio = w.permute(1, 2, 3, 0)
        out = conv3x3_i8(x, w, A, B, mode, 0)
        torch.cuda.synchronize()
        err = max_err(out, conv3x3_i8_ref(x, w_hwio, A, B, mode, 0))
        check(err == 0, f"conv3x3_i8 disagrees with its plain version at "
                        f"[{DEC_BATCH},{H},{W},{ci}]->{co} {mode}: {err}")
        err_all = max(err_all, err)
        del out
        k_ms = time_ms(lambda: conv3x3_i8(x, w, A, B, mode, 0), flush)
        p_ms = time_ms(lambda: conv3x3_i8_ref(x, w_hwio, A, B, mode, 0), flush,
                       reps=2)
        mm = ""
        c = part["stem" if ci == 1 else "body"]
        if ci > 1:
            i_ms, n = int_mm_ms(x, w, flush)
            c["int_mm"] += i_ms
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
              f"{k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s), plain {p_ms:.4f} "
              f"ms, bf16 cuDNN conv2d {l_ms:.4f} ms (not the same function)"
              f"{mm}, bound {b_ms:.4f} ms ({by}); max_abs_err {err}")
        c["ms"] += k_ms
        c["plain"] += p_ms
        c["bound"] += b_ms
        c["by"][by] += b_ms
        c["bf16"] += l_ms
        c["ops"] += ops
        c["convs"] += 1
    pool = dict(ms=0.0, plain=0.0, bound=0.0, bf16=0.0, err=0.0)
    for H, W, C in POOL_SHAPES:
        x = torch.randint(-128, 128, (DEC_BATCH, H, W, C), dtype=torch.int8,
                          device="cuda", generator=g)
        err = max_err(avgpool2x2_i8(x), avgpool2x2_i8_ref(x))
        check(err == 0, f"avgpool2x2_i8 disagrees with its plain version at "
                        f"[{DEC_BATCH},{H},{W},{C}]: {err}")
        pool["err"] = max(pool["err"], err)
        k_ms = time_ms(lambda: avgpool2x2_i8(x), flush)
        p_ms = time_ms(lambda: avgpool2x2_i8_ref(x), flush, reps=10)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        l_ms = time_ms(lambda: F.avg_pool2d(xb, 2), flush)
        del xb
        b_ms, _ = bound(0, DEC_BATCH * H * W * C * 5 // 4, INT8_OPS)
        print(f"avgpool2x2_i8 [{DEC_BATCH},{H},{W},{C}]: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bf16 cuDNN avg_pool2d {l_ms:.4f} ms (not "
              f"the same function), bound {b_ms:.4f} ms (bytes); max_abs_err {err}")
        pool["ms"] += k_ms
        pool["plain"] += p_ms
        pool["bound"] += b_ms
        pool["bf16"] += l_ms
    del x
    for n, H, W, ci, co, mode, pad in CONV_EDGES:
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
    for name, c in part.items():
        c["bound_by"] = max(c["by"], key=c["by"].get)
        print(f"int8 kernels, a batch of {DEC_BATCH}: conv3x3_i8 {name} "
              f"({c['convs']} convs) {c['ms']:.3f} ms ({c['ops'] / c['ms'] / 1e9:.1f} "
              f"TOP/s; plain {c['plain']:.1f}, bf16 cuDNN {c['bf16']:.3f}, "
              + (f"_int_mm {c['int_mm']:.3f}, " if name == "body" else "")
              + f"bound {c['bound']:.3f} ({c['bound_by']}))")
    conv = {k: sum(c[k] for c in part.values())
            for k in ("ms", "plain", "bound", "bf16")}
    by = {k: sum(c["by"][k] for c in part.values()) for k in ("operations", "bytes")}
    print(f"int8 kernels, a batch of {DEC_BATCH}: 8 conv3x3_i8 {conv['ms']:.3f} ms "
          f"(plain {conv['plain']:.1f}, bf16 cuDNN {conv['bf16']:.3f}, bound "
          f"{conv['bound']:.3f}); 3 avgpool2x2_i8 {pool['ms']:.3f} ms (plain "
          f"{pool['plain']:.3f}, bf16 cuDNN {pool['bf16']:.3f}, bound "
          f"{pool['bound']:.3f})")
    common = {"route": "cuda", "source": "acvae_tpu_torch/csrc/conv_i8.cu",
              "launches": None, "library_ms": None}
    split = {name: {"convs": c["convs"], "ms": c["ms"], "plain_ms": c["plain"],
                    "bound_ms": c["bound"], "bound_by": c["bound_by"],
                    "tops": c["ops"] / c["ms"] / 1e9, "bf16_cudnn_ms": c["bf16"],
                    "int_mm_ms": c["int_mm"] if name == "body" else None}
             for name, c in part.items()}
    return [dict(common, name="conv3x3_i8",
                 replaces="acvae_tpu/models/quant.py:424",
                 max_abs_err=err_all, ms=conv["ms"], plain_ms=conv["plain"],
                 bound_ms=conv["bound"], bound_by=max(by, key=by.get),
                 bf16_cudnn_ms=conv["bf16"], timed=f"8 convs of a batch of {DEC_BATCH}",
                 **split),
            dict(common, name="avgpool2x2_i8",
                 replaces="acvae_tpu/models/quant.py:86",
                 max_abs_err=pool["err"], ms=pool["ms"], plain_ms=pool["plain"],
                 bound_ms=pool["bound"], bound_by="bytes",
                 bf16_cudnn_ms=pool["bf16"], timed=f"3 pools of a batch of {DEC_BATCH}")]


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


def parity_phase():
    """One small step on the card (kernels) and on the CPU (plain
    versions) from the same weights and draws: metrics within rtol 1e-3."""
    from acvae_tpu_torch.ops.specaug import draw_span
    from acvae_tpu_torch.ops.warp import draw_anchors
    from acvae_tpu_torch.train.trainer import Trainer

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


def make_batch(rng):
    lens = rng.integers(T_MEL // 2, T_MEL + 1, size=BATCH).astype(np.int32)
    lens[0] = T_MEL
    feats = rng.normal(size=(BATCH, T_MEL, DATA_DIM)).astype(np.float32)
    feats[np.arange(T_MEL)[None, :] >= lens[:, None]] = 0.0
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
    print(f"train: step ms median {statistics.median(step_ms):.1f} "
          f"(first {step_ms[0]:.1f}, steps 2-{steps} "
          f"{statistics.median(step_ms[1:] or step_ms):.1f}); "
          f"peak memory {peak / 2**30:.3f} GiB; launches {counts}")
    check(counts["time_warp_1d"] == steps,
          f"time_warp_1d launched {counts['time_warp_1d']} times in "
          f"{steps} steps (expected {steps})")
    if profile_dir:
        profile_steps(trainer, rng, it0 + steps, epoch, step_ms, profile_dir)
    return counts


RANGES = ("augment", "forward", "encoder", "posterior", "decode_loop",
          "backward", "optimizer")


def profile_steps(trainer, rng, it, epoch, step_ms, out_dir):
    """Trace two more steps; split device (kernel) time by the trainer's
    record_function ranges.  Backward ops run on autograd's thread, outside
    the "backward" range, so backward = all kernels - the other phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    batches = [make_batch(rng) for _ in range(2)]
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
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    (out / "profile_train_step.txt").write_text(table)
    prof.export_chrome_trace(str(out / "trace_train_step.json"))
    wall = statistics.median(step_ms[1:] or step_ms)
    print(f"profile: kernel time per step {kernel_ms:.2f} ms vs step wall "
          f"{wall:.2f} ms (unprofiled): device busy share {kernel_ms / wall:.3f}")
    print("profile: kernel ms per step by phase " + json.dumps(
        {k: round(v, 3) for k, v in by_range.items()}))
    print("profile: device-timeline span ms per step by phase " + json.dumps(
        {k: round(v, 3) for k, v in spans.items()}))
    print("\n".join(table.splitlines()[:24]))


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
        beam_topk_times()
        if profile_dir:
            profile_decode(decode, profile_dir, "decode")
        del model, decode
        torch.cuda.empty_cache()
        http = http_checks(exp)
    return {k: counts[k] + http[k] for k in counts}


BEAM_KW = dict(decode_method="beam", beam_size=BEAM, max_length=MAX_LEN)


def decode_rate(tag, decode, encode, model, vocab):
    """(a) One warm-up batch, then DEC_TIMED timed batches of ``decode(feats,
    lens, generator)``, each ending in a synchronise; outputs checked after
    the timing; then one more batch split into ``encode`` and the beam
    search.  Returns the kernel launches of the 1 + DEC_TIMED batches."""
    g = torch.Generator("cuda").manual_seed(11)
    feats = torch.randn((DEC_BATCH, T_MEL, DATA_DIM), generator=g, device="cuda")
    lens = torch.full((DEC_BATCH,), T_MEL, device="cuda")
    kw = BEAM_KW
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
    for out in outs:
        seqs, scores = out["seqs"], out["scores"]
        check(tuple(seqs.shape) == (DEC_BATCH, BEAM, MAX_LEN)
              and seqs.dtype == torch.long, f"seqs {seqs.shape} {seqs.dtype}")
        check(bool(((seqs >= 0) & (seqs < VOCAB)).all()), "a token outside the vocab")
        check(bool(torch.isfinite(scores).all()), "a non-finite beam score")
        check(bool((scores[:, 1:] <= scores[:, :-1]).all()),
              "beam scores not in descending order")
    timed = ms[1:]
    rate = DEC_BATCH * DEC_TIMED / (sum(timed) / 1e3)
    print(f"{tag}: batch {DEC_BATCH}, beam {BEAM}, T_mel {T_MEL}, "
          f"max_length {MAX_LEN}: {rate:.1f} captions/s; batch ms p50 "
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
    print(f"{tag} split: encoder {(t1 - t0) * 1e3:.1f} ms, beam search "
          f"{(t2 - t1) * 1e3:.1f} ms ({MAX_LEN} steps)")
    return counts, feats, lens


def beam_topk_times():
    """The stable-sort top-k of a beam step against torch.topk."""
    from acvae_tpu_torch.decoding.beam import beam_topk

    g = torch.Generator("cuda").manual_seed(13)
    total = torch.randn((DEC_BATCH, BEAM, VOCAB), generator=g, device="cuda")
    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    s_ms = time_ms(lambda: beam_topk(total, BEAM), flush)
    k_ms = time_ms(lambda: torch.topk(total.view(DEC_BATCH, -1), BEAM), flush)
    print(f"beam_topk [{DEC_BATCH},{BEAM},{VOCAB}]: stable sort {s_ms:.4f} ms "
          f"per step; torch.topk {k_ms:.4f} ms (not used: tie order)")


def _http(url, data=None, headers=None):
    """(status, JSON reply) of one request."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_checks(exp, tag="serve", **svc_kw):
    """(b) CaptionService at the CLI defaults (and ``svc_kw``) behind
    run_server: one request of each kind, one malformed, then a burst of 16
    concurrent mels.  Returns the kernel launches of the service's life."""
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
    want = (8 * batches, 3 * batches) if svc.quant is not None else (0, 0)
    got = (counts["conv3x3_i8"], counts["avgpool2x2_i8"])
    print(f"{tag}: launches over the service's {batches} batches {counts}")
    check(got == want, f"{tag}: conv3x3_i8/avgpool2x2_i8 launched {got} times "
                       f"in {batches} batches (expected {want})")
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
        check(counts["conv3x3_i8"] == 8 * batches
              and counts["avgpool2x2_i8"] == 3 * batches
              and counts["time_warp_1d"] == 0,
              f"int8 serve: launches {counts} in {batches} batches (expected "
              f"8 conv3x3_i8 and 3 avgpool2x2_i8 a batch)")
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
                or "spill" in line or "Compiling entry" in line))
    counts = sass_counts()
    for name, c in counts.items():
        print(f"sass {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    body = counts.get("conv3x3_i8_kernel", {})
    check(body.get("IGMMA", 0) + body.get("IMMA", 0) > 0,
          f"the conv body kernel has no tensor-core MMA: {body}")
    check(body.get("IDP4A", 0) == 0, f"the conv body kernel still has IDP4A: {body}")


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
                    help="trace two more train steps and one full-width "
                         "decode batch into DIR")
    args = ap.parse_args()

    device_phase()
    torch.manual_seed(0)   # the dropouts draw from the global generator
    phase("build", build_phase)
    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [phase("kernels", kernel_phase, flush)]
    kernels += phase("int8 kernels", int8_kernel_phase, flush)
    del flush
    torch.cuda.empty_cache()
    phase("parity", parity_phase)
    by_path = {"train": phase("train", train_phase, STEPS, args.profile)}
    phase("decode parity", decode_parity_phase)
    by_path["serve"] = phase("serve", serve_phase, args.profile)
    phase("int8 decode parity", int8_decode_parity_phase)
    by_path["int8_serve"] = phase("int8 serve", int8_serve_phase, args.profile)
    own = {"time_warp_1d": "train", "conv3x3_i8": "int8_serve",
           "avgpool2x2_i8": "int8_serve"}
    for k in kernels:
        k["launches"] = by_path[own[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: by_path[p][k["name"]] for p in PATHS}
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(f"kernel launches by path {by_path}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
