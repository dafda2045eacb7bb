#!/usr/bin/env python3
"""Compare builds of the int8 conv kernels on the card, at the main path's
shapes.

    python3 tools/conv_i8_variants.py [--only stem|body] [VARIANT.cu ...]

Builds ``acvae_tpu_torch/csrc/conv_i8.cu`` (through its wrappers) and each
VARIANT (a copy of that source with one change, compiled with the same
nvcc flags into its own library in a temporary directory and called
through the same C entry points). At the fused stem of a batch of 512
([512, 1024, 64] f32 -> 64 channels, sym and offset codes) and at each of
the 12 conv shapes of such a batch (``chip_smoke.py``'s Cnn10 body convs
and Cnn14's five more) it holds every build's output exactly against the
plain version (the stem's codes too), then times each with CUDA events
(median of 10, L2 flushed, ``chip_smoke.time_ms``) in the order current,
variants..., variants reversed, current, so that a drift of the card's
clocks shows. Prints a line a shape, the sums, and the card's name and
power limit. Compare builds only within one run: a shape's time moves by
a few per cent between cards.
"""
import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from acvae_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc, build  # noqa: E402
from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (  # noqa: E402
    conv3x3_i8, stem_conv3x3_i8)
from acvae_tpu_torch.ops.int8 import MODES, conv3x3_i8_ref, stem_codes  # noqa: E402


def variant_fns(so):
    """(conv, stem) of a variant library, called as the wrappers are."""
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.conv3x3_i8_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.stem_conv3x3_i8_launch.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, p]

    def conv(x, w, A, B, mode, pad):
        N, H, W, Ci = x.shape
        Co = w.shape[0]
        out = torch.empty((N, H, W, Co), device="cuda", dtype=torch.int8
                          if mode in ("sym", "offset") else torch.float32)
        err = lib.conv3x3_i8_launch(
            x.data_ptr(), w.data_ptr(), A.data_ptr(), B.data_ptr(),
            out.data_ptr(), N, H, W, Ci, Co, MODES.index(mode), pad,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{so.name}: cudaError {err}")
        return out

    def stem(feats, c1, c2, w, A, B, mode, codes=False):
        N, T, F = feats.shape
        Co = w.shape[0]
        out = torch.empty((N, T, F, Co), device="cuda", dtype=torch.int8
                          if mode in ("sym", "offset") else torch.float32)
        q = torch.empty((N, T, F, 1) if codes else (0,), device="cuda",
                        dtype=torch.int8)
        err = lib.stem_conv3x3_i8_launch(
            feats.data_ptr(), c1.data_ptr(), c2.data_ptr(), w.data_ptr(),
            A.data_ptr(), B.data_ptr(), out.data_ptr(),
            q.data_ptr() if codes else None, N, T, F, Co, MODES.index(mode),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{so.name}: cudaError {err}")
        return out, q
    return conv, stem


def ptxas_summary(log):
    """The registers and spills ptxas reports for each stem kernel."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*conv3x3_c1_kernelILi(\d)E(\w)", line)
        if m:
            name = f"stem<{m.group(1)},{'f32' if m.group(2) == 'f' else 'i8'}>"
        elif name and "spill" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            out.append(f"{name} {re.search(r'Used (\d+) registers', line).group(1)} "
                       f"registers, {spill} B spilled")
            name = None
    return "; ".join(out)


def compare(builds, name, call, err_of, flush):
    """Check every build exactly (``err_of(fns)``: its max |err|), then time
    ``call(fns)`` of each in the order current, variants..., reversed:
    {build: [ms, ms]}."""
    for b, fns in builds.items():
        err = err_of(fns)
        cs.check(err == 0, f"{b} disagrees at {name}: {err}")
    order = list(builds)
    ms = {b: [] for b in order}
    for b in order + order[::-1]:
        ms[b].append(cs.time_ms(lambda: call(builds[b]), flush, reps=10))
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["stem", "body"])
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    cs.device_phase()
    print(f"ptxas current: {ptxas_summary(build('conv_i8'))}")
    builds = {"current": (conv3x3_i8, stem_conv3x3_i8)}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in map(Path, args.variants):
            so = Path(tmp) / f"lib{src.stem}.so"
            procs[src.stem] = (so, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in procs.items():
            log = proc.communicate()[0]
            cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
            print(f"ptxas {name}: {ptxas_summary(log)}")
            builds[name] = variant_fns(so)
        order = list(builds)
        flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
        g = torch.Generator("cuda").manual_seed(2)
        if args.only != "body":
            N, T, F = cs.DEC_BATCH, cs.T_MEL, cs.DATA_DIM
            feats, c1, c2, w, A, B = cs.stem_inputs(N, T, F, 64, g)
            codes = stem_codes(feats, c1, c2)
            # the f32 mel read once, the int8 output written once
            b_ms, by = cs.bound(2.0 * N * T * F * 9 * 64, N * T * F * (4 + 64), cs.INT8_OPS)
            for mode in ("sym", "offset"):
                ref = conv3x3_i8_ref(codes, w.permute(1, 2, 3, 0), A, B, mode, 0)

                def err_of(fns):
                    out, q = fns[1](feats, c1, c2, w, A, B, mode, True)
                    return max(cs.max_err(out, ref), int((q != codes).sum()))
                ms = compare(builds, f"the stem {mode}",
                             lambda fns: fns[1](feats, c1, c2, w, A, B, mode),
                             err_of, flush)
                del ref
                print(f"stem [{N},{T},{F}] f32 -> 64 {mode}, bound {b_ms:.4f} ms "
                      f"({by}): " + "; ".join(
                          f"{b} {x:.4f}/{y:.4f} ms ({b_ms / min(x, y):.1%})"
                          for b, (x, y) in ms.items()), flush=True)
            del feats, codes
            # the card's rate for a plain write of the stem's output bytes
            out = torch.empty((N, T, F, 64), dtype=torch.int8, device="cuda")
            f_ms = cs.time_ms(lambda: out.fill_(1), flush, reps=10)
            print(f"fill_ of the stem's int8 output [{N},{T},{F},64]: {f_ms:.4f} ms "
                  f"({out.numel() / f_ms / 1e9:.3f} TB/s)")
            del out
        if args.only == "stem":
            print(f"({cs.SMI})")
            return
        shapes = [(H, W, ci, co, "f32relu" if k == len(cs.CONV_SHAPES) else "sym")
                  for k, (H, W, ci, co) in enumerate(cs.CONV_SHAPES, 1)
                  if ci > 1] + cs.CNN14_CONVS
        total = dict.fromkeys(order, 0.0)
        for H, W, ci, co, mode in shapes:
            x, w, A, B = cs.conv_inputs(cs.DEC_BATCH, H, W, ci, co, g)
            ref = conv3x3_i8_ref(x, w.permute(1, 2, 3, 0), A, B, mode, 0)
            ms = compare(builds, (H, W, ci, co, mode),
                         lambda fns: fns[0](x, w, A, B, mode, 0),
                         lambda fns: cs.max_err(fns[0](x, w, A, B, mode, 0), ref), flush)
            del ref
            ops = 2.0 * cs.DEC_BATCH * H * W * 9 * ci * co
            nbytes = (cs.DEC_BATCH * H * W * (ci + co * (4 if mode == "f32relu" else 1))
                      + 9 * ci * co + 8 * co)
            b_ms, by = cs.bound(ops, nbytes, cs.INT8_OPS)
            for name in order:
                total[name] += min(ms[name])
            print(f"[{cs.DEC_BATCH},{H},{W},{ci}]->{co} {mode}, bound {b_ms:.4f} ms "
                  f"({by}): " + "; ".join(
                      f"{name} {a:.4f}/{b:.4f} ms ({b_ms / min(a, b):.1%})"
                      for name, (a, b) in ms.items()), flush=True)
            del x
    print("sums of the better of each pair: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in total.items()) + f" ({cs.SMI})")


if __name__ == "__main__":
    main()
