#!/usr/bin/env python3
"""Compare builds of the int8 conv kernels on the card, at the main path's
shapes.

    python3 tools/conv_i8_variants.py [VARIANT.cu ...]

Builds ``acvae_tpu_torch/csrc/conv_i8.cu`` (through its wrapper) and each
VARIANT (a copy of that source with one change, compiled with the same
nvcc flags into its own library in a temporary directory and called
through the same C entry point). At each of the 12 conv shapes of a batch
of 512 (``chip_smoke.py``'s Cnn10 body convs and Cnn14's five more) it
holds every build's output exactly against the plain version, then times
each with CUDA events (median of 10, L2 flushed, ``chip_smoke.time_ms``)
in the order current, variants..., variants reversed, current, so that a
drift of the card's clocks shows. Prints a line a shape, the sums, and
the card's name and power limit. Compare builds only within one run: a
shape's time moves by a few per cent between cards.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from acvae_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc  # noqa: E402
from acvae_tpu_torch.ops.cuda.conv_i8_kernel import conv3x3_i8  # noqa: E402
from acvae_tpu_torch.ops.int8 import MODES, conv3x3_i8_ref  # noqa: E402


def variant_conv(so):
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.conv3x3_i8_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]

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
    return conv


def main():
    cs.device_phase()
    builds = {"current": conv3x3_i8}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in map(Path, sys.argv[1:]):
            so = Path(tmp) / f"lib{src.stem}.so"
            procs[src.stem] = (so, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in procs.items():
            log = proc.communicate()[0]
            cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
            builds[name] = variant_conv(so)
        order = list(builds)
        flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
        g = torch.Generator("cuda").manual_seed(2)
        shapes = [(H, W, ci, co, "f32relu" if k == len(cs.CONV_SHAPES) else "sym")
                  for k, (H, W, ci, co) in enumerate(cs.CONV_SHAPES, 1)
                  if ci > 1] + cs.CNN14_CONVS
        total = dict.fromkeys(order, 0.0)
        for H, W, ci, co, mode in shapes:
            x, w, A, B = cs.conv_inputs(cs.DEC_BATCH, H, W, ci, co, g)
            ref = conv3x3_i8_ref(x, w.permute(1, 2, 3, 0), A, B, mode, 0)
            for name in order:
                err = cs.max_err(builds[name](x, w, A, B, mode, 0), ref)
                cs.check(err == 0, f"{name} disagrees at {(H, W, ci, co, mode)}: {err}")
            del ref
            ms = {name: [] for name in order}
            for name in order + order[::-1]:
                ms[name].append(cs.time_ms(
                    lambda: builds[name](x, w, A, B, mode, 0), flush, reps=10))
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
