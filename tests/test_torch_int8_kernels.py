"""The int8 serving encoder's kernel wrappers (``ops/cuda/conv_i8_kernel.py``).

On the CPU each wrapper runs its plain version and never builds or launches
a kernel.  The tests marked ``cuda`` hold each kernel against its plain
version on a card; without one they skip.  This file imports no JAX, so on
a machine with a card it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_kernels.py
"""
import numpy as np
import pytest
import torch

from acvae_tpu_torch.ops.cuda import build as tbuild
from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (avgpool2x2_i8, conv3x3_i8,
                                                     pack_conv3x3_weight)
from acvae_tpu_torch.ops.int8 import avgpool2x2_i8_ref, conv3x3_i8_ref


def conv_case(ci, co, big, seed):
    """(codes, HWIO weights, A, B) of one small conv [2, 9, 7, ci] -> co;
    with ``big`` the accumulators pass 2^24."""
    rng = np.random.default_rng(seed)
    Nc, H, W = 2, 9, 7
    if big:  # one-signed codes and weights: |acc| passes 2^24 and rounds
        x = rng.integers(-128, -100, size=(Nc, H, W, ci)).astype(np.int8)
        w = rng.integers(-127, -100, size=(3, 3, ci, co)).astype(np.int8)
    else:
        x = rng.integers(-128, 128, size=(Nc, H, W, ci)).astype(np.int8)
        w = rng.integers(-127, 128, size=(3, 3, ci, co)).astype(np.int8)
    acc_scale = np.sqrt(9 * ci) * 73.0 * 73.0 if not big else 9 * ci * 1.3e4
    A = (rng.uniform(0.5, 1.5, size=co) * 40 / acc_scale).astype(np.float32)
    B = (rng.normal(size=co) * 20).astype(np.float32)
    return x, w, A, B


# --------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------- #
def test_wrappers_run_their_plain_versions_on_the_cpu():
    x, w, A, B = conv_case(8, 16, False, seed=3)
    x, w, A, B = (torch.tensor(a) for a in (x, w, A, B))
    before = (conv3x3_i8.launches, avgpool2x2_i8.launches)
    for mode, pad in (("sym", 0), ("offset", -128), ("f32relu", 0)):
        assert torch.equal(conv3x3_i8(x, pack_conv3x3_weight(w), A, B, mode, pad),
                           conv3x3_i8_ref(x, w, A, B, mode, pad))
    assert torch.equal(avgpool2x2_i8(x), avgpool2x2_i8_ref(x))
    assert (conv3x3_i8.launches, avgpool2x2_i8.launches) == before
    assert "conv_i8" not in tbuild._LIBS
    assert pack_conv3x3_weight(w).shape == (16, 3, 3, 8)


def test_wrappers_check_inputs():
    x, w, A, B = (torch.tensor(a) for a in conv_case(8, 16, False, seed=4))
    wk = pack_conv3x3_weight(w)
    with pytest.raises(TypeError):
        conv3x3_i8(x.int(), wk, A, B, "sym")
    with pytest.raises(TypeError):
        conv3x3_i8(x, wk, A.double(), B, "sym")
    with pytest.raises(ValueError, match="mode"):
        conv3x3_i8(x, wk, A, B, "relu")
    with pytest.raises(ValueError):
        conv3x3_i8(x[..., :4], wk, A, B, "sym")
    with pytest.raises(ValueError, match="pad_code"):
        conv3x3_i8(x, wk, A, B, "sym", 300)
    meta = [t.to("meta") for t in (x, wk, A, B)]
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_i8(*meta, "sym")                      # no silent path
    with pytest.raises(TypeError):
        avgpool2x2_i8(x.float())
    with pytest.raises(ValueError, match="unsupported device"):
        avgpool2x2_i8(meta[0])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the kernels have no CPU "
                    "mode; chip_smoke.py checks them on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co,mode,pad", [
    (1, 64, "sym", 0), (64, 64, "offset", -128), (128, 192, "f32relu", 0),
    (64, 64, "f32", -128)])
def test_conv3x3_i8_kernel_matches_plain(card, ci, co, mode, pad):
    x, w, A, B = (torch.tensor(a).cuda() for a in conv_case(ci, co, False, seed=6))
    before = conv3x3_i8.launches
    out = conv3x3_i8(x, pack_conv3x3_weight(w), A, B, mode, pad)
    assert conv3x3_i8.launches == before + 1
    assert torch.equal(out, conv3x3_i8_ref(x, w, A, B, mode, pad))


# the kernels' tiles' ragged cases (chip_smoke.py's CONV_EDGES): H*W not a
# multiple of the body's 128-pixel tile, W above and below its width, Co =
# 192 against a 128-channel tile, Ci = 192 against the 3-stage pipeline, the
# stem's tile edges; every mode, pad -128 (N, H, W, Ci, Co, mode, pad)
TILE_EDGES = [
    (2, 11, 10, 64, 128, "sym", 0), (2, 3, 150, 64, 128, "offset", -128),
    (1, 5, 129, 64, 64, "f32", -128), (2, 40, 3, 64, 128, "f32relu", -128),
    (2, 20, 16, 64, 192, "sym", -128), (2, 9, 70, 128, 192, "offset", 0),
    (2, 17, 24, 192, 128, "f32", -128), (2, 8, 8, 192, 64, "sym", 0),
    (2, 5, 200, 1, 64, "offset", -128), (2, 13, 7, 1, 192, "f32", -128),
    (1, 9, 33, 1, 512, "sym", -128), (2, 1, 1, 1, 64, "f32", 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,ci,co,mode,pad", TILE_EDGES)
def test_conv3x3_i8_kernel_tile_edges(card, n, h, w, ci, co, mode, pad):
    rng = np.random.default_rng(h * w + ci)
    x = torch.tensor(rng.integers(-128, 128, size=(n, h, w, ci)).astype(np.int8))
    wt = torch.tensor(rng.integers(-127, 128, size=(3, 3, ci, co)).astype(np.int8))
    A = torch.tensor((rng.uniform(0.5, 1.5, size=co) * 40
                      / (np.sqrt(9 * ci) * 73.0 * 73.0)).astype(np.float32))
    B = torch.tensor((rng.normal(size=co) * 20).astype(np.float32))
    x, wt, A, B = (t.cuda() for t in (x, wt, A, B))
    out = conv3x3_i8(x, pack_conv3x3_weight(wt), A, B, mode, pad)
    assert torch.equal(out, conv3x3_i8_ref(x, wt, A, B, mode, pad))


@pytest.mark.cuda
def test_avgpool2x2_i8_kernel_matches_plain(card):
    x = torch.randint(-128, 128, (3, 11, 9, 64), dtype=torch.int8, device="cuda")
    assert torch.equal(avgpool2x2_i8(x), avgpool2x2_i8_ref(x))
