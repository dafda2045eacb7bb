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
                                                     pack_conv3x3_weight,
                                                     stem_conv3x3_i8)
from acvae_tpu_torch.ops.int8 import (MODES, avgpool2x2_i8_ref, conv3x3_i8_ref,
                                      fma_f32, quant_stem, requantize_ref,
                                      stem_codes, stem_coeffs)


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


def stem_case(n, t, f, co, seed):
    """(feats [n, t, f], c1, c2 [f], OHWI weights [co, 3, 3, 1], A, B) of the
    fused stem: a mel on a grid of 1/4, and bins whose c1, c2 (1, 2, 4, 1/2
    and 1/2, 1/4, -1/2, 3/2) put some feats·c1 + c2 on ties."""
    rng = np.random.default_rng(seed)
    feats = (np.round(rng.normal(size=(n, t, f)) * 24) / 4).astype(np.float32)
    c1 = rng.uniform(5, 35, size=f).astype(np.float32)
    c2 = (rng.normal(size=f) * 10).astype(np.float32)
    k = min(f, 4)
    c1[:k], c2[:k] = [1.0, 2.0, 4.0, 0.5][:k], [0.5, 0.25, -0.5, 1.5][:k]
    w = rng.integers(-127, 128, size=(co, 3, 3, 1)).astype(np.int8)
    A = (rng.uniform(0.5, 1.5, size=co) * 40 / (3 * 73.0 * 73.0)).astype(np.float32)
    B = (rng.normal(size=co) * 20).astype(np.float32)
    return tuple(torch.tensor(a) for a in (feats, c1, c2, w, A, B))


def stem_plain(feats, c1, c2, w, A, B, mode):
    """The fused stem's plain version, spelled out: the codes, then the
    conv of the codes with SAME (code 0) padding."""
    codes = stem_codes(feats, c1, c2)
    return conv3x3_i8_ref(codes, w.permute(1, 2, 3, 0), A, B, mode, 0), codes


@pytest.mark.parametrize("mode", MODES)
def test_stem_wrapper_runs_its_plain_version_on_the_cpu(mode):
    feats, c1, c2, w, A, B = stem_case(2, 9, 7, 64, seed=5)
    before = stem_conv3x3_i8.launches
    out, codes = stem_conv3x3_i8(feats, c1, c2, w, A, B, mode, codes=True)
    want_out, want_codes = stem_plain(feats, c1, c2, w, A, B, mode)
    assert torch.equal(out, want_out) and torch.equal(codes, want_codes)
    assert codes.shape == (2, 9, 7, 1) and codes.dtype == torch.int8
    out2, none = stem_conv3x3_i8(feats, c1, c2, w, A, B, mode)
    assert torch.equal(out2, out) and none.numel() == 0
    assert stem_conv3x3_i8.launches == before
    assert "conv_i8" not in tbuild._LIBS


def test_stem_codes_equal_quant_stem():
    """``quant_stem`` is ``stem_codes`` of ``stem_coeffs``: bn0 over the
    stem's scale, one multiply-add, the clip at ±127 reached."""
    rng = np.random.default_rng(6)
    feats = torch.tensor((rng.normal(size=(2, 30, 16)) * 40).astype(np.float32))
    s0 = torch.tensor(rng.uniform(0.2, 2.0, size=16).astype(np.float32))
    b0 = torch.tensor(rng.normal(size=16).astype(np.float32))
    c1, c2 = stem_coeffs(s0, b0, np.float32(0.043))
    codes = stem_codes(feats, c1, c2)
    assert torch.equal(codes, quant_stem(feats, s0, b0, np.float32(0.043)))
    assert codes.min() == -127 and codes.max() == 127
    assert torch.equal(c1, s0 / torch.tensor(0.043, dtype=torch.float32))


def _stem_args():
    return stem_case(2, 9, 7, 64, seed=7)


@pytest.mark.parametrize("change,error,match", [
    (lambda a: (a[0].double(),) + a[1:], TypeError, "float32"),
    (lambda a: a[:1] + (a[1].half(),) + a[2:], TypeError, "float32"),
    (lambda a: a[:4] + (a[4].double(), a[5]), TypeError, "float32"),
    (lambda a: a[:3] + (a[3].int(),) + a[4:], TypeError, "int8 weights"),
    (lambda a: (a[0][..., None],) + a[1:], ValueError, "feats"),
    (lambda a: a[:3] + (a[3].expand(64, 3, 3, 2).contiguous(),) + a[4:], ValueError,
     r"\[Co,3,3,1\]"),
    (lambda a: a[:1] + (a[1][:6],) + a[2:], ValueError, "c1"),
    (lambda a: a[:4] + (a[4][:32], a[5]), ValueError, "A"),
    (lambda a: tuple(t.to("meta") for t in a), ValueError, "unsupported device"),
], ids=["feats_f64", "c1_f16", "A_f64", "w_int32", "feats_4d", "w_two_lanes",
        "c1_short", "A_short", "meta"])
def test_stem_wrapper_checks_inputs(change, error, match):
    with pytest.raises(error, match=match):
        stem_conv3x3_i8(*change(_stem_args()), "sym")


def test_stem_wrapper_checks_mode():
    with pytest.raises(ValueError, match="mode"):
        stem_conv3x3_i8(*_stem_args(), "relu")


def border_class_conv(x, w_hwio, pad):
    """The conv body's arithmetic for a nonzero pad code: the int accumulators
    of the zero-filled conv (what its TMA loads read outside the image), plus
    pad times a table of 16 border classes (bit 0 top row, 1 bottom row, 2
    left column, 3 right column) x Co, each the sum of the weights of the
    taps that class has outside the image."""
    N, H, W, Ci = x.shape
    Co = w_hwio.shape[3]
    wsum = w_hwio.to(torch.int64).sum(dim=2)                 # [3, 3, Co]
    table = torch.zeros(16, Co, dtype=torch.int64)
    for c in range(16):
        for dy in range(3):
            for dx in range(3):
                if ((dy == 0 and c & 1) or (dy == 2 and c & 2)
                        or (dx == 0 and c & 4) or (dx == 2 and c & 8)):
                    table[c] += wsum[dy, dx]
    h, w = torch.arange(H)[:, None], torch.arange(W)[None, :]
    cls = ((h == 0).long() | (h == H - 1).long() << 1
           | (w == 0).long() << 2 | (w == W - 1).long() << 3)
    acc = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).double(),
                                     w_hwio.permute(3, 2, 0, 1).double(),
                                     padding=1)
    return acc.permute(0, 2, 3, 1).long() + pad * table[cls]


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 5, 7, 16, 8), (1, 1, 1, 8, 8),
                                         (3, 1, 6, 8, 16), (2, 4, 1, 16, 8)])
def test_border_class_pad_correction_matches_plain(n, h, w, ci, co):
    """The pad correction of the conv body (``csrc/conv_i8.cu``), emulated:
    exact against the plain version's -128 pad, every corner and edge, H = 1
    and W = 1 included."""
    rng = np.random.default_rng(n * 100 + h * 10 + w)
    x = torch.tensor(rng.integers(-128, 128, size=(n, h, w, ci)).astype(np.int8))
    wt = torch.tensor(rng.integers(-127, 128, size=(3, 3, ci, co)).astype(np.int8))
    A = torch.tensor((rng.uniform(0.5, 1.5, size=co) * 40
                      / (np.sqrt(9 * ci) * 73.0 * 73.0)).astype(np.float32))
    B = torch.tensor((rng.normal(size=co) * 20).astype(np.float32))
    acc = border_class_conv(x, wt, -128)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2).double(), (1, 1, 1, 1),
                                 value=-128.0)
    ref = torch.nn.functional.conv2d(xp, wt.permute(3, 2, 0, 1).double())
    assert torch.equal(acc, ref.permute(0, 2, 3, 1).long())
    y = fma_f32(acc.float(), A.expand(acc.shape), B.expand(acc.shape))
    assert torch.equal(requantize_ref(y, "offset"),
                       conv3x3_i8_ref(x, wt, A, B, "offset", -128))


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
# multiple of the body's 128-pixel tile, W above and below 128, Co = 192
# against a 128-channel tile, Ci = 192 (three K chunks of 64), the stem's
# tile edges; every mode, pad -128 (N, H, W, Ci, Co, mode, pad)
TILE_EDGES = [
    (2, 11, 10, 64, 128, "sym", 0), (2, 3, 150, 64, 128, "offset", -128),
    (1, 5, 129, 64, 64, "f32", -128), (2, 40, 3, 64, 128, "f32relu", -128),
    (2, 20, 16, 64, 192, "sym", -128), (2, 9, 70, 128, 192, "offset", 0),
    (2, 17, 24, 192, 128, "f32", -128), (2, 8, 8, 192, 64, "sym", 0),
    (2, 5, 200, 1, 64, "offset", -128), (2, 13, 7, 1, 192, "f32", -128),
    (1, 9, 33, 1, 512, "sym", -128), (2, 1, 1, 1, 64, "f32", 0),
    # the body's pixel tiles over the flattened batch: tiles across images,
    # a batch below one tile, W = 1, H = 1, mostly-border maps under the
    # -128 pad, Co = 192, Ci = 64 and 2048
    (3, 7, 9, 64, 64, "sym", 0), (5, 13, 11, 128, 128, "offset", -128),
    (1, 5, 7, 64, 128, "f32", -128), (2, 3, 3, 128, 64, "offset", -128),
    (4, 37, 1, 64, 128, "offset", -128), (3, 1, 45, 128, 64, "f32relu", -128),
    (2, 1, 1, 64, 64, "offset", -128), (3, 4, 4, 256, 128, "offset", -128),
    (3, 11, 7, 128, 192, "offset", -128), (2, 7, 5, 2048, 64, "offset", -128),
    (2, 5, 3, 2048, 192, "f32", 0), (3, 10, 6, 64, 256, "sym", -128),
    # whole-row tiles with resident weights (one halo box a dx): W = 8,
    # 16, 32, 128, 256, Co = 192, Ci = 192; 128 channels take the ring
    (2, 32, 8, 64, 128, "offset", -128), (2, 4, 128, 64, 64, "sym", -128),
    (3, 32, 16, 64, 192, "f32", -128), (1, 8, 32, 192, 64, "offset", -128),
    (1, 3, 256, 64, 64, "sym", 0), (2, 16, 16, 128, 128, "offset", -128)]


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


# the fused stem's cases on the card (N, T, F, Co): N = 1, T past a tile's
# 54 rows of 64 bins and not a multiple of them, F = 1, F > 128 (TMA over
# two column tiles; F % 4 != 0 through registers), odd F, Co 64 and 512
STEM_EDGES = [(1, 100, 64, 64), (2, 55, 64, 512), (3, 37, 1, 64), (2, 19, 132, 128),
              (2, 9, 200, 512), (1, 3, 7, 192), (2, 1, 1, 64), (1, 110, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,t,f,co", STEM_EDGES)
def test_stem_kernel_matches_plain(card, n, t, f, co, mode):
    """The fused stem kernel exactly against its plain version, codes on
    and off, one launch a call."""
    args = tuple(a.cuda() for a in stem_case(n, t, f, co, seed=t * f + co))
    want_out, want_codes = stem_plain(*args, mode)
    for codes in (True, False):
        before = stem_conv3x3_i8.launches
        out, got = stem_conv3x3_i8(*args, mode, codes=codes)
        assert stem_conv3x3_i8.launches == before + 1
        assert torch.equal(out, want_out)
        assert torch.equal(got, want_codes) if codes else got.numel() == 0


@pytest.mark.cuda
def test_stem_kernel_at_the_main_path_shape(card):
    """[512, 1024, 64] f32 -> 64, as the int8 encoder's stem runs it."""
    args = tuple(a.cuda() for a in stem_case(512, 1024, 64, 64, seed=1))
    out, codes = stem_conv3x3_i8(*args, "sym", codes=True)
    want_out, want_codes = stem_plain(*args, "sym")
    assert torch.equal(codes, want_codes)
    for i in range(0, 512, 64):
        assert torch.equal(out[i:i + 64], want_out[i:i + 64])


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64, 132])
def test_stem_kernel_reads_an_unaligned_mel(card, f):
    """A mel 4 bytes past a 16-byte boundary (a view into a larger buffer)
    goes through per-thread loads instead of TMA, exactly as well."""
    feats, c1, c2, w, A, B = (a.cuda() for a in stem_case(2, 60, f, 64, seed=f))
    buf = torch.empty(feats.numel() + 1, device="cuda")
    moved = buf[1:].view(feats.shape)
    moved.copy_(feats)
    assert moved.data_ptr() % 16 and moved.is_contiguous()
    out, codes = stem_conv3x3_i8(moved, c1, c2, w, A, B, "sym", codes=True)
    want_out, want_codes = stem_plain(feats, c1, c2, w, A, B, "sym")
    assert torch.equal(out, want_out) and torch.equal(codes, want_codes)
