"""Plain PyTorch versions of the int8 serving encoder's arithmetic
(counterpart of ``acvae_tpu/models/quant.py:86-99, 246-261, 424-472``).

Every public function works in the JAX package's NHWC layout (activations
[N, H, W, C], conv weights HWIO [3, 3, Ci, Co]) and runs on any device.
They are what the CPU runs and what the CUDA kernels of
``ops/cuda/conv_i8_kernel.py`` are held against on the card.

Rounding follows the JAX package's *compiled* program: XLA fuses the
epilogue ``acc·A + B`` (and the stem's ``feats·c + d``) into a single-rounded
fused multiply-add (``tests/test_torch_quant.py`` pins this), so
:func:`fma_f32` computes it exactly, and ``round`` is half-to-even
(``torch.round``, ``jnp.round`` and CUDA's ``rintf`` agree).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ZP = 128  # zero point of the offset (post-relu) coding
MODES = ("sym", "offset", "f32relu", "f32")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32 (what CUDA's
    ``__fmaf_rn`` and XLA's fused multiply-add compute).

    ``a·b`` is exact in float64; the sum is rounded to float64 and its error
    kept exactly (Knuth's TwoSum).  Rounding that float64 sum to float32 is
    right except when it lies exactly halfway between two float32 values
    while the exact sum does not; then the error's sign picks the side."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    f = s.float()
    g = f.double()
    inf = torch.tensor(math.inf, dtype=torch.float32, device=f.device)
    other = torch.nextafter(f, torch.where(s > g, inf, -inf))
    o = other.double()
    halfway = (s != g) & ((s - g) == (o - s))
    take_other = halfway & (err != 0) & ((err > 0) == (o > s))
    return torch.where(take_other, other, f)


def requantize_ref(y: torch.Tensor, mode: str) -> torch.Tensor:
    """Scaled conv output -> code (``quant.py:439-453``) or f32 value.

    ``sym``: ``clip(round(y), 0, 127)``; ``offset``: ``clip(round(y) - 128,
    -128, 127)`` (both fold the relu into the clip); ``f32relu``:
    ``max(y, 0)``; ``f32``: ``y`` itself (the pre-relu affine that the
    bake-time bias correction measures)."""
    if mode == "sym":
        return torch.clamp(torch.round(y), 0, 127).to(torch.int8)
    if mode == "offset":
        return torch.clamp(torch.round(y) - ZP, -ZP, 127).to(torch.int8)
    if mode == "f32relu":
        return torch.clamp_min(y, 0.0)
    if mode == "f32":
        return y
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def conv3x3_i8_ref(x_i8: torch.Tensor, w_i8: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, mode: str, pad_code: int) -> torch.Tensor:
    """3×3 stride-1 int8 conv, int32 accumulation, fused epilogue.

    x_i8 [N, H, W, Ci] int8, w_i8 [3, 3, Ci, Co] int8 (HWIO), A/B [Co]
    float32.  The border reads ``pad_code``: 0 is the SAME conv, -128 the
    offset coding's explicit pad followed by a VALID conv
    (``quant.py:424-437``).  Returns ``requantize_ref(acc·A + B, mode)``
    [N, H, W, Co] (int8, or float32 for the f32 modes).

    The conv runs as a float64 ``F.conv2d``: every int8·int8 product sum
    here is below 9·512·128·127 < 2^53, so float64 holds it exactly in any
    order.  cuDNN is switched off for it (its FFT and Winograd algorithms
    are not exact), and the batch goes through in slices so that the
    float64 temporaries stay near 1 GB at any size."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    N, H, W, Ci = x_i8.shape
    Co = w_i8.shape[3]
    dtype = torch.int8 if mode in ("sym", "offset") else torch.float32
    out = torch.empty((N, H, W, Co), dtype=dtype, device=x_i8.device)
    w64 = w_i8.permute(3, 2, 0, 1).double()              # OIHW
    A, B = A.float().view(1, 1, 1, Co), B.float().view(1, 1, 1, Co)
    step = max(1, 2**27 // max(1, (H + 2) * (W + 2) * max(Ci, Co)))
    with torch.backends.cudnn.flags(enabled=False):
        for n0 in range(0, N, step):
            xc = x_i8[n0:n0 + step].permute(0, 3, 1, 2).double()
            xc = F.pad(xc, (1, 1, 1, 1), value=float(pad_code))
            acc = F.conv2d(xc, w64).permute(0, 2, 3, 1).to(torch.int32)
            y = fma_f32(acc.float(), A.expand_as(acc), B.expand_as(acc))
            out[n0:n0 + step] = requantize_ref(y, mode)
    return out


def avgpool2x2_i8_ref(x_i8: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool of int8 codes [N, H, W, C]
    (``quant.py:86-99``): the 4-tap int32 sum, then ``(s+2)>>2`` (an
    arithmetic shift: floor, so halves round toward +inf for negative
    offset codes too); an odd trailing row or column is dropped."""
    h = (x_i8.shape[1] // 2) * 2
    w = (x_i8.shape[2] // 2) * 2
    x = x_i8[:, :h, :w]
    s = (x[:, ::2, ::2].to(torch.int32) + x[:, 1::2, ::2]
         + x[:, ::2, 1::2] + x[:, 1::2, 1::2])
    return ((s + 2) >> 2).to(torch.int8)


def avgpool2x2_f32(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool of float32 NHWC (``quant.py:102-104``):
    the four taps summed in window order, times 0.25."""
    h = (x.shape[1] // 2) * 2
    w = (x.shape[2] // 2) * 2
    x = x[:, :h, :w]
    return (x[:, ::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, ::2]
            + x[:, 1::2, 1::2]) * 0.25


def quant_stem(feats: torch.Tensor, s0: torch.Tensor, b0: torch.Tensor,
               s_stem) -> torch.Tensor:
    """Fused stem quantization (``quant.py:246-261``): bn0's per-bin affine
    and the stem's activation scale in one multiply-add, then
    ``clip(round(·), -127, 127)`` -> int8 [N, T, F, 1].  One input lane:
    the JAX stem's second lane always carries code 0."""
    s = torch.as_tensor(s_stem, dtype=torch.float32, device=feats.device)
    c1, c2 = s0 / s, b0 / s
    y = fma_f32(feats.float(), c1.expand_as(feats), c2.expand_as(feats))
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)[..., None]
