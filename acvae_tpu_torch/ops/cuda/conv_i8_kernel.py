"""``stem_conv3x3_i8``, ``conv3x3_i8`` and ``avgpool2x2_i8``: the int8
serving encoder's stem, conv and pool on Hopper.

They replace ``acvae_tpu/models/quant.py`` ``QuantPannEncoder._quant_stem``
(:246-261) with the stem's ``_conv``, affine and ``_requantize`` after it,
``_conv`` with the affine and ``_requantize`` (:424-453), and
``_avgpool_i8`` (:86-99), which XLA builds on the TPU (no Pallas
counterpart; PyTorch has no CUDA int8 conv).  The CUDA source is
``csrc/conv_i8.cu``: an implicit-GEMM conv on the int8 tensor cores
(``wgmma`` s8 from shared memory, fed by TMA under mbarriers, pixel tiles
over the whole batch) with the requantize in its epilogue, a stem kernel
for Ci = 1 that quantizes the f32 log-mel as it stages its halo once and
writes 16-byte vectors, and a vectorised pool; see the source for the
bounds and the design.

Each kernel is an operator (``torch.ops.acvae_tpu_torch.stem_conv3x3_i8``,
``.conv3x3_i8`` and ``.avgpool2x2_i8``), so an exported decode
(``export.py``) calls it.  On a CPU tensor it runs its plain version from
``ops/int8.py``; on a CUDA tensor it launches the kernel or raises.  Conv
weights are OHWI [Co, 3, 3, Ci] (:func:`pack_conv3x3_weight`, once at bake
time).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from acvae_tpu_torch.ops.cuda.build import load_library
from acvae_tpu_torch.ops.int8 import (MODES, avgpool2x2_i8_ref, conv3x3_i8_ref,
                                      stem_codes)

KERNEL = "conv_i8"


def pack_conv3x3_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Ci, Co] int8 -> the kernels' OHWI [Co, 3, 3, Ci]."""
    return w_hwio.permute(3, 0, 1, 2).contiguous()


_COUNT_LOCK = threading.Lock()


def _count(fn, device: torch.device) -> None:
    """One launch of ``fn``'s kernel on ``device``: ``fn.launches`` and
    ``fn.launches_by_device[index]`` (a decode sharded over cards launches
    from one thread a card)."""
    with _COUNT_LOCK:
        fn.launches += 1
        by = fn.launches_by_device
        by[device.index] = by.get(device.index, 0) + 1


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library(KERNEL)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.conv3x3_i8_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.conv3x3_i8_launch.restype = i
    lib.stem_conv3x3_i8_launch.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.stem_conv3x3_i8_launch.restype = i
    lib.avgpool2x2_i8_launch.argtypes = [p, p, ll, i, i, i, p]
    lib.avgpool2x2_i8_launch.restype = i
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor, aligned: int = 2) -> None:
    """Contiguous inputs; the first ``aligned`` (the activation and the
    weights of a conv) 16-byte aligned."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:aligned]):
        raise ValueError(f"{name}: the activation and the weights must be "
                         f"16-byte aligned")


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")


def _conv_out_dtype(mode: str) -> torch.dtype:
    return torch.int8 if mode in ("sym", "offset") else torch.float32


# The kernels as operators of their own (namespace ``acvae_tpu_torch``), so
# that ``torch.export`` records a call where a ctypes launch could not be
# traced: the CPU implementation is the plain version, the CUDA one the
# launch, and the fake one gives the output's shape and dtype to a trace
# with a symbolic batch.  The checks that read the batch size (the 2^31
# pixel limit, the empty output) live in the implementations, where the
# batch is a number, so that a trace does not pin it.
@torch.library.custom_op("acvae_tpu_torch::conv3x3_i8", mutates_args=())
def conv3x3_i8_op(x_i8: torch.Tensor, w_ohwi: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, mode: str, pad_code: int) -> torch.Tensor:
    raise NotImplementedError(f"conv3x3_i8: unsupported device {x_i8.device}")


@conv3x3_i8_op.register_fake
def _(x_i8, w_ohwi, A, B, mode, pad_code):
    N, H, W, _ = x_i8.shape
    return x_i8.new_empty((N, H, W, w_ohwi.shape[0]), dtype=_conv_out_dtype(mode))


@conv3x3_i8_op.register_kernel("cpu")
def _(x_i8, w_ohwi, A, B, mode, pad_code):
    return conv3x3_i8_ref(x_i8, w_ohwi.permute(1, 2, 3, 0), A, B, mode, pad_code)


@conv3x3_i8_op.register_kernel("cuda")
def _(x_i8, w_ohwi, A, B, mode, pad_code):
    _check_cuda("conv3x3_i8", x_i8, w_ohwi, A, B)
    N, H, W, Ci = x_i8.shape
    Co = w_ohwi.shape[0]
    if not (Ci == 1 or Ci % 64 == 0) or Co % 64 or (Ci == 1 and Co > 512):
        raise ValueError(f"conv3x3_i8: the kernel takes Ci = 1 or a multiple "
                         f"of 64 and Co a multiple of 64 (at most 512 for "
                         f"Ci = 1); got Ci={Ci}, Co={Co}")
    if N * H * W * (Co // 16 if Ci == 1 else 1) >= 2**31:
        raise ValueError("conv3x3_i8: too many pixels for one launch")
    out = torch.empty((N, H, W, Co), dtype=_conv_out_dtype(mode),
                      device=x_i8.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_i8.device):
        stream = torch.cuda.current_stream(x_i8.device).cuda_stream
        err = _lib().conv3x3_i8_launch(
            x_i8.data_ptr(), w_ohwi.data_ptr(), A.data_ptr(), B.data_ptr(),
            out.data_ptr(), N, H, W, Ci, Co, MODES.index(mode), pad_code, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_i8 launch failed: cudaError {err}")
    _count(conv3x3_i8, x_i8.device)
    return out


@torch.library.custom_op("acvae_tpu_torch::stem_conv3x3_i8", mutates_args=())
def stem_conv3x3_i8_op(feats: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                       w_ohwi: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       mode: str, want_codes: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(f"stem_conv3x3_i8: unsupported device {feats.device}")


def _stem_codes_shape(feats, want_codes):
    return tuple(feats.shape) + (1,) if want_codes else (0,)


@stem_conv3x3_i8_op.register_fake
def _(feats, c1, c2, w_ohwi, A, B, mode, want_codes):
    N, T, F = feats.shape
    return (feats.new_empty((N, T, F, w_ohwi.shape[0]), dtype=_conv_out_dtype(mode)),
            feats.new_empty(_stem_codes_shape(feats, want_codes), dtype=torch.int8))


@stem_conv3x3_i8_op.register_kernel("cpu")
def _(feats, c1, c2, w_ohwi, A, B, mode, want_codes):
    codes = stem_codes(feats, c1, c2)
    out = conv3x3_i8_ref(codes, w_ohwi.permute(1, 2, 3, 0), A, B, mode, 0)
    return out, codes if want_codes else codes.new_empty((0,))


@stem_conv3x3_i8_op.register_kernel("cuda")
def _(feats, c1, c2, w_ohwi, A, B, mode, want_codes):
    # any alignment: the kernel reads an unaligned mel without TMA
    _check_cuda("stem_conv3x3_i8", feats, c1, c2, w_ohwi, A, B, aligned=0)
    N, T, F = feats.shape
    Co = w_ohwi.shape[0]
    if Co % 64 or Co > 512:
        raise ValueError(f"stem_conv3x3_i8: the kernel takes Co a multiple of "
                         f"64, at most 512; got {Co}")
    if N * T * F * (Co // 16) >= 2**31:
        raise ValueError("stem_conv3x3_i8: too many pixels for one launch")
    out = torch.empty((N, T, F, Co), dtype=_conv_out_dtype(mode), device=feats.device)
    codes = torch.empty(_stem_codes_shape(feats, want_codes), dtype=torch.int8,
                        device=feats.device)
    if out.numel() == 0:
        return out, codes
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _lib().stem_conv3x3_i8_launch(
            feats.data_ptr(), c1.data_ptr(), c2.data_ptr(), w_ohwi.data_ptr(),
            A.data_ptr(), B.data_ptr(), out.data_ptr(),
            codes.data_ptr() if want_codes else None, N, T, F, Co,
            MODES.index(mode), stream)
    if err != 0:
        raise RuntimeError(f"stem_conv3x3_i8 launch failed: cudaError {err}")
    _count(stem_conv3x3_i8, feats.device)
    return out, codes


@torch.library.custom_op("acvae_tpu_torch::avgpool2x2_i8", mutates_args=())
def avgpool2x2_i8_op(x_i8: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(f"avgpool2x2_i8: unsupported device {x_i8.device}")


@avgpool2x2_i8_op.register_fake
def _(x_i8):
    N, H, W, C = x_i8.shape
    return x_i8.new_empty((N, H // 2, W // 2, C))


@avgpool2x2_i8_op.register_kernel("cpu")
def _(x_i8):
    return avgpool2x2_i8_ref(x_i8)


@avgpool2x2_i8_op.register_kernel("cuda")
def _(x_i8):
    _check_cuda("avgpool2x2_i8", x_i8)
    N, H, W, C = x_i8.shape
    if C % 16:
        raise ValueError(f"avgpool2x2_i8: the kernel takes C a multiple of 16, "
                         f"got {C}")
    if N * (H // 2) * (W // 2) * (C // 16) >= 2**31:
        raise ValueError("avgpool2x2_i8: too many pixels for one launch")
    out = torch.empty((N, H // 2, W // 2, C), dtype=torch.int8, device=x_i8.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_i8.device):
        stream = torch.cuda.current_stream(x_i8.device).cuda_stream
        err = _lib().avgpool2x2_i8_launch(x_i8.data_ptr(), out.data_ptr(), N, H,
                                          W, C, stream)
    if err != 0:
        raise RuntimeError(f"avgpool2x2_i8 launch failed: cudaError {err}")
    _count(avgpool2x2_i8, x_i8.device)
    return out


def conv3x3_i8(x_i8: torch.Tensor, w_ohwi: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, mode: str, pad_code: int = 0) -> torch.Tensor:
    """3×3 int8 conv of x_i8 [N, H, W, Ci] by w_ohwi [Co, 3, 3, Ci] with the
    epilogue ``mode`` on ``acc·A + B`` (see :func:`~acvae_tpu_torch.ops.int8.
    conv3x3_i8_ref`); the border reads ``pad_code``.  On the card Ci must be
    1 or a multiple of 64 and Co a multiple of 64.  Counts its launches in
    ``conv3x3_i8.launches``."""
    if mode not in MODES:
        raise ValueError(f"conv3x3_i8: mode must be one of {MODES}, got {mode!r}")
    if x_i8.dtype != torch.int8 or w_ohwi.dtype != torch.int8:
        raise TypeError(f"conv3x3_i8 takes int8 codes and weights, got "
                        f"{x_i8.dtype} and {w_ohwi.dtype}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError("conv3x3_i8: A and B must be float32")
    if x_i8.ndim != 4 or w_ohwi.ndim != 4 or w_ohwi.shape[1:3] != (3, 3):
        raise ValueError(f"conv3x3_i8: x {tuple(x_i8.shape)} must be [N,H,W,Ci] "
                         f"and w {tuple(w_ohwi.shape)} [Co,3,3,Ci]")
    Ci, Co = x_i8.shape[3], w_ohwi.shape[0]
    if w_ohwi.shape[3] != Ci or A.shape != (Co,) or B.shape != (Co,):
        raise ValueError(f"conv3x3_i8: x has Ci={Ci}, w {tuple(w_ohwi.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    if not -128 <= pad_code <= 127:
        raise ValueError(f"conv3x3_i8: pad_code {pad_code} is not an int8 code")
    _check_device("conv3x3_i8", x_i8, w_ohwi, A, B)
    return conv3x3_i8_op(x_i8, w_ohwi, A, B, mode, pad_code)


def stem_conv3x3_i8(feats: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                    w_ohwi: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    mode: str, codes: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 encoder's stem from the f32 log-mel: the codes
    ``clip(round(feats·c1 + c2), -127, 127)`` (:func:`~acvae_tpu_torch.ops.
    int8.stem_codes`, c1/c2 [F] from :func:`~acvae_tpu_torch.ops.int8.
    stem_coeffs`), then the 3×3 conv of those codes by w_ohwi [Co, 3, 3, 1]
    with the epilogue ``mode`` on ``acc·A + B`` (SAME padding of the codes:
    the border reads code 0).  Returns ``(out [N, T, F, Co], codes)``, the
    codes [N, T, F, 1] int8 when ``codes`` is true, else an empty tensor.
    On the card Co must be a multiple of 64, at most 512.  Counts its
    launches in ``stem_conv3x3_i8.launches``."""
    if mode not in MODES:
        raise ValueError(f"stem_conv3x3_i8: mode must be one of {MODES}, got {mode!r}")
    if any(t.dtype != torch.float32 for t in (feats, c1, c2, A, B)):
        raise TypeError("stem_conv3x3_i8: feats, c1, c2, A and B must be float32")
    if w_ohwi.dtype != torch.int8:
        raise TypeError(f"stem_conv3x3_i8 takes int8 weights, got {w_ohwi.dtype}")
    if feats.ndim != 3 or w_ohwi.ndim != 4 or w_ohwi.shape[1:] != (3, 3, 1):
        raise ValueError(f"stem_conv3x3_i8: feats {tuple(feats.shape)} must be "
                         f"[N,T,F] and w {tuple(w_ohwi.shape)} [Co,3,3,1]")
    F, Co = feats.shape[2], w_ohwi.shape[0]
    if c1.shape != (F,) or c2.shape != (F,) or A.shape != (Co,) or B.shape != (Co,):
        raise ValueError(f"stem_conv3x3_i8: F={F}, Co={Co}, c1 {tuple(c1.shape)}, "
                         f"c2 {tuple(c2.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}")
    _check_device("stem_conv3x3_i8", feats, c1, c2, w_ohwi, A, B)
    return stem_conv3x3_i8_op(feats, c1, c2, w_ohwi, A, B, mode, bool(codes))


def avgpool2x2_i8(x_i8: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool of int8 codes [N, H, W, C] (see
    :func:`~acvae_tpu_torch.ops.int8.avgpool2x2_i8_ref`).  On the card C
    must be a multiple of 16.  Counts its launches in
    ``avgpool2x2_i8.launches``."""
    if x_i8.dtype != torch.int8:
        raise TypeError(f"avgpool2x2_i8 takes int8 codes, got {x_i8.dtype}")
    if x_i8.ndim != 4:
        raise ValueError(f"avgpool2x2_i8: x {tuple(x_i8.shape)} must be [N,H,W,C]")
    _check_device("avgpool2x2_i8", x_i8)
    return avgpool2x2_i8_op(x_i8)


for _fn in (stem_conv3x3_i8, conv3x3_i8, avgpool2x2_i8):
    _fn.launches = 0
    _fn.launches_by_device = {}
