"""``conv3x3_i8`` and ``avgpool2x2_i8``: the int8 serving encoder's conv and
pool on Hopper.

They replace ``acvae_tpu/models/quant.py`` ``QuantPannEncoder._conv`` with
the affine and ``_requantize`` after it (:424-453), and ``_avgpool_i8``
(:86-99), which XLA builds on the TPU (no Pallas counterpart; PyTorch has no
CUDA int8 conv).  The CUDA source is ``csrc/conv_i8.cu``: an implicit-GEMM
conv on the int8 tensor cores (``mma.sync`` s8, ``cp.async`` pipeline) with
the requantize in its epilogue, a stem kernel for Ci = 1 that stages its
input halo once and writes 16-byte vectors, and a vectorised pool; see the
source for the bounds and the design.

On a CPU tensor each wrapper runs its plain version from ``ops/int8.py``.
On a CUDA tensor it launches the kernel or raises.  Conv weights are OHWI
[Co, 3, 3, Ci] (:func:`pack_conv3x3_weight`, once at bake time).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from acvae_tpu_torch.ops.cuda.build import load_library
from acvae_tpu_torch.ops.int8 import MODES, avgpool2x2_i8_ref, conv3x3_i8_ref

KERNEL = "conv_i8"


def pack_conv3x3_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Ci, Co] int8 -> the kernels' OHWI [Co, 3, 3, Ci]."""
    return w_hwio.permute(3, 0, 1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library(KERNEL)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.conv3x3_i8_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.conv3x3_i8_launch.restype = i
    lib.avgpool2x2_i8_launch.argtypes = [p, p, ll, i, i, i, p]
    lib.avgpool2x2_i8_launch.restype = i
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if tensors[0].data_ptr() % 16:
        raise ValueError(f"{name}: the activation must be 16-byte aligned")


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
    N, H, W, Ci = x_i8.shape
    Co = w_ohwi.shape[0]
    if w_ohwi.shape[3] != Ci or A.shape != (Co,) or B.shape != (Co,):
        raise ValueError(f"conv3x3_i8: x has Ci={Ci}, w {tuple(w_ohwi.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    if not -128 <= pad_code <= 127:
        raise ValueError(f"conv3x3_i8: pad_code {pad_code} is not an int8 code")
    if len({t.device for t in (x_i8, w_ohwi, A, B)}) != 1:
        raise ValueError("conv3x3_i8: inputs on different devices")
    if x_i8.device.type == "cpu":
        return conv3x3_i8_ref(x_i8, w_ohwi.permute(1, 2, 3, 0), A, B, mode,
                              pad_code)
    _check_cuda("conv3x3_i8", x_i8, w_ohwi, A, B)
    if not (Ci == 1 or Ci % 64 == 0) or Co % 64 or (Ci == 1 and Co > 512):
        raise ValueError(f"conv3x3_i8: the kernel takes Ci = 1 or a multiple "
                         f"of 64 and Co a multiple of 64 (at most 512 for "
                         f"Ci = 1); got Ci={Ci}, Co={Co}")
    if N * H * W * (Co // 16 if Ci == 1 else 1) >= 2**31:
        raise ValueError("conv3x3_i8: too many pixels for one launch")
    dtype = torch.int8 if mode in ("sym", "offset") else torch.float32
    out = torch.empty((N, H, W, Co), dtype=dtype, device=x_i8.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_i8.device):
        stream = torch.cuda.current_stream(x_i8.device).cuda_stream
        err = _lib().conv3x3_i8_launch(
            x_i8.data_ptr(), w_ohwi.data_ptr(), A.data_ptr(), B.data_ptr(),
            out.data_ptr(), N, H, W, Ci, Co, MODES.index(mode), pad_code, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_i8 launch failed: cudaError {err}")
    conv3x3_i8.launches += 1
    return out


def avgpool2x2_i8(x_i8: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool of int8 codes [N, H, W, C] (see
    :func:`~acvae_tpu_torch.ops.int8.avgpool2x2_i8_ref`).  On the card C
    must be a multiple of 16.  Counts its launches in
    ``avgpool2x2_i8.launches``."""
    if x_i8.dtype != torch.int8:
        raise TypeError(f"avgpool2x2_i8 takes int8 codes, got {x_i8.dtype}")
    if x_i8.ndim != 4:
        raise ValueError(f"avgpool2x2_i8: x {tuple(x_i8.shape)} must be [N,H,W,C]")
    if x_i8.device.type == "cpu":
        return avgpool2x2_i8_ref(x_i8)
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
    avgpool2x2_i8.launches += 1
    return out


conv3x3_i8.launches = 0
avgpool2x2_i8.launches = 0
