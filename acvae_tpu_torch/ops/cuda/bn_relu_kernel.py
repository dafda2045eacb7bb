"""``bn_relu``: the PANN ConvBlock's inference epilogue on Hopper.

BatchNorm on running statistics, ReLU and, with ``pool``, the 2×2 average
pool after a block's second conv, as one pass over a conv's output.  It
replaces no Pallas kernel: it stands for XLA's fusion of
``acvae_tpu/models/encoders.py:38-60`` (``ConvBlock``), which PyTorch runs
as five elementwise passes and a pool.  The CUDA source is
``csrc/bn_relu.cu``: 16-byte vectors along each (n, c) plane, bound by
bytes; see the source for the design.

The kernel is an operator (``torch.ops.acvae_tpu_torch.bn_relu``), so an
exported bf16 decode (``export.py``) calls it.  On a CPU tensor it runs
:func:`bn_relu_ref`, the port's unfused arithmetic; on a CUDA tensor it
launches the kernel or raises.  The kernel gives the same bits as the
unfused ops: see the source.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from acvae_tpu_torch.ops.cuda.build import load_library

KERNEL = "bn_relu"
DTYPES = (torch.float32, torch.bfloat16)
# the statistics' dtypes, which float32 holds exactly, so that the unfused
# arithmetic runs in float32 (the bf16 decode casts the scale and bias)
STAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def bn_relu_ref(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                bias: torch.Tensor, pool: bool) -> torch.Tensor:
    """``relu(x.dtype((x - mean) · mul + bias))`` in float32 over the
    channels of x [N, C, H, W], then ``avg_pool2d(·, 2)`` with ``pool``: the
    unfused ops of ``models/encoders.py::BatchNorm`` (inference) and
    ``ConvBlock``."""
    shape = (1, -1, 1, 1)
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    y = F.relu(y.to(x.dtype))
    return F.avg_pool2d(y, 2) if pool else y


_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library(KERNEL)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bn_relu_launch.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, p]
    lib.bn_relu_launch.restype = i
    return lib


def _out_shape(x: torch.Tensor, pool: bool):
    N, C, H, W = x.shape
    return (N, C, H // 2, W // 2) if pool else (N, C, H, W)


@torch.library.custom_op("acvae_tpu_torch::bn_relu", mutates_args=())
def bn_relu_op(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
               bias: torch.Tensor, pool: bool) -> torch.Tensor:
    raise NotImplementedError(f"bn_relu: unsupported device {x.device}")


@bn_relu_op.register_fake
def _(x, mean, mul, bias, pool):
    return x.new_empty(_out_shape(x, pool))


@bn_relu_op.register_kernel("cpu")
def _(x, mean, mul, bias, pool):
    return bn_relu_ref(x, mean, mul, bias, pool)


@bn_relu_op.register_kernel("cuda")
def _(x, mean, mul, bias, pool):
    if not all(t.is_contiguous() for t in (x, mean, mul, bias)):
        raise ValueError("bn_relu: inputs must be contiguous (x NCHW)")
    N, C, H, W = x.shape
    if N * C >= 2**31 or H * W >= 2**31:
        raise ValueError(f"bn_relu: {tuple(x.shape)} is too large for one launch")
    out = torch.empty(_out_shape(x, pool), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().bn_relu_launch(
            x.data_ptr(), out.data_ptr(), mean.data_ptr(), mul.data_ptr(),
            bias.data_ptr(), DTYPES.index(x.dtype), N, C, H, W, int(pool), stream)
    if err != 0:
        raise RuntimeError(f"bn_relu launch failed: cudaError {err}")
    with _COUNT_LOCK:   # a decode sharded over cards launches from a thread a card
        bn_relu.launches += 1
    return out


def bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor, eps: float,
            pool: bool = False) -> torch.Tensor:
    """ReLU of BatchNorm on running statistics (``mean``, ``var``, the
    scale ``weight``, ``bias``, [C] each in a dtype of ``STAT_DTYPES``) of
    x [N, C, H, W] in bfloat16 or float32, in float32 and rounded to x's
    dtype before the ReLU, as ``models/encoders.py::BatchNorm`` at
    inference does; with ``pool`` the VALID 2×2 average pool of that.  The
    scale ``rsqrt(var + eps) · weight`` is computed here with PyTorch's ops,
    as ``BatchNorm`` computes it.  Counts its kernel launches in
    ``bn_relu.launches``."""
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_relu takes bfloat16 or float32, got {x.dtype}")
    if any(t.dtype not in STAT_DTYPES for t in (mean, var, weight, bias)):
        raise TypeError("bn_relu: mean, var, weight and bias must be float32, "
                        "bfloat16 or float16")
    if x.ndim != 4 or any(t.shape != (x.shape[1],) for t in (mean, var, weight, bias)):
        raise ValueError(f"bn_relu: x {tuple(x.shape)} must be [N, C, H, W] and "
                         f"the statistics [C]")
    if len({t.device for t in (x, mean, var, weight, bias)}) != 1:
        raise ValueError("bn_relu: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_relu: unsupported device {x.device}")
    if pool and min(x.shape[2:]) < 2:
        raise ValueError(f"bn_relu: a 2x2 pool of {tuple(x.shape)} is empty")
    mul = torch.rsqrt(var + eps) * weight
    return bn_relu_op(x, mean.float(), mul.float(), bias.float(), bool(pool))


bn_relu.launches = 0
