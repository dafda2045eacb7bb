"""``time_warp_1d``: the SpecAugment time-warp gather-lerp on Hopper.

Replaces the Pallas TPU kernel ``acvae_tpu/ops/pallas/warp_kernel.py``
(``time_warp_1d``, ``pl.pallas_call`` at :145).  The CUDA source is
``csrc/time_warp.cu``: one thread per output element, f innermost, grid-stride
loop.  It is memory-bound (12 bytes per element: flow in, out out, the image
rows cached); see the source for the design.

On a CPU tensor the wrapper runs :func:`time_warp_1d_ref`, the plain PyTorch
version (the transcription of the JAX gather path, warp_kernel.py:109,
120-128).  On a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from acvae_tpu_torch.ops.cuda.build import load_library

KERNEL = "time_warp"


def time_warp_1d_ref(image: torch.Tensor, flow_t: torch.Tensor,
                     max_shift: int = 64) -> torch.Tensor:
    """out[b,t,f] = image[b, t - clip(flow, ±max_shift), f], bilinear in
    time with the edge clamp of the reference (floor to [0, T-2])."""
    T = image.shape[1]
    flow_t = torch.clamp(flow_t, -max_shift, max_shift)
    t_idx = torch.arange(T, dtype=image.dtype, device=image.device)[None, :, None]
    q = t_idx - flow_t
    floor = torch.clamp(torch.floor(q), 0, T - 2)
    alpha = torch.clamp(q - floor, 0.0, 1.0)
    fi = floor.long()
    low = torch.take_along_dim(image, fi, dim=1)
    high = torch.take_along_dim(image, fi + 1, dim=1)
    return (1.0 - alpha) * low + alpha * high


def _launcher():
    fn = load_library(KERNEL).time_warp_1d_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_warp_1d(image: torch.Tensor, flow_t: torch.Tensor,
                 max_shift: int = 64) -> torch.Tensor:
    """1-D (time-axis) bilinear warp of image [B, T, F] by flow_t [B, T, F]
    (float32, contiguous, same device), displacements clamped to
    ±max_shift.  Counts its kernel launches in ``time_warp_1d.launches``."""
    if image.ndim != 3 or flow_t.shape != image.shape:
        raise ValueError(f"time_warp_1d: image {tuple(image.shape)} and flow "
                         f"{tuple(flow_t.shape)} must both be [B, T, F]")
    if image.shape[1] < 2:
        raise ValueError("time_warp_1d needs T >= 2")
    if image.dtype != torch.float32 or flow_t.dtype != torch.float32:
        raise TypeError(f"time_warp_1d takes float32, got {image.dtype} and "
                        f"{flow_t.dtype}")
    if image.device != flow_t.device:
        raise ValueError("time_warp_1d: image and flow on different devices")
    if image.device.type == "cpu":
        return time_warp_1d_ref(image, flow_t, max_shift)
    if image.numel() >= 2**31:
        raise ValueError("time_warp_1d: the kernel indexes in 32 bits; "
                         f"{image.numel()} elements is too many")
    if image.device.type != "cuda":
        raise ValueError(f"time_warp_1d: unsupported device {image.device}")
    if not (image.is_contiguous() and flow_t.is_contiguous()):
        raise ValueError("time_warp_1d: inputs must be contiguous")
    B, T, F = image.shape
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = _launcher()(image.data_ptr(), flow_t.data_ptr(), out.data_ptr(),
                          B, T, F, float(max_shift), stream)
    if err != 0:
        raise RuntimeError(f"time_warp_1d launch failed: cudaError {err}")
    time_warp_1d.launches += 1
    return out


time_warp_1d.launches = 0
