"""``topk_rows``: the beam's top-k on Hopper.

The ``k`` best (score, index) pairs of each row of x [R, M] float32, in
``lax.top_k``'s order: descending score, equal scores in ascending index,
which is ``torch.sort(x, -1, descending=True, stable=True)`` cut to ``k``.
It replaces no Pallas kernel: it stands for XLA's ``lax.top_k`` in
``acvae_tpu/decoding/beam.py:37-75``, which the port ran as a full stable
sort of each row only to keep the first ``k``.  The CUDA source is
``csrc/topk.cu``: one block a row, bound by bytes, at most ``ROUND_K``
keys a launch (a larger ``k`` takes ``ceil(k / ROUND_K)`` launches, each
reading the row again); see the source for the design and for how it
follows the card's sort on NaN and signed zeros.

The kernel is an operator (``torch.ops.acvae_tpu_torch.topk_rows``), so an
exported decode (``export.py``) calls it.  On a CPU tensor it runs
:func:`topk_rows_ref`, the stable sort cut to ``k``; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from acvae_tpu_torch.ops.cuda.build import load_library

KERNEL = "topk"
ROUND_K = 16    # the most keys one launch of the kernel selects


def topk_rows_ref(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [R, k], indices [R, k] int64)``: the stable descending sort
    of each row of ``x``, cut to ``k`` (to M where M < k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k].contiguous(), idx[:, :k].contiguous()


_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library(KERNEL)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.topk_rows_launch.argtypes = [p, p, p, ll, ll, i, p]
    lib.topk_rows_launch.restype = i
    return lib


@torch.library.custom_op("acvae_tpu_torch::topk_rows", mutates_args=())
def topk_rows_op(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(f"topk_rows: unsupported device {x.device}")


@topk_rows_op.register_fake
def _(x, k):
    shape = (x.shape[0], min(k, x.shape[1]))
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.long)


@topk_rows_op.register_kernel("cpu")
def _(x, k):
    return topk_rows_ref(x, k)


@topk_rows_op.register_kernel("cuda")
def _(x, k):
    if not x.is_contiguous():
        raise ValueError("topk_rows: x must be contiguous")
    R, M = x.shape
    if R >= 2**31 or M >= 2**31:
        raise ValueError(f"topk_rows: {tuple(x.shape)} is too large for one launch")
    kc = min(k, M)
    values = torch.empty((R, kc), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, kc), dtype=torch.long, device=x.device)
    if values.numel() == 0:
        return values, idx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().topk_rows_launch(x.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                      R, M, kc, stream)
    if err != 0:
        raise RuntimeError(f"topk_rows launch failed: cudaError {err}")
    with _COUNT_LOCK:   # a decode sharded over cards launches from a thread a card
        topk_rows.launches += -(-kc // ROUND_K)
    return values, idx


def topk_rows(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of each row of ``x`` [R, M] float32:
    ``(values [R, min(k, M)], indices [R, min(k, M)] int64)``, bit for bit
    the stable descending sort cut to ``k`` on the tensor's device (the
    card's and the CPU's sorts differ only on NaN: the card orders NaNs by
    their bits, those with the sign set last, the CPU puts every NaN first).
    Counts its kernel launches in ``topk_rows.launches``."""
    if x.dtype != torch.float32:
        raise TypeError(f"topk_rows takes float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"topk_rows: x {tuple(x.shape)} must be [R, M]")
    if k < 0:
        raise ValueError(f"topk_rows: k={k} is negative")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_rows: unsupported device {x.device}")
    return topk_rows_op(x, int(k))


topk_rows.launches = 0
