"""Kaldi ark/scp matrix IO (counterpart of ``acvae_tpu/data/kaldi.py``).

The reference's older data pipeline read its features from kaldi tables
(``runners/ensemble.py:23-218``).  This reads and writes the subset it
uses: **binary float/double matrices** (the ``\\0B`` binary flag and an
``FM``/``DM`` header).  Text-format and compressed matrices raise,
naming the header.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_token(f) -> bytes:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            return tok
        tok += c


def _read_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_matrix(f) -> np.ndarray:
    flag = f.read(2)
    if flag != b"\x00B":
        raise ValueError(f"not a kaldi binary entry (flag {flag!r}); "
                         "text/compressed arks are not supported")
    header = _read_token(f)
    dtype = {b"FM": np.float32, b"DM": np.float64}.get(header)
    if dtype is None:
        raise ValueError(f"unsupported kaldi matrix header {header!r} "
                         "(only FM/DM binary matrices)")
    rows, cols = _read_int32(f), _read_int32(f)
    data = np.frombuffer(f.read(rows * cols * np.dtype(dtype).itemsize),
                         dtype=dtype)
    return data.reshape(rows, cols)


def read_mat_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                return
            yield key.decode(), _read_matrix(f)


def read_mat_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) following an scp index (``key ark_path:offset``).

    The underlying ark handle is cached across consecutive lines (a typical
    scp indexes thousands of entries in the same ark — one open() per
    matrix would make reading syscall-bound, like the reference kaldi_io's
    cached-fd behavior)."""
    cur_path, cur_f = None, None
    try:
        with open(path) as scp:
            for line in scp:
                line = line.strip()
                if not line:
                    continue
                key, rxspec = line.split(None, 1)
                ark_path, _, offset = rxspec.rpartition(":")
                if ark_path != cur_path:
                    if cur_f is not None:
                        cur_f.close()
                    cur_f = open(ark_path, "rb")
                    cur_path = ark_path
                cur_f.seek(int(offset))
                yield key, _read_matrix(cur_f)
    finally:
        if cur_f is not None:
            cur_f.close()


def write_mat_ark(path: str, mats: Dict[str, np.ndarray],
                  scp_path: str | None = None) -> None:
    """Write binary float/double matrices; optionally emit the scp index."""
    scp_lines = []
    with open(path, "wb") as f:
        for key, mat in mats.items():
            mat = np.asarray(mat)
            header = {np.dtype(np.float32): b"FM",
                      np.dtype(np.float64): b"DM"}.get(mat.dtype)
            if header is None:
                raise ValueError(f"{key}: dtype {mat.dtype} not writable "
                                 "(use float32/float64)")
            f.write(key.encode() + b" ")
            scp_lines.append(f"{key} {path}:{f.tell()}")
            f.write(b"\x00B" + header + b" ")
            for dim in mat.shape:
                f.write(b"\x04" + struct.pack("<i", dim))
            f.write(np.ascontiguousarray(mat).tobytes())
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + "\n")
