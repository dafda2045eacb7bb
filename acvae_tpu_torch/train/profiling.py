"""Profiling and step timing (counterpart of
``acvae_tpu/train/profiling.py:23-62``).

* :func:`trace`: a ``torch.profiler`` trace (CPU and, on a card, CUDA
  activity) of the enclosed block, written into ``logdir`` as a Chrome
  trace that TensorBoard's profiler plugin and Perfetto read; a no-op
  without ``logdir``.
* :class:`StepTimer`: wall-clock step times with warm-up steps skipped and
  percentile summaries; pass ``sync=torch.cuda.synchronize`` so that a
  step's time covers its kernels, not only their launch.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class Trace:
    """A running ``torch.profiler`` (CPU and, with a card, CUDA activity);
    :meth:`stop` writes its Chrome trace into ``logdir``."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self) -> str:
        """Stop and write the trace; returns the file's path."""
        self.prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}_"
                                         f"{time.time_ns()}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed block when ``logdir`` is set; no-op otherwise."""
    if not logdir:
        yield
        return
    t = Trace(logdir)
    try:
        yield t.prof
    finally:
        t.stop()


class StepTimer:
    """``with timer:`` around each step; :meth:`summary` gives the mean,
    p50 and p90 seconds and steps/s of the steps after ``warmup``."""

    def __init__(self, warmup: int = 2, sync: Optional[Callable] = None):
        self.warmup = warmup
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p90_s": float(np.percentile(arr, 90)),
                "steps_per_s": float(1.0 / arr.mean())}
