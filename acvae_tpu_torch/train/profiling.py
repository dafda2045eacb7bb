"""Profiling (counterpart of ``acvae_tpu/train/profiling.py:23-62``).

* :class:`Trace`: a ``torch.profiler`` trace (CPU and, on a card, CUDA
  activity) written into a directory as a Chrome trace that TensorBoard's
  profiler plugin and Perfetto read (the CLI's ``profile_dir``).
* :func:`mark_backward`: names the backward of a forward region.  Autograd
  runs the backward on its own thread (one a device), where no range of
  the forward's thread is open; marked outputs open ``backward.<name>``
  there when their gradients are complete, so the kernels that region's
  backward launches fall inside it.
* ``python.gc``: each collection of Python's garbage collector is a range,
  so a host pause of the collector is named in the trace.

Both ranges are ``record_function`` ranges and exist only while a
profiler runs: without one, :func:`mark_backward` returns its argument
unchanged (the autograd graph holds no extra node) and the collector's
hook returns at once.
"""
from __future__ import annotations

import functools
import gc
import os
import threading
import time
from typing import Any, Dict, List

import torch
from torch.profiler import record_function

# the range of each garbage collection
GC_RANGE = "python.gc"


class Trace:
    """A running ``torch.profiler`` (CPU and, with a card, CUDA activity) of
    every thread where this torch can (the CLI's loader uploads batches
    from a thread of its own); :meth:`stop` writes its Chrome trace into
    ``logdir``."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            kw = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except (AttributeError, TypeError):
            kw = {}
        self.prof = torch.profiler.profile(activities=acts, **kw)
        self.prof.start()

    def stop(self) -> str:
        """Stop and write the trace; returns the file's path."""
        self.prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}_"
                                         f"{time.time_ns()}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        return path


# ---------------------------------------------------------------- backward
class _OpenRange:
    """The ``backward.*`` range open on one autograd thread, and the graph
    task it belongs to."""

    def __init__(self):
        self.task, self.name, self.range = None, None, None

    def close(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.name, self.range = None, None


_local = threading.local()


def _enter_backward_range(name: str) -> None:
    """Close the open ``backward.*`` range of this graph task and open
    ``backward.<name>``; the first of a graph task queues the callback that
    closes the last one when the task ends."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = _OpenRange()
    task = torch._C._current_graph_task_id()
    if state.task != task:
        state.task = task
        torch.autograd.Variable._execution_engine.queue_callback(
            functools.partial(_end_of_task, state, task))
    elif state.name == name:
        return
    state.close()      # also a range of a task that ended before its callback
    state.range = record_function("backward." + name)
    state.range.__enter__()
    state.name = name


def _end_of_task(state: _OpenRange, task: int) -> None:
    if state.task == task:
        state.close()
        state.task = None


class _Mark(torch.autograd.Function):
    """The identity on its tensors; its backward opens the region's range
    and passes the gradients on unchanged."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.region = name
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        _enter_backward_range(ctx.region)
        return (None,) + grads


def _leaves(tree, out: List[torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)


def _replace(tree, new: Dict[int, torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        return new.get(id(tree), tree)
    if isinstance(tree, dict):
        return {k: _replace(v, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, new) for v in tree)
    return tree


def mark_backward(name: str, tree: Any) -> Any:
    """``tree`` (a tensor, or dicts, lists and tuples of them) with its
    floating tensors that require grad passed through one identity node,
    whose backward opens the range ``backward.<name>`` on the thread that
    runs it.  Call it on every output of a forward region, at the region's
    end: autograd runs nodes in the reverse of their creation, so the
    region's backward runs after the node fires and before the next
    mark's.  A tensor that appears twice is marked once, so every consumer
    adds its gradient into one sum, in the order it would without the
    mark.  Without a running profiler, or with grad off, ``tree`` comes
    back as it is."""
    if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
        return tree
    leaves: List[torch.Tensor] = []
    _leaves(tree, leaves)
    xs = list({id(x): x for x in leaves
               if x.requires_grad and x.is_floating_point()}.values())
    if not xs:
        return tree
    ys = _Mark.apply(name, *xs)
    return _replace(tree, {id(x): y for x, y in zip(xs, ys)})


# ---------------------------------------------------------------------- gc
_gc_open: List[record_function] = []


def _gc_range(phase: str, info: Dict) -> None:
    """``gc.callbacks`` hook: a ``python.gc`` range around each collection
    while a profiler runs."""
    if phase == "start":
        if torch.autograd._profiler_enabled():
            rf = record_function(GC_RANGE)
            rf.__enter__()
            _gc_open.append(rf)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_range)
