"""What a parallel train step tells the model code, and the row-split
draws.

:func:`step_context` marks a train step of a :class:`~acvae_tpu_torch.
parallel.mesh.Grid`: the losses then divide by global counts
(:func:`global_count`, :func:`batch_mean`), BatchNorm reduces its sums
over :func:`bn_group`, a vocab-split classifier hands back its shard of the
logits, and with ``seq_split`` the encoder runs its trunk on its slice of
mel time (every encoder of ``models/encoders.py::seq_split_encoders``: all
but RNNEncoder, whose GRU reads the input frames in order; the
transformers attend with the slice's queries to every frame).
Outside a step (validation, the decodes) the model is a plain one.

:func:`row_shard` makes every draw of the rows a split slice of the draw
the unsplit run makes: the draw helpers :func:`randn`, :func:`rand` and
:func:`randint` draw the whole batch's shape from the generator, the clip
rows padded as :func:`~acvae_tpu_torch.parallel.mesh.pad_to_multiple` pads
them, and keep this shard's rows (:func:`take_rows`, which also slices
draws handed in whole).  Every rank draws the same shapes, so the
generators stay in step; a draw with no row axis (the per-step coins) is
the same on every rank.  Without a shard they are the plain torch calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch

from acvae_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                  all_reduce_sum_nograd)

_LOCAL = threading.local()


@dataclasses.dataclass
class StepState:
    grid: Any
    seq_split: bool = False
    in_split: bool = False      # inside the time-split part of the encoder
    vocab_logits: bool = False  # the classifier returns its vocab shard


def active() -> Optional[StepState]:
    return getattr(_LOCAL, "step", None)


@contextlib.contextmanager
def step_context(grid, seq_split: bool = False, vocab_logits: bool = False):
    prev = active()
    _LOCAL.step = StepState(grid, seq_split, vocab_logits=vocab_logits)
    try:
        yield _LOCAL.step
    finally:
        _LOCAL.step = prev


@contextlib.contextmanager
def split_region():
    """The time-split part of the encoder (its BatchNorms reduce over every
    rank)."""
    st = active()
    prev = st.in_split
    st.in_split = True
    try:
        yield
    finally:
        st.in_split = prev


def data_extent() -> int:
    st = active()
    return 1 if st is None else st.grid.data


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()`` over the global batch (a count: no gradient)."""
    st = active()
    s = x.sum()
    if st is None or st.grid.data == 1:
        return s
    return all_reduce_sum_nograd(s, st.grid.data_group)


def batch_mean(values: torch.Tensor) -> torch.Tensor:
    """``values.mean()`` as this rank's share of the global batch's mean
    (the ranks hold equal row counts)."""
    st = active()
    if st is None or st.grid.data == 1:
        return values.mean()
    return values.sum() / (values.numel() * st.grid.data)


def bn_group():
    """The group a train-mode BatchNorm sums over, or None: every rank in
    the time-split encoder, else the ranks of other rows."""
    st = active()
    if st is None:
        return None
    g = st.grid
    if st.in_split and g.model > 1:
        return g.world_group
    return g.data_group if g.data > 1 else None


# ------------------------------------------------------------ row draws
@dataclasses.dataclass
class RowShard:
    n_local: int   # clip rows this shard holds
    n_draw: int    # clip rows the unsplit run draws for
    lo: int        # this shard's first row in the padded batch


@contextlib.contextmanager
def row_shard(n_local: int, n_draw: int, lo: int):
    prev = getattr(_LOCAL, "rows", None)
    _LOCAL.rows = RowShard(n_local, n_draw, lo)
    try:
        yield
    finally:
        _LOCAL.rows = prev


def take_rows(x: torch.Tensor, row_axis: int = 0) -> torch.Tensor:
    """This shard's rows of ``x``, whose ``row_axis`` holds ``k`` rows a
    clip of the whole batch the unsplit run draws for; ``x`` itself outside
    a :func:`row_shard`."""
    s = getattr(_LOCAL, "rows", None)
    if s is None:
        return x
    k, rem = divmod(x.shape[row_axis], s.n_draw)
    if rem:
        raise ValueError(f"{x.shape[row_axis]} rows are not rows of "
                         f"{s.n_draw} clips")
    clips = torch.arange(s.lo, s.lo + s.n_local) % s.n_draw
    rows = (clips[:, None] * k + torch.arange(k)).reshape(-1)
    return x.index_select(row_axis, rows.to(x.device))


def take_rows_of(tree):
    """:func:`take_rows` of every tensor of a nested tree whose leading dim
    is the whole batch's clips; the rest (a step's coins) as they are."""
    s = getattr(_LOCAL, "rows", None)
    if s is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return take_rows(tree) if tree.ndim and tree.shape[0] == s.n_draw else tree
    if isinstance(tree, dict):
        return {k: take_rows_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows_of(v) for v in tree)
    return tree


def _draw(fn, shape, row_axis: int, generator, device):
    s = getattr(_LOCAL, "rows", None)
    if s is None:
        return fn(tuple(shape), device)
    shape = list(shape)
    k, rem = divmod(shape[row_axis], s.n_local)
    if rem:
        raise ValueError(f"a draw of {shape[row_axis]} rows does not split "
                         f"into {s.n_local} clips")
    shape[row_axis] = k * s.n_draw
    src = generator.device if generator is not None else device
    return take_rows(fn(tuple(shape), src), row_axis).to(device)


def randn(shape, generator=None, device=None, row_axis: int = 0):
    return _draw(lambda s, d: torch.randn(s, generator=generator, device=d),
                 shape, row_axis, generator, device)


def rand(shape, generator=None, device=None, row_axis: int = 0):
    return _draw(lambda s, d: torch.rand(s, generator=generator, device=d),
                 shape, row_axis, generator, device)


def randint(low, high, shape, generator=None, device=None, row_axis: int = 0):
    return _draw(lambda s, d: torch.randint(low, high, s, generator=generator,
                                            device=d),
                 shape, row_axis, generator, device)


def shares_to_global(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' shares, with its gradient (a global value
    every rank then uses alike: enter it in the loss divided by
    :func:`data_extent`)."""
    st = active()
    if st is None or st.grid.data == 1:
        return x
    return all_reduce_sum(x, st.grid.data_group)


def metrics_to_global(metrics, replicated=()):
    """Each metric a rank's share of, summed over the ranks in one
    all-reduce (detached); the ``replicated`` ones are global already."""
    st = active()
    if st is None or st.grid.data == 1:
        return metrics
    keys = [k for k in metrics if k not in replicated]
    if not keys:
        return metrics
    vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    vec = all_reduce_sum_nograd(vec, st.grid.data_group)
    return dict(metrics, **{k: vec[i] for i, k in enumerate(keys)})
