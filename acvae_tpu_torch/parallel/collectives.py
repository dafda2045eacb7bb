"""The collectives of the parallel step, with their gradients.

Every rank's loss is its share of the global loss, so that the sum of the
ranks' gradients is the gradient of the global loss.  Where ranks of a
model group compute the same thing (everything downstream of a vocab or
time split), the copies count once.  So:

* :func:`all_reduce_sum` — forward sum, backward sum: a global statistic
  (BatchNorm's sums, the per-dimension KL) that every rank's own rows use;
* :func:`reduce_to_replicated` — forward sum, backward identity: partial
  results of a split whose sum every rank of the group then uses alike (a
  vocab-parallel lookup, the log-softmax's sum of exponentials);
* :func:`copy_to_split` — forward identity, backward sum: a replicated
  input of a split computation (the classifier's input under vocab
  parallelism);
* :func:`gather_replicated` — forward all-gather, backward the own slice:
  shards that every rank of the group then uses alike (the logits for a
  decode, ``audio_embeds`` under sequence parallelism);
* :func:`gather_split` — forward all-gather, backward sum then the own
  slice: shards that every rank then uses differently (the keys and values
  that each rank's own queries read under sequence parallelism, each
  frame's gradient the sum of every rank's queries' terms);
* :func:`halo_exchange` — the neighbours' edge frames of a time-split
  activation, ``prev`` frames before and ``nxt`` after, ``fill`` at the
  outer edges; backward returns each halo's gradient to the rank it came
  from.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used, which NCCL
and gloo both take on CUDA tensors; bfloat16 travels as float32 (exact).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = _wire(x).clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    w = _wire(x).contiguous()
    out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, w, group=group)
    return [o.to(x.dtype) for o in out]


def all_reduce_sum_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, detached (counts, metrics)."""
    return _all_reduce(x.detach(), group)


def all_reduce_max_nograd(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


class _SumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumId(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size, ctx.group = dim, x.shape[dim], group
        ctx.index = dist.get_rank(group)
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _SumSum.apply(x, group)


def reduce_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _SumId.apply(x, group)


def copy_to_split(x: torch.Tensor, group) -> torch.Tensor:
    return _IdSum.apply(x, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherOwn.apply(x, dim, group)


def gather_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherSum.apply(x, dim, group)


class _Halo(torch.autograd.Function):
    """x [..., T, ...] split along ``dim`` over the group -> (the previous
    shard's last ``prev`` frames, the next shard's first ``nxt`` frames),
    ``fill`` past the ends."""

    @staticmethod
    def forward(ctx, x, dim, group, prev, nxt, fill):
        T = x.shape[dim]
        if max(prev, nxt) > T:
            raise ValueError(f"a halo of {prev} and {nxt} frames needs shards "
                             f"of at least that many; these hold {T}")
        i, n = dist.get_rank(group), dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, i, n
        ctx.prev, ctx.nxt, ctx.T = prev, nxt, T
        # each shard's edges: its first nxt frames, then its last prev
        edges = torch.cat([x.narrow(dim, 0, nxt), x.narrow(dim, T - prev, prev)],
                          dim=dim)
        ctx.edge_shape = edges.shape
        got = _all_gather(edges, group)

        def outer(k):
            shape = list(x.shape)
            shape[dim] = k
            return torch.full(shape, fill, dtype=x.dtype, device=x.device)
        before = got[i - 1].narrow(dim, nxt, prev) if i > 0 else outer(prev)
        after = got[i + 1].narrow(dim, 0, nxt) if i < n - 1 else outer(nxt)
        return before, after

    @staticmethod
    def backward(ctx, g_prev, g_next):
        dim, i, p, q = ctx.dim, ctx.index, ctx.prev, ctx.nxt
        # every rank's halo gradients in its neighbours' edge slots, summed
        buf = [torch.zeros(ctx.edge_shape, dtype=g_prev.dtype, device=g_prev.device)
               for _ in range(ctx.n)]
        if i > 0:
            buf[i - 1].narrow(dim, q, p).copy_(g_prev)
        if i < ctx.n - 1:
            buf[i + 1].narrow(dim, 0, q).copy_(g_next)
        mine = _all_reduce(torch.stack(buf), ctx.group)[i]
        shape = list(ctx.edge_shape)
        shape[dim] = ctx.T
        gx = torch.zeros(shape, dtype=g_prev.dtype, device=g_prev.device)
        gx.narrow(dim, 0, q).add_(mine.narrow(dim, 0, q))
        gx.narrow(dim, ctx.T - p, p).add_(mine.narrow(dim, q, p))
        return gx, None, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, group, prev: int, nxt: int,
                  fill: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _Halo.apply(x, dim, group, prev, nxt, fill)
