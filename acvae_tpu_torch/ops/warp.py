"""Polyharmonic-spline time warp (counterpart of ``acvae_tpu/ops/warp.py:29-82,
154-209``).

The spline fit is one batched ``torch.linalg.solve`` on a small dense system
[n+d+1, n+d+1], with the same deterministic 1e-10 corner ridge as the JAX
package (not the reference's ``randn/1e10`` hack).  With one control point
and that ridge the solved flow is a large linear ramp (up to a few hundred
frames before the ±max_shift clip), so it stays in float32 and clipped, as
in JAX.  The dense warp itself is the CUDA kernel
:func:`acvae_tpu_torch.ops.cuda.warp_kernel.time_warp_1d`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d

EPSILON = 1e-10


def phi(r: torch.Tensor) -> torch.Tensor:
    """Order-2 polyharmonic (thin-plate) radial basis of squared distances
    (nb_SparseImageWarp.py:141-166; the warp uses only order 2)."""
    r = torch.clamp_min(r, EPSILON)
    return 0.5 * r * torch.log(r)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x_i - y_j||² pairwise; x: [.., n, d], y: [.., m, d]."""
    xx = torch.sum(x * x, -1)[..., :, None]
    yy = torch.sum(y * y, -1)[..., None, :]
    xy = torch.einsum("...nd,...md->...nm", x, y)
    return torch.clamp_min(xx - 2 * xy + yy, 0.0)


def solve_interpolation(train_points: torch.Tensor, train_values: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the spline: returns (w [B, n, k], v [B, d+1, k])."""
    B, n, d = train_points.shape
    k = train_values.shape[-1]
    c = train_points
    matrix_a = phi(_sq_dists(c, c))                         # [B, n, n]
    ones = torch.ones((B, n, 1), dtype=c.dtype, device=c.device)
    matrix_b = torch.cat([c, ones], dim=-1)                  # [B, n, d+1]
    left = torch.cat([matrix_a, matrix_b.transpose(1, 2)], dim=1)
    corner = torch.eye(d + 1, dtype=c.dtype, device=c.device) * 1e-10
    right = torch.cat([matrix_b, corner.expand(B, d + 1, d + 1)], dim=1)
    lhs = torch.cat([left, right], dim=2)                    # [B, n+d+1, n+d+1]
    rhs = torch.cat([train_values,
                     torch.zeros((B, d + 1, k), dtype=c.dtype, device=c.device)],
                    dim=1)
    X = torch.linalg.solve(lhs, rhs)
    return X[:, :n, :], X[:, n:, :]


def apply_interpolation(query_points: torch.Tensor, train_points: torch.Tensor,
                        w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Evaluate the spline at query points [B, m, d] -> [B, m, k]."""
    rbf = phi(_sq_dists(query_points, train_points)) @ w
    ones = torch.ones_like(query_points[..., :1])
    linear = torch.cat([query_points, ones], dim=-1) @ v
    return rbf + linear


def draw_anchors(N: int, T: int, W_param: int, lens: Optional[torch.Tensor],
                 generator: Optional[torch.Generator], device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp's random anchor (time index) and distance per sample.

    Anchors fall in [W, len-W) (a degenerate len <= 2W clamps to W), the
    distance in [-W, W) (``datasets/augment.py:8-26``)."""
    if lens is None:
        pts = torch.randint(W_param, T - W_param, (N,), generator=generator,
                            device=device)
    else:
        span = torch.clamp_min(lens - 2 * W_param, 1)
        u = torch.rand((N,), generator=generator, device=device)
        pts = W_param + torch.minimum((u * span).long(), span - 1)
    dist = torch.randint(-W_param, W_param, (N,), generator=generator,
                         device=device)
    return pts, dist


def warp_flow(spec: torch.Tensor, W_param: int = 5,
              lens: Optional[torch.Tensor] = None,
              anchors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The time-axis flow [N, T, F] that :func:`time_warp` hands the kernel.

    A time anchor on the centre-frequency row is displaced by a distance
    (``anchors = (pts, dist)``, drawn by :func:`draw_anchors` when None);
    the spline through that one control point gives a dense flow.  Only its
    time component is evaluated: the control point has zero frequency flow.
    With ``lens`` the flow is folded so that gather queries clamp to each
    sample's own edge (len-2), as the reference warps the unpadded sample.
    """
    N, T, F = spec.shape
    dev, dt = spec.device, spec.dtype
    if anchors is None:
        anchors = draw_anchors(N, T, W_param, lens, generator, dev)
    pts, dist = (a.to(dev) for a in anchors)
    y = torch.full((N,), F // 2, dtype=dt, device=dev)
    # control points in (y=freq, x=time) image coordinates
    src = torch.stack([y, pts.to(dt)], -1)[:, None, :]
    dst = torch.stack([y, (pts + dist).to(dt)], -1)[:, None, :]
    w, v = solve_interpolation(dst, dst - src)
    gy, gx = torch.meshgrid(torch.arange(F, dtype=dt, device=dev),
                            torch.arange(T, dtype=dt, device=dev), indexing="ij")
    grid = torch.stack([gy, gx], -1).reshape(1, F * T, 2).expand(N, F * T, 2)
    dense = apply_interpolation(grid, dst, w, v).reshape(N, F, T, 2)
    flow_t = dense[..., 1].transpose(1, 2)                   # [N, T, F]
    if lens is None:
        return flow_t.contiguous()
    t_idx = torch.arange(T, dtype=dt, device=dev)[None, :, None]
    edge = torch.clamp_min(lens - 2, 0).to(dt)[:, None, None]
    q = torch.minimum(torch.clamp_min(t_idx - flow_t, 0.0), edge)
    return (t_idx - q).contiguous()


def time_warp(spec: torch.Tensor, W_param: int = 5, max_shift: int = 64,
              lens: Optional[torch.Tensor] = None,
              anchors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment time warp on batched mel specs [N, T, F] (see
    :func:`warp_flow`).  With ``lens`` frames beyond each length keep their
    values.  As in the JAX package the anchor's time index (not the
    reference's spectrogram value, augment.py:18) is the warp coordinate."""
    flow_t = warp_flow(spec, W_param, lens, anchors, generator)
    out = time_warp_1d(spec.contiguous(), flow_t, max_shift)
    if lens is None:
        return out
    valid = (torch.arange(spec.shape[1], device=spec.device)[None, :, None]
             < lens[:, None, None])
    return torch.where(valid, out, spec)
