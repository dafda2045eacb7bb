"""Batched SpecAugment on the device (counterpart of
``acvae_tpu/ops/specaug.py:34-218``).

The reference runs SpecAugment per sample in NumPy on *unpadded* [T, F]
samples (``datasets/augment.py``).  Here every transform is a batched op on
the padded buffer that takes the per-sample valid length ``lens`` and keeps
the reference's unpadded semantics:

* :func:`freq_mask` / :func:`time_mask` — augment.py:29-66.  Reference
  quirks kept: the drawn width ``f`` only bounds the mask (the masked span
  is ``[f0, randrange(f0, f0+f))``); a drawn width of 0 skips that mask AND
  every remaining mask of the call (augment.py:39,59); the mean fill is
  recomputed from the *current* (partly masked) values at each mask, over
  the sample's valid frames only.
* :func:`spec_augment` — the p-gated combinator (augment.py:69-82), gated
  per sample.
* :func:`random_crop` — augment.py:93-101.  A sample is cropped only when
  it is longer than ``size`` AND wins the p-coin; the window moves to the
  front, the buffer keeps its static time size, zeros beyond the new length.
* :func:`time_roll` — augment.py:103-111, rolling within the valid frames.
* :func:`gaussian_noise` — augment.py:85-91, additive noise at an SNR over
  the valid frames (no augment list names it).

Randomness: every transform takes its draws as optional tensors (``spans``,
``anchors``, ``u``, ``shift``, ``noise``, or a ``draws`` dict for the combinators) and
draws them from ``generator`` when they are not given, so tests can feed
the JAX package's exact draws.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from acvae_tpu_torch.ops.warp import time_warp
from acvae_tpu_torch.parallel import state as pstate

Span = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (start, end, width)


def _span_mask(length: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """[N] starts/ends -> [N, length] bool mask of [start, end)."""
    idx = torch.arange(length, device=start.device)[None, :]
    return (idx >= start[:, None]) & (idx < end[:, None])


def _uniform_int(hi: torch.Tensor, generator, device) -> torch.Tensor:
    """One integer in [0, hi) per entry of hi (hi >= 1)."""
    u = pstate.rand(hi.shape, generator, device)
    return torch.minimum((u * hi).long(), hi - 1)


def draw_span(max_extent: int, axis_size: torch.Tensor, n: int,
              generator: Optional[torch.Generator], device) -> Span:
    """Reference extent sampling (augment.py:34-41): f ~ U[0, max_extent),
    f0 ~ U[0, size - f), end ~ U[f0, f0 + f).  Returns (f0, end, f)."""
    f = pstate.randint(0, max_extent, (n,), generator, device)
    f0 = _uniform_int(torch.clamp_min(axis_size.to(device) - f, 1), generator,
                      device)
    u = pstate.rand((n,), generator, device)
    end = f0 + (u * torch.clamp_min(f, 1)).long()
    return f0, end, f


def _valid_mean(spec: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample mean over the valid [0, len) frames, [N, 1, 1]."""
    if lens is None:
        return spec.mean(dim=(1, 2), keepdim=True)
    N, Tmax, Fbins = spec.shape
    valid = (torch.arange(Tmax, device=spec.device)[None, :] < lens[:, None])
    total = torch.sum(torch.where(valid[:, :, None], spec, 0.0), dim=(1, 2),
                      keepdim=True)
    count = (lens * Fbins).reshape(N, 1, 1).to(spec.dtype)
    return total / torch.clamp_min(count, 1.0)


def _apply_masks(spec, axis, max_extent, num_masks, replace_with_zero, lens,
                 spans, generator):
    N, Tmax, Fbins = spec.shape
    length = Tmax if axis == 1 else Fbins
    if axis == 1 and lens is not None:
        size = lens
    else:
        size = torch.full((N,), length, device=spec.device)
    dead = torch.zeros((N,), dtype=torch.bool, device=spec.device)
    for i in range(num_masks):
        if spans is not None:
            f0, end, f = (s.to(spec.device) for s in spans[i])
        else:
            f0, end, f = draw_span(max_extent, size, N, generator, spec.device)
        dead = dead | (f == 0)
        fill = 0.0 if replace_with_zero else _valid_mean(spec, lens)
        m = _span_mask(length, f0, end)
        m = m[:, :, None] if axis == 1 else m[:, None, :]
        spec = torch.where(m & ~dead[:, None, None], fill, spec)
    return spec


def freq_mask(spec: torch.Tensor, F: int = 30, num_masks: int = 1,
              replace_with_zero: bool = False,
              lens: Optional[torch.Tensor] = None,
              spans: Optional[Sequence[Span]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """spec: [N, T, Fbins]; ``lens`` scopes the mean fill to valid frames."""
    return _apply_masks(spec, 2, F, num_masks, replace_with_zero, lens, spans,
                        generator)


def time_mask(spec: torch.Tensor, T: int = 40, num_masks: int = 1,
              replace_with_zero: bool = False,
              lens: Optional[torch.Tensor] = None,
              spans: Optional[Sequence[Span]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """spec: [N, Tmax, F]; masks fall within each sample's valid length."""
    return _apply_masks(spec, 1, T, num_masks, replace_with_zero, lens, spans,
                        generator)


def spec_augment(spec: torch.Tensor, lens: Optional[torch.Tensor] = None,
                 timemask: bool = True, num_timemask: int = 2,
                 freqmask: bool = True, num_freqmask: int = 2,
                 timewarp: bool = False,
                 F: int = 15, W: int = 40, T: int = 30, p: float = 0.2,
                 draws: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """p-gated per-sample SpecAugment (augment.py:69-82).

    ``draws`` may hold ``gate`` ([N] bool), ``time`` / ``freq`` (lists of
    spans) and ``warp`` ((pts, dist)); missing ones come from ``generator``.
    The warp runs on the whole batch and the gate selects afterwards."""
    draws = draws or {}
    N = spec.shape[0]
    gate = draws.get("gate")
    if gate is None:
        gate = pstate.rand((N,), generator, spec.device) < p
    out = spec
    if timemask and num_timemask > 0:
        out = time_mask(out, T=T, num_masks=num_timemask, lens=lens,
                        spans=draws.get("time"), generator=generator)
    if freqmask and num_freqmask > 0:
        out = freq_mask(out, F=F, num_masks=num_freqmask, lens=lens,
                        spans=draws.get("freq"), generator=generator)
    if timewarp:
        out = time_warp(out, W_param=W, lens=lens, anchors=draws.get("warp"),
                        generator=generator)
    return torch.where(gate.to(spec.device)[:, None, None], out, spec)


def random_crop(spec: torch.Tensor, lens: torch.Tensor, size: int = 1000,
                p: float = 0.2,
                u: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
    """Per-sample random window of ``size`` frames (augment.py:93-101).

    ``u = (u_gate, u_start)``: two [N] uniforms.  Returns (spec, new_lens)."""
    N, Tmax, _ = spec.shape
    dev = spec.device
    if u is None:
        u = (pstate.rand((N,), generator, dev),
             pstate.rand((N,), generator, dev))
    u_gate, u_start = (x.to(dev) for x in u)
    gate = (u_gate <= p) & (lens > size)
    hi = torch.clamp_min(lens - size, 1)
    start = torch.where(gate, (u_start * hi).long(), 0)
    t = torch.arange(Tmax, device=dev)[None, :]
    idx = (t + start[:, None]) % Tmax        # roll the window to the front
    shifted = torch.take_along_dim(spec, idx[:, :, None], dim=1)
    new_lens = torch.where(gate, size, lens)
    valid = (t < new_lens[:, None])[:, :, None]
    out = torch.where(gate[:, None, None], torch.where(valid, shifted, 0.0), spec)
    return out, new_lens


def time_roll(x: torch.Tensor, mean: float = 0.0, std: float = 10.0,
              lens: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample circular shift along time (augment.py:103-111), within the
    valid [0, len) frames when ``lens`` is given.  ``shift``: [N] int."""
    N, T = x.shape[0], x.shape[1]
    dev = x.device
    if shift is None:
        shift = (pstate.randn((N,), generator, dev) * std
                 + mean).to(torch.int32)
    size = lens if lens is not None else torch.full((N,), T, device=dev)
    t = torch.arange(T, device=dev)[None, :]
    idx = (t - shift.to(dev).long()[:, None]) % torch.clamp_min(size[:, None], 1)
    idx = torch.where(t < size[:, None], idx, t)
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)),
                                dim=1)


def gaussian_noise(x: torch.Tensor, snr: float = 30.0, mean: float = 0.0,
                   lens: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Additive noise at the given SNR (augment.py:85-91;
    ``acvae_tpu/ops/specaug.py:196-218``): the energies are over each
    sample's valid frames, divided by its length, and the noise stays in
    them.  ``noise`` is the standard normal draw of ``x``'s shape (from
    ``generator`` when not given).  No augment list reaches it, in either
    package."""
    N, T = x.shape[0], x.shape[1]
    dev = x.device
    if noise is None:
        noise = pstate.randn(x.shape, generator, dev)
    if lens is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=dev)
        denom = torch.full((N,), T, dtype=x.dtype, device=dev)
    else:
        valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
        valid = valid.reshape(valid.shape + (1,) * (x.ndim - 2))
        denom = lens.to(x.dtype)
    denom = denom.reshape((-1,) + (1,) * (x.ndim - 1))
    dims = tuple(range(1, x.ndim))
    e_x = torch.sum(torch.where(valid, x, 0.0) ** 2, dim=dims,
                    keepdim=True) / denom
    noise = torch.where(valid, noise.to(dev) + mean, 0.0)
    e_n = torch.sum(noise ** 2, dim=dims, keepdim=True) / denom
    alpha = torch.sqrt(e_x / torch.clamp_min(e_n * 10.0 ** (snr / 10.0), 1e-12))
    return x + alpha * noise


def build_augment(augment_list: List[str], crop_size: int = 1000,
                  crop_p: float = 0.2, roll_std: float = 10.0, **spec_kwargs):
    """Config strings -> one augmentation fn (``parse_augments``,
    utils/train_util.py:92-114): "timemask" / "freqmask" / "timewarp"
    enable the SpecAugment parts; "randomcrop" and "timeroll" run first.

    Returns ``fn(feats [N,T,F], lens [N], draws=None, generator=None) ->
    (feats, lens)``; ``draws`` may hold ``crop`` (u pair), ``roll`` (shift)
    and ``spec`` (the :func:`spec_augment` dict)."""
    known = {"timemask", "freqmask", "timewarp", "randomcrop", "timeroll"}
    unknown = set(augment_list) - known
    if unknown:
        raise NotImplementedError(f"augments {sorted(unknown)} are not ported")
    timemask = "timemask" in augment_list
    freqmask = "freqmask" in augment_list
    timewarp = "timewarp" in augment_list
    use_crop = "randomcrop" in augment_list
    use_roll = "timeroll" in augment_list

    def fn(feats, lens, draws: Optional[Dict] = None,
           generator: Optional[torch.Generator] = None):
        draws = draws or {}
        if use_crop:
            feats, lens = random_crop(feats, lens, size=crop_size, p=crop_p,
                                      u=draws.get("crop"), generator=generator)
        if use_roll:
            feats = time_roll(feats, std=roll_std, lens=lens,
                              shift=draws.get("roll"), generator=generator)
        feats = spec_augment(feats, lens=lens, timemask=timemask,
                             freqmask=freqmask, timewarp=timewarp,
                             draws=draws.get("spec"), generator=generator,
                             **spec_kwargs)
        return feats, lens

    return fn
