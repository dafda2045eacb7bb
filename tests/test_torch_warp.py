"""Port parity: the time warp and SpecAugment of ``acvae_tpu_torch`` against
``acvae_tpu``.

* ``time_warp_1d`` on a CPU tensor (its plain PyTorch version) against the
  JAX jnp gather path and against the Pallas kernel in interpret mode, on the
  cases of tests/test_augment.py::TestWarpKernelInterpret; tolerance 1e-6.
* ``time_warp`` and ``build_augment`` on the draws the JAX key recipe makes
  (recomputed here with the JAX package's own draw helpers); atol 5e-4: the
  batched 4×4 spline solve is near-singular (the 1e-10 corner ridge), so
  ``jnp.linalg.solve`` and ``torch.linalg.solve`` give flows that differ by
  up to ~3e-5, which moves the continuous lerp by up to ~1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.ops import specaug as jsa
from acvae_tpu.ops import warp as jw
from acvae_tpu.ops.pallas.warp_kernel import time_warp_1d as j_time_warp_1d
from acvae_tpu_torch.ops import specaug as tsa
from acvae_tpu_torch.ops import warp as tw
from acvae_tpu_torch.ops.cuda import build as tbuild
from acvae_tpu_torch.ops.cuda.warp_kernel import time_warp_1d
from tests.test_torch_decode import one_torch_thread  # noqa: F401


AUG_TOL = dict(rtol=0, atol=5e-4)

WARP_CASES = [  # (B, T, F, max_shift, seed), as in tests/test_augment.py
    (2, 256, 16, 128, 0),
    (2, 64, 16, 64, 1),
    (1, 128, 8, 8, 2),
]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("B,T,F,max_shift,seed", WARP_CASES)
def test_time_warp_1d_matches_jax(B, T, F, max_shift, seed, interpret):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, T, F)).astype(np.float32)
    # flows reach 1.5x max_shift, so the ±max_shift clip is exercised
    flow = (rng.normal(size=(B, T, F)) * max_shift / 2).astype(np.float32)
    ref = j_time_warp_1d(jnp.asarray(img), jnp.asarray(flow),
                         max_shift=max_shift, interpret=interpret)
    out = time_warp_1d(torch.tensor(img), torch.tensor(flow), max_shift)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_cpu_path_never_builds():
    """The CPU path is the plain version: no nvcc, no library, no launch."""
    before = time_warp_1d.launches
    x = torch.randn(1, 8, 4)
    time_warp_1d(x, torch.zeros_like(x))
    assert time_warp_1d.launches == before
    assert not tbuild._LIBS


def test_time_warp_1d_checks_inputs():
    x = torch.randn(1, 8, 4)
    with pytest.raises(TypeError):
        time_warp_1d(x.double(), x.double())
    with pytest.raises(ValueError):
        time_warp_1d(x, x[:, :4])
    with pytest.raises(ValueError):
        time_warp_1d(x[:, :1], x[:, :1])
    with pytest.raises(ValueError, match="unsupported device"):
        time_warp_1d(x.to("meta"), x.to("meta"))   # no silent path
    big = torch.empty((1, 2**31, 1), device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        time_warp_1d(big, big)


def _jax_warp_anchors(key, N, T, W, lens):
    """(pts, dist) exactly as acvae_tpu/ops/warp.py:177-186 draws them."""
    k1, k2 = jax.random.split(key)
    if lens is None:
        pts = jax.random.randint(k1, (N,), W, T - W)
    else:
        span = jnp.maximum(lens - 2 * W, 1)
        pts = W + (jax.random.uniform(k1, (N,)) * span).astype(jnp.int32)
    dist = jax.random.randint(k2, (N,), -W, W)
    return torch.tensor(np.asarray(pts)), torch.tensor(np.asarray(dist))


def _spec_and_lens(seed, N=3, T=64, F=16):
    rng = np.random.default_rng(seed)
    spec = rng.normal(size=(N, T, F)).astype(np.float32)
    lens = np.array([T, T * 7 // 10, T * 9 // 25][:N], np.int32)
    return spec, lens


@pytest.mark.parametrize("use_lens", [False, True])
def test_time_warp_matches_jax(use_lens):
    spec, lens = _spec_and_lens(3)
    N, T, _ = spec.shape
    key = jax.random.key(5)
    jl = jnp.asarray(lens) if use_lens else None
    ref = jw.time_warp(jnp.asarray(spec), key, W_param=8, lens=jl)
    anchors = _jax_warp_anchors(key, N, T, 8, jl)
    out = tw.time_warp(torch.tensor(spec), W_param=8,
                       lens=torch.tensor(lens) if use_lens else None,
                       anchors=anchors)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AUG_TOL)
    assert not np.allclose(out.numpy(), spec)   # the warp did move frames


def _jax_spans(key, max_extent, size, N, num):
    spans = []
    for _ in range(num):
        key, sub = jax.random.split(key)
        spans.append(tuple(torch.tensor(np.asarray(a)) for a in
                           jsa._rand_span(sub, max_extent, size, N)))
    return spans


def jax_augment_draws(key, spec_shape, lens, p=0.2, F=15, W=40, T=30,
                      num_timemask=2, num_freqmask=2):
    """The draws of acvae_tpu.ops.specaug.build_augment(...)(feats, lens,
    key) for [timewarp, timemask, freqmask], as port ``draws``."""
    N, Tmax, Fbins = spec_shape
    _k_crop, _k_roll, k_spec = jax.random.split(key, 3)
    k_gate, k_t, k_f, k_w = jax.random.split(k_spec, 4)
    gate = jax.random.uniform(k_gate, (N,)) < p
    return {"spec": {
        "gate": torch.tensor(np.asarray(gate)),
        "time": _jax_spans(k_t, T, lens, N, num_timemask),
        "freq": _jax_spans(k_f, F, jnp.full((N,), Fbins), N, num_freqmask),
        "warp": _jax_warp_anchors(k_w, N, Tmax, W, lens)}}


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_build_augment_matches_jax(p):
    spec, lens = _spec_and_lens(4)
    kw = dict(p=p, F=4, W=8, T=10)
    augs = ["timewarp", "timemask", "freqmask"]
    key = jax.random.key(9)
    ref, ref_lens = jsa.build_augment(augs, **kw)(jnp.asarray(spec),
                                                  jnp.asarray(lens), key)
    draws = jax_augment_draws(key, spec.shape, jnp.asarray(lens), **kw)
    out, out_lens = tsa.build_augment(augs, **kw)(
        torch.tensor(spec), torch.tensor(lens), draws=draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AUG_TOL)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))


@pytest.mark.parametrize("fn", ["time_mask", "freq_mask"])
def test_masks_match_jax(fn):
    spec, lens = _spec_and_lens(6, N=3, T=40, F=32)
    N, T, F = spec.shape
    key = jax.random.key(2)
    jfn, tfn = getattr(jsa, fn), getattr(tsa, fn)
    ref = jfn(jnp.asarray(spec), key, 20, num_masks=3, lens=jnp.asarray(lens))
    size = jnp.asarray(lens) if fn == "time_mask" else jnp.full((N,), F)
    spans = _jax_spans(key, 20, size, N, 3)
    out = tfn(torch.tensor(spec), 20, num_masks=3, lens=torch.tensor(lens),
              spans=spans)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_random_crop_and_time_roll_match_jax():
    spec, lens = _spec_and_lens(7, N=3, T=40, F=8)
    key = jax.random.key(3)
    ref, ref_lens = jsa.random_crop(jnp.asarray(spec), jnp.asarray(lens), key,
                                    size=20, p=0.9)
    k_gate, k_start = jax.random.split(key)
    u = tuple(torch.tensor(np.asarray(jax.random.uniform(k, (3,))))
              for k in (k_gate, k_start))
    out, out_lens = tsa.random_crop(torch.tensor(spec), torch.tensor(lens),
                                    size=20, p=0.9, u=u)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))

    ref = jsa.time_roll(jnp.asarray(spec), key, std=10.0, lens=jnp.asarray(lens))
    shift = (jax.random.normal(key, (3,)) * 10.0).astype(jnp.int32)
    out = tsa.time_roll(torch.tensor(spec), std=10.0, lens=torch.tensor(lens),
                        shift=torch.tensor(np.asarray(shift)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generator_draws_are_reproducible():
    spec, lens = _spec_and_lens(8)
    fn = tsa.build_augment(["timewarp", "timemask", "freqmask"], p=1.0, W=8)
    outs = [fn(torch.tensor(spec), torch.tensor(lens),
               generator=torch.Generator().manual_seed(0))[0] for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert torch.isfinite(outs[0]).all()
