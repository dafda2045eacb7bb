"""Port parity: masked ops, losses and schedules of ``acvae_tpu_torch``
against ``acvae_tpu`` on the same seeded numpy inputs.

Tolerance rtol=1e-5, atol=1e-6: the two sides run the same float32 formulas
and differ only in reduction order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.ops import losses as jl
from acvae_tpu.ops import masked as jm
from acvae_tpu.train import schedules as js
from acvae_tpu.train import trainer as jt
from acvae_tpu_torch.ops import losses as tl
from acvae_tpu_torch.ops import masked as tm
from acvae_tpu_torch.train import schedules as ts

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **TOL)


def _lens(rng, n, t):
    return rng.integers(0, t + 1, size=n).astype(np.int32)


@pytest.mark.parametrize("shape", [(4, 7), (4, 7, 5)])
@pytest.mark.parametrize("fn", ["mean_with_lens", "max_with_lens"])
def test_masked_reductions(fn, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    lens = _lens(rng, shape[0], shape[1])
    lens[0] = shape[1]
    if fn == "max_with_lens":
        lens = np.maximum(lens, 1)  # an all-masked max is finfo.min on both
    _close(getattr(tm, fn)(torch.tensor(x), torch.tensor(lens)),
           getattr(jm, fn)(jnp.asarray(x), jnp.asarray(lens)))


def test_length_mask():
    lens = np.array([0, 3, 7, 2], np.int32)
    np.testing.assert_array_equal(
        tm.length_mask(torch.tensor(lens), 7).numpy(),
        np.asarray(jm.length_mask(jnp.asarray(lens), 7)))


def _ce_inputs(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 6, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(3, 6)).astype(np.int32)
    mask = (rng.uniform(size=(3, 6)) < 0.7) if masked else None
    return logits, targets, mask


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    logits, targets, mask = _ce_inputs(masked)
    _close(tl.cross_entropy(_t(logits), _t(targets), _t(mask)),
           jl.cross_entropy(_j(logits), _j(targets), _j(mask)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss(masked, smoothing):
    logits, targets, mask = _ce_inputs(masked)
    _close(tl.label_smoothing_loss(_t(logits), _t(targets), smoothing, _t(mask)),
           jl.label_smoothing_loss(_j(logits), _j(targets), smoothing, _j(mask)))


def _kl_inputs(kl_mask):
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=(3, 5, 8)).astype(np.float32) for _ in range(4)]
    # kl_mask modes of make_train_step: "valid" masks to cap_lens-1,
    # "reference" averages over every (padded) position
    lens = np.array([5, 2, 0], np.int32)
    mask = (np.arange(5)[None] < lens[:, None]) if kl_mask == "valid" else None
    return arrs, mask


@pytest.mark.parametrize("kl_mask", ["valid", "reference"])
@pytest.mark.parametrize("fn", ["normal_kl_loss", "normal_kl_per_dim"])
def test_normal_kl(fn, kl_mask):
    arrs, mask = _kl_inputs(kl_mask)
    _close(getattr(tl, fn)(*map(_t, arrs), _t(mask)),
           getattr(jl, fn)(*map(_j, arrs), _j(mask)))


@pytest.mark.parametrize("total,warmup,linear",
                         [(10_000, 3000, False), (500, 3000, False),
                          (10_000, 3000, True)])
def test_exponential_decay_schedule(total, warmup, linear):
    port = ts.exponential_decay_schedule(5e-4, total, 1e-5, warmup, linear)
    ref = js.exponential_decay_schedule(5e-4, total, 1e-5, warmup, linear)
    for step in (0, 1, 49, 2999, 3000, 9999):
        np.testing.assert_allclose(port(step), float(ref(jnp.asarray(step))),
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["exponential", "linear", "none"])
def test_recipe_schedules(mode):
    for it in (0, 7, 100):
        assert ts.ss_ratio_at(it, 1.0, mode, 100, 0.7) == pytest.approx(
            jt.ss_ratio_at(it, 1.0, mode, 100, 0.7))
    for epoch in range(1, 26):
        assert ts.dis_ratio_for_epoch(epoch, 25, 10, 0.3) == \
            jt.dis_ratio_for_epoch(epoch, 25, 10, 0.3)
        assert ts.kl_weight_for_epoch(epoch, 25, 0.5) == \
            jt.kl_weight_for_epoch(epoch, 25, 0.5)
