"""Port parity: A21, the rest of ``cli train``'s schedules and the library
leftovers of ``acvae_tpu_torch`` against ``acvae_tpu``: ``NoamScheduler``,
``WarmupLinearSchedule`` and ``WarmupCosineSchedule`` in closed form, the
constant ``base_lr`` of an unregistered scheduler name, ``gaussian_noise``
(fed JAX's normal draws) and ``masked_softmax``.  RMSprop's ``centered``
and ``bias_correction`` are cases of
``tests/test_torch_train_extras.py::test_optimizer_matches_optax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.ops.masked import masked_softmax as j_masked_softmax
from acvae_tpu.ops.specaug import gaussian_noise as j_gaussian_noise
from acvae_tpu.train import schedules as js
from acvae_tpu_torch.ops.masked import masked_softmax
from acvae_tpu_torch.ops.specaug import gaussian_noise
from acvae_tpu_torch.train import schedules as ts
from acvae_tpu_torch.train.trainer import build_optimizer

STEPS = np.arange(2001)

# name -> scheduler_args (each crosses its warmup within the 2001 steps)
SCHEDULES = {
    "NoamScheduler": {"model_size": 256, "warmup_iters": 400},
    "WarmupLinearSchedule": {"warmup_steps": 300, "gamma": 0.7,
                             "update_epoch": 250},
    "WarmupCosineSchedule": {"warmup_steps": 200, "t_total": 1800,
                             "cycles": 0.5},
    "ExponentialDecayScheduler": {"total_iters": 2000, "final_lr": 1e-5,
                                  "warmup_iters": 300},
    "constant": {},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """Steps 0-2000 against JAX's float32 closed form, the reference's
    ``step + 1`` offset included: rtol 1e-6, plus atol 1e-7·base_lr where
    a float32 sum cancels (the cosine's tail, ``1 + cos`` near 0: JAX is
    3.5e-11 off there, 1% of a value near 0; the port computes in float64,
    as the reference's LambdaLR does)."""
    args = SCHEDULES[name]
    ref = js.SCHEDULES.build(name, base_lr=5e-4, **args)
    want = np.asarray(jax.vmap(lambda s: jnp.asarray(ref(s), jnp.float32))(
        jnp.asarray(STEPS)))
    port = ts.build_schedule(name, 5e-4, **args)
    got = np.array([port(int(s)) for s in STEPS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * 5e-4)


@pytest.mark.parametrize("name", ["ReduceLROnPlateau", "MyScheduler"])
def test_unregistered_scheduler_trains_at_base_lr(name):
    """A name outside the registry trains at the constant ``base_lr``
    (``acvae_tpu/cli/main.py:249-252``), whatever its arguments; only
    ``ExponentialDecayScheduler`` takes the run's ``total_iters``."""
    assert name not in js.SCHEDULES
    w = torch.nn.Parameter(torch.ones(3))
    conf = {"optimizer": "SGD", "optimizer_args": {"lr": 0.25},
            "scheduler": name, "scheduler_args": {"patience": 2, "x": 1}}
    opt = build_optimizer(conf, [("w", w)], total_iters=10)
    for _ in range(3):
        assert opt.lr() == 0.25
        w.grad = torch.ones(3)
        opt.step()
    assert torch.allclose(w.detach(), torch.full((3,), 1 - 3 * 0.25))
    conf.update(scheduler="ExponentialDecayScheduler",
                scheduler_args={"final_lr": 1e-5, "warmup_iters": 1})
    want = ts.exponential_decay_schedule(0.25, 10, 1e-5, 1)
    assert build_optimizer(conf, [("w", w)], total_iters=10).lr() == want(0)


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
def test_gaussian_noise_matches_jax(with_lens):
    x = np.random.default_rng(0).normal(size=(3, 20, 8)).astype(np.float32)
    lens = np.array([20, 11, 5], np.int32) if with_lens else None
    key = jax.random.key(4)
    want = np.asarray(j_gaussian_noise(jnp.asarray(x), key, snr=20.0, mean=0.1,
                                       lens=None if lens is None
                                       else jnp.asarray(lens)))
    noise = torch.tensor(np.asarray(jax.random.normal(key, x.shape)))
    got = gaussian_noise(torch.tensor(x), snr=20.0, mean=0.1, noise=noise,
                         lens=None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if with_lens:   # the padding stays zero-noise
        np.testing.assert_array_equal(got.numpy()[2, 5:], x[2, 5:])


def test_masked_softmax_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(4, 6)).astype(np.float32) * 5
    mask = rng.random((4, 6)) > 0.3
    mask[:, 0] = True
    for axis in (-1, 0):
        want = np.asarray(j_masked_softmax(jnp.asarray(scores),
                                           jnp.asarray(mask), axis=axis))
        got = masked_softmax(torch.tensor(scores), torch.tensor(mask), axis=axis)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
