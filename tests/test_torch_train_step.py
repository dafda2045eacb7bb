"""Port parity: the flagship forward and train step of ``acvae_tpu_torch``
against ``acvae_tpu``.

Noise protocol (torch cannot reproduce ``jax.random``): the JAX side runs
with its own keys; the port is handed the same draws — latent noise
recovered from the JAX outputs (eps = (z - mean) / exp(½·log)), coins made
deterministic by the ratios (ss 1 / dis 0 = all teacher, no grounding;
ss 0 / dis 1 = all feedback, full grounding), augment draws recomputed with
the JAX key recipe.  Cnn10's dropouts are patched to identity on the JAX
side and set to 0 in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acvae_tpu.core.config import load_config
from acvae_tpu.models import encoders as jenc
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.ops.specaug import build_augment as j_build_augment
from acvae_tpu.train.pretrained import (acvae_to_flax, flatten_params,
                                        merge_pretrained)
from acvae_tpu.train.schedules import exponential_decay_schedule
from acvae_tpu.train.trainer import TrainState, build_optimizer, make_train_step
from acvae_tpu_torch.configs import FLAGSHIP_CONF, flagship_conf
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.train.trainer import Trainer, apply_gradients, make_optimizer
from tests.test_torch_warp import jax_augment_draws

V, E, N, TMEL, FDIM, L = 25, 16, 3, 64, 16, 8
AUG_ARGS = {"p": 1.0, "W": 8, "T": 10, "F": 4}
SMALL = dict(
    encoder_args={"embed_size": E, "channels": (4, 8, 8, 16)},
    decoder_args={"embed_size": E, "hidden_size": E, "dropout": 0.0},
    model_args={"posterior_model": "PosteriorRNN_hybrid",
                "posterior_args": {"hidden_size": E},
                "prior_model": "PriorRNN", "prior_args": {"hidden_size": E}},
    augment_args=AUG_ARGS,
    max_grad_norm=1e9)   # no clip here: the grads are compared raw
PORT_ENC = {"conv_dropout": 0.0, "head_dropout": 0.0}


def test_flagship_conf_matches_yaml():
    ref = load_config("configs/ac_vae.yaml",
                      augments="[timewarp,timemask,freqmask]")
    assert dict(ref) == FLAGSHIP_CONF


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(N, TMEL, FDIM)).astype(np.float32),
            "feat_lens": np.array([TMEL, 48, 33], np.int32),
            "caps": rng.integers(3, V, size=(N, L)).astype(np.int32),
            "cap_lens": np.array([L, 5, 3], np.int32)}


def _port_conf(conf):
    conf = flagship_conf(**conf)
    conf["encoder_args"] = dict(conf["encoder_args"], **PORT_ENC)
    return conf


@pytest.fixture(scope="module")
def jax_model():
    conf = flagship_conf(**SMALL)
    model = j_build_model(conf, V, FDIM)
    b = _batch()
    variables = jax.jit(lambda k1, k2: model.init(
        {"params": k1, "sample": k2}, b["feats"], b["feat_lens"], b["caps"],
        b["cap_lens"], train=False))(jax.random.key(0), jax.random.key(1))
    return conf, model, variables


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jenc._DropoutMixin, "_dropout",
                        lambda self, x, rate, train: x)


def _jax_forward(model, variables, b, key, ss_ratio, dis_ratio):
    fn = jax.jit(lambda v, k: model.apply(
        v, b["feats"], b["feat_lens"], b["caps"], b["cap_lens"],
        ss_ratio=ss_ratio, dis_ratio=dis_ratio, train=True,
        rngs={"sample": k}, mutable=["batch_stats"]))
    out, _ = fn(variables, key)
    return jax.tree_util.tree_map(np.asarray, out)


def _recovered_noise(out, ss_ratio, dis_ratio):
    """Noise of a JAX train_forward, recovered from its outputs."""
    T = out["logits"].shape[1]

    def eps(z, mean, log):
        return torch.tensor((z - mean) / np.exp(0.5 * log))

    return {"q_eps": eps(out["q_z"], out["q_means"], out["q_logs"]),
            "p_eps": eps(out["p_z"], out["p_means"], out["p_logs"]
                         ).transpose(0, 1).contiguous(),
            "ss_coins": torch.full((T,), ss_ratio >= 1.0),
            "dis_coins": torch.full((T,), dis_ratio > 0.0)}


@pytest.mark.parametrize("ss_ratio,dis_ratio", [(1.0, 0.0), (0.0, 1.0)],
                         ids=["teacher", "feedback"])
def test_train_forward_matches_jax(jax_model, no_jax_dropout, ss_ratio,
                                   dis_ratio):
    conf, model, variables = jax_model
    b = _batch(1)
    ref = _jax_forward(model, variables, b, jax.random.key(4), ss_ratio,
                       dis_ratio)
    port = build_model(_port_conf(SMALL), V, FDIM, device="cpu")
    port.load_state_dict(from_flax(variables), strict=True)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    out = port.train_forward(tb["feats"], tb["feat_lens"], tb["caps"],
                             tb["cap_lens"], ss_ratio, dis_ratio,
                             noise=_recovered_noise(ref, ss_ratio, dis_ratio))
    for k in ("logits", "p_means", "p_logs", "p_z", "q_means", "q_logs", "q_z",
              "q_means_utt", "p_means_utt"):
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k], rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["seqs"].numpy(), ref["seqs"])


def _capture_grads():
    """An optax transformation whose state is the last gradient it saw and
    whose update is zero: the JAX step then hands back its raw grads."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda params: zeros(params),
        lambda updates, state, params=None: (zeros(updates), updates))


def test_train_step_matches_jax(jax_model, no_jax_dropout):
    """One full step with the time-warp augment on: loss and every metric
    to rtol 1e-4, grads to rtol 1e-3 / atol 1e-6, BN batch_stats to 1e-5."""
    conf, model, variables = jax_model
    b = _batch(2)
    augs = conf["augments"]
    step = make_train_step(model, smoothing=0.1, kl_mask="valid", alpha=0.5,
                           augment=j_build_augment(augs, crop_size=992,
                                                   **AUG_ARGS),
                           donate=False)
    rng = jax.random.key(11)
    state = TrainState.create(variables, _capture_grads())
    new_state, ref_m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            rng, 1.0, 0.0, 0.5, 0.5)

    # the JAX step's draws: augment from k_aug, model noise from k_sample
    k_sample, _k_dropout, k_aug, _k_adv = jax.random.split(rng, 4)
    feats, lens = j_build_augment(augs, crop_size=992, **AUG_ARGS)(
        jnp.asarray(b["feats"]), jnp.asarray(b["feat_lens"]), k_aug)
    out = _jax_forward(model, variables, dict(b, feats=feats, feat_lens=lens),
                       k_sample, 1.0, 0.0)
    draws = jax_augment_draws(k_aug, b["feats"].shape,
                              jnp.asarray(b["feat_lens"]), **AUG_ARGS)

    trainer = Trainer(_port_conf(SMALL), V, FDIM, device="cpu", total_iters=100)
    trainer.model.load_state_dict(from_flax(variables), strict=True)
    metrics = trainer.step(b, iteration=1, epoch=1, draws=draws,
                           noise=_recovered_noise(out, 1.0, 0.0))

    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref_grads = from_flax({"params": new_state.opt_state})
    # the JAX stem's padded lane reads only zeros: its grad is zero, and the
    # port keeps that lane as a buffer, not a parameter
    assert not ref_grads.pop("encoder.stem_pad_lanes").any()
    named = dict(trainer.model.named_parameters())
    assert set(ref_grads) == set(named)
    for k, g in ref_grads.items():
        # a parameter off the loss path (the pooled head) has no grad in
        # torch and a zero grad in JAX
        grad = named[k].grad
        grad = torch.zeros_like(g) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    ref_stats = from_flax({"batch_stats": new_state.batch_stats})
    sd = trainer.model.state_dict()
    for k, s in ref_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), s.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_adam_with_clip_matches_optax():
    """Given identical grads, the port's clip + Adam reproduces optax's
    update (the JAX recipe's chain) to 1e-6, across steps whose grad norms
    fall above and below the clip."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    schedule = exponential_decay_schedule(5e-4, 100, 1e-5, 10)
    tx = build_optimizer("Adam", schedule, max_grad_norm=1.0)
    j_params, j_state = jax.tree_util.tree_map(jnp.asarray, params), None
    j_state = tx.init(j_params)
    t_params = [torch.tensor(params[k], requires_grad=True) for k in shapes]
    opt = make_optimizer(t_params, 5e-4)
    for step, scale in enumerate((3.0, 0.05, 1.7, 0.2)):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, k in zip(t_params, shapes):
            p.grad = torch.tensor(grads[k])
        norm = apply_gradients(opt, float(schedule(step)), 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for p, k in zip(t_params, shapes):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(j_params[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def test_weights_round_trip():
    """JAX variables -> from_flax -> port state_dict -> acvae_to_flax ->
    merge_pretrained loads every JAX leaf and gives back the same values
    (at the reference widths, whose PANN block names acvae_to_flax knows)."""
    conf = flagship_conf(encoder_args={"embed_size": 512})
    model = j_build_model(conf, V, FDIM)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 32, FDIM)).astype(np.float32)
    caps = rng.integers(3, V, size=(2, 6)).astype(np.int32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "sample": k}, feats, np.array([32, 16]), caps,
        np.array([6, 4]), train=False))(jax.random.key(0))
    variables = jax.tree_util.tree_map(np.array, variables)
    # the JAX stem's zero-padded input lane only ever multiplies zeros;
    # acvae_to_flax pads with zeros, so start from a zero pad lane too
    variables["params"]["encoder"]["block0_64"]["conv1"]["kernel"][:, :, 1:] = 0
    port = build_model(conf, V, FDIM, device="cpu")
    port.load_state_dict(from_flax(variables), strict=True)

    tree = acvae_to_flax(port.state_dict(), conf, log=lambda *a: None)
    for coll in ("params", "batch_stats"):
        merged, n, total = merge_pretrained(variables[coll], tree[coll],
                                            log=lambda *a: None)
        assert n == total, f"{coll}: only {n}/{total} leaves loaded"
        ref = flatten_params(variables[coll])
        for path, leaf in flatten_params(merged).items():
            np.testing.assert_array_equal(np.asarray(leaf), ref[path],
                                          err_msg="/".join(path))


@pytest.mark.parametrize("key,value", [
    ("free_bits", 0.1), ("adverse_loss", {"discriminator": "d"}),
    ("embedding_loss", "MSE"), ("use_aug_prob", 0.5),
    ("optimizer", "SGD"), ("global_loss", "kl"), ("model", "VAEModel"),
    ("encodermodel", "Cnn14")])
def test_unported_branches_raise(key, value):
    """Branches outside the slice raise instead of being silently ignored."""
    with pytest.raises(NotImplementedError):
        Trainer(_port_conf(dict(SMALL, **{key: value})), V, FDIM, device="cpu",
                total_iters=10)


def test_trainer_ratios_follow_the_cli():
    """ss_ratio / dis_ratio / kl_weight per iteration and epoch, as
    cli/main.py:523-553 computes them for the flagship recipe."""
    from acvae_tpu.train.trainer import (dis_ratio_for_epoch, kl_weight_schedule,
                                         ss_ratio_at)
    trainer = Trainer(_port_conf(SMALL), V, FDIM, device="cpu", total_iters=250)
    for it, epoch in ((1, 1), (120, 11), (250, 25)):
        r = trainer.ratios(it, epoch)
        assert r["ss_ratio"] == pytest.approx(ss_ratio_at(it, 1.0, "exponential",
                                                          250, 0.7))
        assert r["dis_ratio"] == dis_ratio_for_epoch(epoch, 25, 10, 0.3)
        assert r["kl_weight"] == kl_weight_schedule(epoch, 25, 0.5)
