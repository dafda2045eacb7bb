"""Port parity: SCST / N-SCST of ``acvae_tpu_torch`` (``train/scst.py``
and the ``scst`` command) against ``acvae_tpu.train.scst``, on the CPU at
small widths.

``scst_loss`` rtol 1e-6; ``batch_cider`` and ``scst_reward`` exactly
(same strings, same scorer arithmetic); the replay equals the rollout's
log-probabilities at every scored position, exactly for the RNN families
and within 1e-5 for the transformers (one causal pass against the
step-by-step prefix decode); one SCST update's parameters within 1e-5 of
JAX's at lr 1e-4 (as the families' Adam step tests).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu.ops import losses as jlosses
from acvae_tpu.train import scst as jscst
from acvae_tpu.train.trainer import TrainState, build_optimizer
from acvae_tpu_torch import END_IDX
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.train import scst as tscst
from acvae_tpu_torch.train.checkpoints import save_experiment
from acvae_tpu_torch.train.optim import OptaxChain
from tests.test_torch_cli import ws  # noqa: F401
from tests.test_torch_decode import (FDIM, SMALL, V, eps_slab,  # noqa: F401
                                     fixed_eps, small_jax_model)
from tests.test_torch_families_rnn import one_torch_thread, small_conf  # noqa: F401

V_FAM, FDIM_FAM = 30, 16


def _seqs(rng, n, T, V):
    """Sampled-looking words: each row ends with <end> somewhere (or not)
    and holds <end> after it."""
    seqs = rng.integers(3, V, size=(n, T))
    for i, stop in enumerate(rng.integers(2, T + 3, size=n)):
        if stop < T:
            seqs[i, stop:] = END_IDX
    return seqs


def test_scst_loss_matches_jax():
    rng = np.random.default_rng(0)
    seqs = _seqs(rng, 6, 9, 20)
    lp = -rng.uniform(0, 5, size=(6, 9)).astype(np.float32)
    reward = rng.normal(size=6).astype(np.float32)
    ref = jlosses.scst_loss(jnp.asarray(lp), jnp.asarray(seqs),
                            jnp.asarray(reward), END_IDX)
    ours = tscst.scst_loss(torch.tensor(lp), torch.tensor(seqs),
                           torch.tensor(reward))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.fixture(scope="module")
def vocabs(ws):  # noqa: F811
    return (Vocabulary.load(str(ws / "vocab.pkl")),
            JVocabulary.load(str(ws / "vocab.pkl")))


def _corpus(ws, vocab):  # noqa: F811
    refs = {a["audio_id"]: [c["tokens"] for c in a["captions"]]
            for a in json.loads((ws / "text.json").read_text())["audios"]}
    return refs, sorted(refs)


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "each"])
def test_batch_cider_matches_jax(ws, vocabs, dedup):  # noqa: F811
    vocab, _ = vocabs
    refs, keys = _corpus(ws, vocab)
    rng = np.random.default_rng(1)
    keys = [keys[i] for i in rng.integers(0, 4, size=10)]   # repeated keys
    hyps = [" ".join(vocab.decode(s)) for s in _seqs(rng, 10, 8, len(vocab))]
    hyps[3] = refs[keys[3]][0]
    ours = tscst.batch_cider(hyps, keys, refs, dedup=dedup)
    ref = jscst.batch_cider(hyps, keys, refs, dedup=dedup)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("sample_n", [1, 3], ids=["scst", "nscst"])
def test_scst_reward_matches_jax(ws, vocabs, sample_n):  # noqa: F811
    """The greedy baseline, and the leave-one-out mean of N-SCST."""
    vocab, jvocab = vocabs
    refs, keys = _corpus(ws, vocab)
    keys = keys[:4]
    rng = np.random.default_rng(2)
    sampled = _seqs(rng, 4 * sample_n, 8, len(vocab))
    greedy = _seqs(rng, 4, 8, len(vocab)) if sample_n == 1 else None
    ours = tscst.scst_reward(sampled, greedy, keys, refs, vocab, sample_n)
    ref = jscst.scst_reward(sampled, greedy, keys, refs, jvocab, sample_n)
    for k in ("reward", "score"):
        assert np.array_equal(ours[k], ref[k]), k
    if sample_n > 1:
        s = ours["score"].reshape(-1, sample_n)
        np.testing.assert_allclose(ours["reward"].reshape(-1, sample_n),
                                   s - (s.sum(1, keepdims=True) - s) / 2,
                                   rtol=1e-6)


RECIPES = ("ac_vae", "vae", "gmm_vae", "simple_vae", "trans_vae",
           "attn_rnn_xe", "xe_baseline")


@pytest.mark.parametrize("recipe", RECIPES)
def test_replay_reproduces_the_rollout(recipe):
    """Every family ``build_model`` makes: the forced decode of the
    sampled words, given the rollout's noise, gives the rollout's
    log-probabilities at every position ``scst_loss`` scores, and a
    gradient flows to the decoder and the encoder."""
    torch.manual_seed(0)
    model = build_model(small_conf(recipe, port=True), V_FAM, FDIM_FAM,
                        device="cpu")
    rng = np.random.default_rng(3)
    feats = torch.tensor(rng.normal(size=(3, 64, FDIM_FAM)).astype(np.float32))
    lens = torch.tensor([64, 48, 33])
    gen = torch.Generator().manual_seed(4)
    out = tscst.make_rollout(model, sample_n=2, max_length=9, temp=1.2)(
        feats, lens, gen)
    seqs = out["sampled_seqs"]
    assert seqs.shape == (6, 9) and "greedy_seqs" not in out
    rep = model.forced_decode(feats.repeat_interleave(2, 0),
                              lens.repeat_interleave(2, 0), seqs, eps=out["eps"],
                              grad=True)["sampled_logprobs"]
    mask = torch.cat([torch.ones_like(seqs[:, :1], dtype=torch.bool),
                      seqs[:, :-1] != END_IDX], dim=1)
    atol = 1e-5 if recipe in ("trans_vae", "xe_baseline") else 0.0
    np.testing.assert_allclose(rep.detach()[mask].numpy(),
                               out["sampled_logprobs"][mask].numpy(), rtol=0,
                               atol=atol)
    loss = tscst.scst_loss(rep, seqs, torch.ones(6))
    loss.backward()
    for part in ("decoder", "encoder"):
        assert any(p.grad is not None and p.grad.abs().sum() > 0
                   for n, p in model.named_parameters() if n.startswith(part)), part
    one = tscst.make_rollout(model, sample_n=1, max_length=9)(feats, lens, gen)
    assert one["sampled_seqs"].shape == one["greedy_seqs"].shape == (3, 9)


def test_scst_update_matches_jax(fixed_eps):  # noqa: F811
    """One replay + clip + Adam update (lr 1e-4) of the tiny flagship on
    the same words and rewards, both sides' prior noise the same slab:
    the loss rtol 1e-5, every parameter within 1e-5 of JAX's."""
    _, model, variables = small_jax_model(1)
    rng = np.random.default_rng(5)
    n, T = 4, 7
    feats = rng.normal(size=(n, 64, 16)).astype(np.float32)
    lens = np.array([64, 50, 40, 33], np.int32)
    seqs = _seqs(rng, n, T, 25)
    reward = rng.normal(size=n).astype(np.float32)
    state = TrainState.create(variables, build_optimizer("Adam", 1e-4,
                                                         max_grad_norm=1.0))
    step = jscst.make_scst_step(model)
    new_state, ref_m = step(state, jnp.asarray(feats), jnp.asarray(lens),
                            jnp.asarray(seqs), jnp.asarray(reward),
                            jax.random.key(0))
    port = build_model(flagship_conf(**SMALL), V, FDIM, device="cpu")
    port.load_state_dict(from_flax(variables), strict=True)
    opt = OptaxChain(port.named_parameters(), "Adam", lambda c: 1e-4,
                     max_grad_norm=1.0)
    loss = tscst.replay_loss(port, torch.tensor(feats), torch.tensor(lens),
                             torch.tensor(seqs), torch.tensor(reward),
                             eps=torch.tensor(eps_slab(T, n, 16)))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(float(loss.detach()), float(ref_m["loss"]),
                               rtol=1e-5)
    want = from_flax({"params": new_state.params})
    want.pop("encoder.stem_pad_lanes")
    named = dict(port.named_parameters())
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        moved += not np.array_equal(v.numpy(), from_flax(variables)[k].numpy())
    assert moved > len(want) // 2


@pytest.fixture(scope="module")
def port_exp(ws, tmp_path_factory):  # noqa: F811
    """A tiny flagship experiment of the port's, seeded weights, over the
    test corpus."""
    conf = dict(load_config(str(ws / "port.yaml")), data_dim=64)
    vocab = Vocabulary.load(str(ws / "vocab.pkl"))
    torch.manual_seed(0)
    model = build_model(conf, len(vocab), 64, device="cpu")
    out = tmp_path_factory.mktemp("scst") / "exp"
    save_experiment(str(out), model, conf, vocab)
    return out


@pytest.mark.parametrize("sample_n", [1, 2], ids=["scst", "nscst"])
def test_scst_command_writes_an_experiment(port_exp, sample_n):
    """``scst <exp> --epochs=1``: ``scst_n<N>/`` with ``best``/``last``
    weights that moved, ``scst.log`` with JAX's epoch line, and an
    experiment dir that ``evaluate`` reads."""
    out = cli.main(["scst", str(port_exp), "--epochs=1", f"--sample_n={sample_n}",
                    "--lr=1e-3", "--device=cpu"])
    assert out == str(port_exp / f"scst_n{sample_n}")
    log = (port_exp / f"scst_n{sample_n}" / "scst.log").read_text()
    assert "epoch 1: train CIDEr " in log and " val CIDEr " in log
    before = torch.load(port_exp / "best.pt", weights_only=True)["state_dict"]
    after = torch.load(f"{out}/last.pt", weights_only=True)["state_dict"]
    assert any(not torch.equal(before[k], after[k]) for k in before)
    for k in ("encoder.conv_block1.bn1.running_mean",):
        assert torch.equal(before[k], after[k])   # the replay is eval-mode BN
    scores = cli.evaluate(out, device="cpu", checkpoint="last")
    assert np.isfinite(scores["CIDEr"])
