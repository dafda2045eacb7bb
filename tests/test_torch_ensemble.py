"""Port parity: ensemble decoding (``acvae_tpu_torch/decoding/ensemble.py``)
and ensemble serving against ``acvae_tpu``.

The engines run on toy step functions; ``ensemble_decode`` on two small
flagships (the JAX variables carried across by ``from_flax``) with JAX's
own draws: member m's noise is ``jax.random.normal(fold_in(key, m), (T,
N·B, E))``, handed to the port as ``eps[m]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu_torch.serve as tserve
from acvae_tpu.decoding.beam import BeamConfig as JBeamConfig
from acvae_tpu.decoding.ensemble import _mean_logprobs as j_mean_logprobs
from acvae_tpu.decoding.ensemble import ensemble_beam as j_ensemble_beam
from acvae_tpu.decoding.ensemble import ensemble_decode as j_ensemble_decode
from acvae_tpu.decoding.ensemble import ensemble_greedy as j_ensemble_greedy
from acvae_tpu_torch.data.vocab import Vocabulary as PortVocabulary
from acvae_tpu_torch.decoding.beam import BeamConfig
from acvae_tpu_torch.decoding.ensemble import (_mean_logprobs, ensemble_beam,
                                               ensemble_decode, ensemble_greedy)
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.serve import CaptionService
from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment
from tests.test_torch_decode import E, T, mels, port_model, small_jax_model
from tests.test_torch_serve import (BUCKET, MAXLEN, _quantize, _request_mels,
                                    experiments)  # noqa: F401
from tests.test_torch_decode import one_torch_thread  # noqa: F401

N_SYN, V_SYN, T_SYN = 3, 6, 7


def member_eps(key, members, T_, NB):
    """JAX's draws for each member: normal(fold_in(key, m), (T, NB, E))."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, m), (T_, NB, E)))
            for m in range(members)]


def test_mean_logprobs_matches_jax():
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(4, 9)).astype(np.float32) * 3 for _ in range(3)]
    ref = j_mean_logprobs([jnp.asarray(x) for x in logits])
    out = _mean_logprobs([torch.tensor(x) for x in logits])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # probabilities are averaged, not logits
    p = np.mean([np.exp(x) / np.exp(x).sum(-1, keepdims=True) for x in logits], 0)
    np.testing.assert_allclose(out.numpy(), np.log(p + 1e-12), rtol=1e-5)


def _toy(m, lib):
    """Member m's step: logits = state + table[m, t][words]."""
    tab = np.random.default_rng(10 + m).normal(
        size=(T_SYN, V_SYN, V_SYN)).astype(np.float32)
    tab[3:, :, 2] += 1.5
    arr = jnp.asarray(tab) if lib == "jax" else torch.tensor(tab)

    def step(state, words, t):
        s = state + arr[t][words]
        return s, s
    return step


@pytest.mark.parametrize("engine", ["greedy", "beam"])
def test_ensemble_engines_match_jax(engine):
    B = 3 if engine == "beam" else 1
    NB = N_SYN * B
    init = np.zeros((NB, V_SYN), np.float32)
    init[:, 0] = np.repeat(np.arange(N_SYN), B)
    jfns, tfns = ([_toy(m, lib) for m in range(2)] for lib in ("jax", "torch"))
    if engine == "greedy":
        ref = j_ensemble_greedy(jfns, [jnp.asarray(init)] * 2, N_SYN, T_SYN)
        out = ensemble_greedy(tfns, [torch.tensor(init)] * 2, N_SYN, T_SYN)
    else:
        cfg = dict(beam_size=B, max_length=T_SYN, first_step_row0=True)
        ref = j_ensemble_beam(jfns, [jnp.asarray(init)] * 2, N_SYN,
                              JBeamConfig(**cfg))
        out = ensemble_beam(tfns, [torch.tensor(init)] * 2, N_SYN,
                            BeamConfig(**cfg))
        np.testing.assert_allclose(out["scores"].numpy(),
                                   np.asarray(ref["scores"]), rtol=1e-5)
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    if engine == "greedy":   # after a clip's first <end>, only <end>
        for row in out["seqs"].numpy():
            ends = np.flatnonzero(row == 2)
            assert ends.size == 0 or (row[ends[0]:] == 2).all()


@pytest.fixture(scope="module")
def members():
    """Two small flagships: (JAX (model, variables) pairs, port models)."""
    jm, tm = [], []
    for seed in (2, 4):
        conf, model, variables = small_jax_model(seed=seed)
        jm.append((model, variables))
        tm.append(port_model(conf, variables))
    return jm, tm


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_ensemble_decode_matches_jax(members, method):
    jm, tm = members
    feats, lens = mels(3)
    key = jax.random.key(7)
    ref = j_ensemble_decode(jm, jnp.asarray(feats), jnp.asarray(lens), key,
                            decode_method=method, beam_size=3, max_length=T)
    NB = 3 * (3 if method == "beam" else 1)
    out = ensemble_decode(tm, torch.tensor(feats), torch.tensor(lens),
                          decode_method=method, beam_size=3, max_length=T,
                          eps=[torch.tensor(e) for e in member_eps(key, 2, T, NB)])
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    # the members disagree somewhere: a one-member decode differs
    alone = ensemble_decode(tm[:1], torch.tensor(feats), torch.tensor(lens),
                            decode_method=method, beam_size=3, max_length=T,
                            eps=[torch.tensor(e) for e in member_eps(key, 1, T, NB)])
    assert not torch.equal(alone["seqs"], out["seqs"])


# --------------------------------------------------------------------- #
# ensemble serving
# --------------------------------------------------------------------- #
def _fed_from_jax_keys(monkeypatch, seed=1):
    """The port service's ensemble draws replaced by the JAX service's: its
    key splits once a ``caption`` call (warm-ups included)."""
    state = {"key": jax.random.key(seed + 2)}
    real = tserve.ensemble_decode

    def fed(members, feats, lens, generator=None, **kw):
        state["key"], sub = jax.random.split(state["key"])
        NB = feats.shape[0] * (kw["beam_size"] if kw["decode_method"] == "beam"
                               else 1)
        eps = [torch.tensor(e) for e in
               member_eps(sub, len(members), kw["max_length"], NB)]
        return real(members, feats, lens, eps=eps, **kw)
    monkeypatch.setattr(tserve, "ensemble_decode", fed)


@pytest.fixture(scope="module")
def second_member(experiments, tmp_path_factory):
    """A second experiment pair (other weights, same vocabulary)."""
    from acvae_tpu.train.checkpoints import save_checkpoint
    from acvae_tpu.train.trainer import TrainState
    import optax
    from tests.test_torch_serve import jax_vocab

    conf, _, variables = small_jax_model(seed=5)
    root = tmp_path_factory.mktemp("second")
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adam(1e-3))
    save_checkpoint(str(root / "jax"), "best", state, jax_vocab(), dict(conf))
    save_experiment(str(root / "port"), port_model(conf, variables), conf,
                    PortVocabulary.load(str(root / "jax" / "vocab.pkl")))
    return str(root / "jax"), str(root / "port")


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_ensemble_service_matches_jax(experiments, second_member, monkeypatch,
                                      method):
    from acvae_tpu.serve import CaptionService as JCaptionService

    kw = dict(decode_method=method, batch_size=4, mel_bucket=BUCKET,
              max_length=MAXLEN)
    jsvc = JCaptionService(f"{experiments[0]},{second_member[0]}", **kw)
    _fed_from_jax_keys(monkeypatch)
    psvc = CaptionService([experiments[1], second_member[1]], device="cpu", **kw)
    assert len(psvc.members) == 2 and psvc.quant is None
    mels_ = _request_mels()
    assert psvc.caption(mels_) == jsvc.caption(mels_)
    q8 = [_quantize(m) for m in mels_]
    assert psvc.caption(q8) == jsvc.caption(q8)


@pytest.mark.parametrize("kwargs,match", [
    ({"encoder_int8": True}, "plain f32 decode"),
    ({"decode_dtype": "bfloat16"}, "plain f32 decode"),
    ({"decode_method": "dbs"}, "beam\\|greedy"),
    ({"group_size": 4}, "do not apply to ensemble"),
    ({"exported": "artifact"}, "plain f32 decode")],
    ids=["int8", "bf16", "dbs", "dbs_kwargs", "exported"])
def test_ensemble_service_refusals_match_jax(experiments, kwargs, match):
    from acvae_tpu.serve import CaptionService as JCaptionService

    kw = dict(batch_size=2, mel_bucket=BUCKET, max_length=MAXLEN, **kwargs)
    with pytest.raises(ValueError, match=match):
        JCaptionService(f"{experiments[0]},{experiments[0]}", **kw)
    with pytest.raises(ValueError, match=match):
        CaptionService(f"{experiments[1]},{experiments[1]}", device="cpu", **kw)


def test_ensemble_members_must_match(experiments, tmp_path):
    _, port_exp, conf = experiments
    _, vocab, model = load_experiment(port_exp, device="cpu")
    other = PortVocabulary()              # the same size, one word differs
    for w in list(vocab.word2idx)[4:-1] + ["other"]:
        other.add_word(w)
    assert len(other) == len(vocab)
    save_experiment(str(tmp_path / "vocab"), model, conf, other)
    with pytest.raises(ValueError, match="share one vocabulary"):
        CaptionService(f"{port_exp},{tmp_path / 'vocab'}", device="cpu",
                       batch_size=2, mel_bucket=BUCKET, max_length=MAXLEN)
    conf32 = dict(conf, data_dim=32)
    save_experiment(str(tmp_path / "dim"),
                    build_model(conf32, len(vocab), 32, device="cpu"), conf32,
                    vocab)
    with pytest.raises(ValueError, match="share the mel dim"):
        CaptionService(f"{port_exp},{tmp_path / 'dim'}", device="cpu",
                       batch_size=2, mel_bucket=BUCKET, max_length=MAXLEN)
