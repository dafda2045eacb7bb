"""Port parity: diverse beam search (``acvae_tpu_torch/decoding/dbs.py`` and
``VAECaptionModel.diverse_beam_search``) against ``acvae_tpu``.

The engine runs on a toy step function whose tables differ per group and
raise ``<end>`` from step 3 on, so beams end mid-sequence, are recorded and
killed.  The model runs on the small flagship of ``test_torch_decode.py``
with JAX's own prior noise: each group's slab is drawn as the JAX model
draws it (``make_rng("sample")`` split into one key a group, ``eps_stack``
of each), so the groups' noise differs and a local-for-global step index
would show.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.quant as jquant
import acvae_tpu_torch.models.quant as tquant
from acvae_tpu.decoding.dbs import DBSConfig as JDBSConfig
from acvae_tpu.decoding.dbs import dbs_bdash as j_dbs_bdash
from acvae_tpu.decoding.dbs import diverse_beam_search as j_dbs
from acvae_tpu.models.common import eps_stack as j_eps_stack
from acvae_tpu_torch.convert import quant_from_flax
from acvae_tpu_torch.decoding.dbs import DBSConfig, dbs_bdash, diverse_beam_search
from tests.test_torch_decode import (E, T, mels, one_torch_thread,  # noqa: F401
                                     port_model, small_jax_model)
from tests.test_torch_quant import jax_baked

N_SYN, V_SYN, T_SYN = 3, 7, 7
CASES = [dict(beam_size=b, group_size=g, diversity_lambda=lam, temperature=tmp,
              group_nbest=nb)
         for (b, g), lam, tmp, nb in itertools.product(
             [(8, 4), (8, 8), (6, 2), (7, 2)], [0.0, 0.5], [1.0, 1.5],
             [True, False])]


def _ids(cases):
    return [f"b{c['beam_size']}g{c['group_size']}l{c['diversity_lambda']}"
            f"t{c['temperature']}{'n' if c['group_nbest'] else '1'}"
            for c in cases]


def _tables(G):
    """[G, T+G-1, V, V] logit increments; <end> (2) raised from step 3."""
    tab = np.random.default_rng(G).normal(
        size=(G, T_SYN + G - 1, V_SYN, V_SYN)).astype(np.float32)
    tab[:, 3:, :, 2] += 2.5
    return tab


def test_dbs_bdash_matches_jax():
    for b, g in ((8, 4), (7, 2), (8, 8), (3, 1)):
        assert dbs_bdash(b, g) == j_dbs_bdash(b, g)
    for b, g in ((2, 4), (5, 0)):
        with pytest.raises(ValueError) as ours:
            dbs_bdash(b, g)
        with pytest.raises(ValueError) as ref:
            j_dbs_bdash(b, g)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_diverse_beam_search_matches_jax(case):
    G = case["group_size"]
    NB = N_SYN * (case["beam_size"] // G)
    tab = _tables(G)
    init = np.zeros((NB, V_SYN), np.float32)
    init[:, 0] = np.repeat(np.arange(N_SYN), NB // N_SYN)   # clips differ

    def j_make(g):
        def step(state, words, t):
            s, (c,) = state
            s = s + jnp.asarray(tab)[g][t][words]
            return s, (s, (c + 1.0,))
        return step

    def t_make(g):
        def step(state, words, t):
            s, (c,) = state
            s = s + torch.tensor(tab)[g][t][words]
            return s, (s, (c + 1.0,))
        return step

    ref = j_dbs(j_make, lambda: (jnp.asarray(init), (jnp.zeros((NB, 1)),)),
                N_SYN, JDBSConfig(max_length=T_SYN, **case))
    out = diverse_beam_search(
        t_make, lambda: (torch.tensor(init), (torch.zeros((NB, 1)),)), N_SYN,
        DBSConfig(max_length=T_SYN, **case))
    rows = G * (case["beam_size"] // G if case["group_nbest"] else 1)
    assert out["seqs"].shape == (N_SYN, rows, T_SYN)
    assert out["seqs"].dtype == torch.long
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-6)
    seqs = out["seqs"].numpy()
    # some beam ended mid-sequence: <end> before the last position
    assert (seqs[..., :-1] == 2).any()


# --------------------------------------------------------------------- #
# the VAE's diverse beam search
# --------------------------------------------------------------------- #
def jax_dbs_eps(model, variables, key, group_size, steps, rows):
    """The JAX model's DBS prior noise for ``key``: [G, steps, rows, E]."""
    rk = model.apply(variables, rngs={"sample": key},
                     method=lambda m: m.make_rng("sample"))
    return np.asarray(jax.vmap(lambda k: j_eps_stack(k, steps, rows, E))(
        jax.random.split(rk, group_size)))


MODEL_CASES = [CASES[i] for i in (4, 14, 19, 28)]   # (8,4) (8,8) (6,2) (7,2)
INT8_CASES = [CASES[4], CASES[29]]


@pytest.fixture(scope="module")
def small_models():
    conf, model, variables = small_jax_model(seed=2)
    return conf, model, variables, port_model(conf, variables)


def _check(out, ref, case, n):
    G = case["group_size"]
    rows = G * (case["beam_size"] // G if case["group_nbest"] else 1)
    assert out["seqs"].shape == (n, rows, T)
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids(MODEL_CASES))
def test_vae_dbs_matches_jax(small_models, case):
    conf, model, variables, port = small_models
    feats, lens = mels(3)
    key = jax.random.key(5)
    ref = model.apply(variables, feats, lens, rngs={"sample": key},
                      decode_method="dbs", max_length=T, **case)
    G = case["group_size"]
    eps = jax_dbs_eps(model, variables, key, G, T + G - 1,
                      3 * (case["beam_size"] // G))
    assert not np.array_equal(eps[0], eps[1])
    out = port.inference_forward(torch.tensor(feats), torch.tensor(lens),
                                 decode_method="dbs", max_length=T,
                                 eps=torch.tensor(eps), **case)
    _check(out, ref, case, 3)


def test_vae_dbs_reads_the_global_step(small_models):
    """Group g's first step reads eps[g, g]: noise that differs only at the
    steps where no group is active leaves the decode unchanged, noise
    changed at eps[1, 1] changes group 1's."""
    _, _, _, port = small_models
    feats, lens = (torch.tensor(a) for a in mels(2))
    case = dict(beam_size=4, group_size=2, diversity_lambda=0.5)
    eps = torch.randn((2, T + 1, 4, E), generator=torch.Generator().manual_seed(1))
    base = port.inference_forward(feats, lens, decode_method="dbs",
                                  max_length=T, eps=eps, **case)["seqs"]
    idle = eps.clone()
    idle[1, 0] += 5.0        # group 1 is not active at global step 0
    idle[0, T] += 5.0        # group 0 has ended at global step T
    assert torch.equal(port.inference_forward(
        feats, lens, decode_method="dbs", max_length=T, eps=idle,
        **case)["seqs"], base)
    moved = eps.clone()
    moved[1, 1] += 5.0
    other = port.inference_forward(feats, lens, decode_method="dbs",
                                   max_length=T, eps=moved, **case)["seqs"]
    assert torch.equal(other[:, :2], base[:, :2])
    assert not torch.equal(other[:, 2:], base[:, 2:])


@pytest.mark.parametrize("case", INT8_CASES, ids=_ids(INT8_CASES))
def test_int8_dbs_matches_jax(small_models, case):
    """Through the int8 v2sym encoder, JAX's bake carried across."""
    conf, model, variables, port = small_models
    jq = jquant.quant_encoder_for(conf, model, variables["params"],
                                  variables["batch_stats"],
                                  **jquant.scheme_kwargs("v2sym"))
    feats, lens = mels(3)
    key = jax.random.key(8)
    kw = dict(decode_method="dbs", max_length=T, **case)
    ref = jquant.int8_decode_fn(model, jq, **kw)(variables, feats, lens, key)
    G = case["group_size"]
    eps = jax_dbs_eps(model, variables, key, G, T + G - 1,
                      3 * (case["beam_size"] // G))
    pq = quant_from_flax(jax_baked(jq), device="cpu")
    out = tquant.int8_decode_fn(port, pq, **kw)(
        torch.tensor(feats), torch.tensor(lens), eps=torch.tensor(eps))
    _check(out, ref, case, 3)


def test_dbs_draws_from_its_generator(small_models):
    """Without eps the draws come from the generator: the same seed gives
    the same captions, and every group's beams are sorted best first."""
    port = small_models[3]
    feats, lens = (torch.tensor(a) for a in mels(2))
    kw = dict(decode_method="dbs", beam_size=6, group_size=3, max_length=T)
    a, b = (port.inference_forward(feats, lens,
                                   generator=torch.Generator().manual_seed(3),
                                   **kw) for _ in range(2))
    assert torch.equal(a["seqs"], b["seqs"])
    s = a["scores"].view(2, 3, 2)
    assert (s[..., 1] <= s[..., 0]).all()
    with pytest.raises(ValueError, match="beam_size >= group_size"):
        port.inference_forward(feats, lens, decode_method="dbs", beam_size=2,
                               group_size=4, max_length=T)
