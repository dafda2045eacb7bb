"""Port parity: the decode path of ``acvae_tpu_torch`` against ``acvae_tpu``
(beam-folded attention, ``beam_topk``, ``batched_beam_search``,
``sample_next_word``, and the VAE's beam and greedy decodes).

Noise protocol: torch cannot reproduce ``jax.random``, so both sides get
the same draws.  The JAX model's prior noise comes from a patched
``acvae_tpu.models.vae.eps_stack`` that returns a fixed numpy slab cut to
the requested shape, and the port is handed the same slab as ``eps``; Gumbel
draws are made with ``jax.random`` and passed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.vae as jvae
from acvae_tpu.decoding.beam import BeamConfig as JBeamConfig
from acvae_tpu.decoding.beam import batched_beam_search as j_batched_beam_search
from acvae_tpu.decoding.beam import beam_topk as j_beam_topk
from acvae_tpu.decoding.sampling import sample_next_word as j_sample_next_word
from acvae_tpu.models.attention import AdditiveAttention as JAttention
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.decoding.beam import BeamConfig, batched_beam_search, beam_topk
from acvae_tpu_torch.decoding.sampling import sample_next_word
from acvae_tpu_torch.models.attention import AdditiveAttention
from acvae_tpu_torch.models.build import build_model

V, E, TMEL, FDIM, T = 25, 16, 64, 16, 8
SMALL = dict(
    encoder_args={"embed_size": E, "channels": [4, 8, 8, 16]},
    decoder_args={"embed_size": E, "hidden_size": E, "dropout": 0.0},
    model_args={"posterior_model": "PosteriorRNN_hybrid",
                "posterior_args": {"hidden_size": E},
                "prior_model": "PriorRNN", "prior_args": {"hidden_size": E}},
    data_dim=FDIM)
# one prior-noise slab for every decode here; eps_stack(steps, rows, dim)
# is its leading block
EPS_SLAB = np.random.default_rng(123).normal(size=(24, 64, 64)).astype(np.float32)


def eps_slab(steps, rows, dim):
    return EPS_SLAB[:steps, :rows, :dim]


@pytest.fixture
def fixed_eps(monkeypatch):
    """Both packages' eps_stack return the leading block of EPS_SLAB."""
    import acvae_tpu_torch.models.vae as tvae
    monkeypatch.setattr(jvae, "eps_stack", lambda key, steps, rows, dim,
                        dtype=None: jnp.asarray(eps_slab(steps, rows, dim)))
    monkeypatch.setattr(tvae, "eps_stack", lambda steps, rows, dim, generator=None,
                        device=None, dtype=torch.float32: torch.tensor(
                            eps_slab(steps, rows, dim), device=device))


def small_jax_model(seed=0):
    """The tiny flagship in JAX with initialised variables, its BatchNorm
    running statistics made non-trivial so that eval-mode BN is exercised."""
    conf = flagship_conf(**SMALL)
    model = j_build_model(conf, V, FDIM)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, TMEL, FDIM)).astype(np.float32)
    caps = rng.integers(3, V, size=(2, 6)).astype(np.int32)
    variables = jax.jit(lambda k1, k2: model.init(
        {"params": k1, "sample": k2}, feats, np.array([TMEL, 40]), caps,
        np.array([6, 4]), train=False))(jax.random.key(seed),
                                       jax.random.key(seed + 1))
    variables = jax.tree_util.tree_map(np.array, variables)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        name = jax.tree_util.keystr(path)
        leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape) if "var" in name
                     else rng.normal(0, 0.3, leaf.shape))
    return conf, model, variables


def port_model(conf, variables):
    model = build_model(conf, V, FDIM, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def mels(n, seed=7):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, TMEL, FDIM)).astype(np.float32)
    lens = np.array([TMEL, 48, 33][:n], np.int32)
    return feats, lens


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_beam_folded_attention_matches_jax(masked):
    N, B, S, D, A = 2, 3, 7, 5, 6
    rng = np.random.default_rng(0)
    h_dec = rng.normal(size=(N * B, D)).astype(np.float32)
    h_enc = rng.normal(size=(N, S, D)).astype(np.float32)
    mask = np.arange(S)[None] < np.array([[S], [4]]) if masked else None
    att = JAttention(attn_size=A)

    def read(m, hd, he, mk):
        return m(hd, he, m.project_enc(he), mk)

    params = att.init(jax.random.key(0), h_dec, h_enc, mask, method=read)
    ref_ctx, ref_w = att.apply(params, h_dec, h_enc, mask, method=read)
    port = AdditiveAttention(D, D, A, device="cpu")
    port.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))
    he = torch.tensor(h_enc)
    with torch.no_grad():
        ctx, w = port(torch.tensor(h_dec), he, port.project_enc(he),
                      None if mask is None else torch.tensor(mask))
    assert ctx.shape == (N * B, D) and w.shape == (N * B, S)
    np.testing.assert_allclose(ctx.numpy(), ref_ctx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), ref_w, rtol=0, atol=1e-5)
    # query n*B+b reads memory row n: the same as an unfolded read per beam
    with torch.no_grad():
        for n in range(N):
            c1, _ = port(torch.tensor(h_dec[n * B:(n + 1) * B]),
                         he[n:n + 1].expand(B, S, D),
                         port.project_enc(he[n:n + 1]).expand(B, S, A),
                         None if mask is None
                         else torch.tensor(mask[n:n + 1]).expand(B, S))
            np.testing.assert_allclose(c1.numpy(), ctx[n * B:(n + 1) * B].numpy(),
                                       rtol=0, atol=1e-6)


# --------------------------------------------------------------------- #
# top-k order
# --------------------------------------------------------------------- #
def test_beam_topk_tie_order_matches_lax():
    """Rows with exact ties, one of them across the k-th place: the indices
    equal lax.top_k's (ties to the lower flat index); torch.topk alone
    orders at least one of these rows differently."""
    rows = np.array([[1, 3, 3, 2, 3, 0],       # tie across the k-th place
                     [5, 5, 5, 5, 5, 5],       # all tied
                     [0, 2, 2, 2, 1, 2],
                     [4, 1, 4, 0, 4, 4]], np.float32)
    k = 2
    total = rows.reshape(4, 2, 3)               # N=4, B=2, V=3
    ref_s, ref_i = j_beam_topk(jnp.asarray(total), k)
    s, i = beam_topk(torch.tensor(total), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    lax_s, lax_i = jax.lax.top_k(jnp.asarray(rows), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(lax_i))
    plain = torch.topk(torch.tensor(rows), k).indices.numpy()
    assert not np.array_equal(plain, np.asarray(lax_i)), \
        "torch.topk already matches lax.top_k on these rows"


# --------------------------------------------------------------------- #
# batched beam search on a synthetic step function
# --------------------------------------------------------------------- #
N_SYN, B_SYN, V_SYN, T_SYN = 3, 3, 6, 7
# coarse values make exact ties; column 2 (<end>) is raised from step 3 on
# so that, with end handling, whole clips finish and freeze
TABLE = (np.round(np.random.default_rng(4).normal(size=(T_SYN, V_SYN, V_SYN))
                  * 2) / 2).astype(np.float32)
TABLE[3:, :, 2] += 3.0


def _jax_step(state, words, t):
    s, (c,) = state
    s = s + jnp.asarray(TABLE)[t][words]
    return s, (s, (c + 1.0,))


def _torch_step(state, words, t):
    s, (c,) = state
    s = s + torch.tensor(TABLE)[t][words]
    return s, (s, (c + 1.0,))


@pytest.mark.parametrize("row0", [False, True], ids=["flat0", "row0"])
@pytest.mark.parametrize("end", [False, True], ids=["noend", "end"])
def test_batched_beam_search_matches_jax(row0, end):
    NB = N_SYN * B_SYN
    init = np.zeros((NB, V_SYN), np.float32)
    init[:, 0] = np.repeat(np.arange(N_SYN), B_SYN)   # clips differ
    cfg = dict(beam_size=B_SYN, max_length=T_SYN, first_step_row0=row0,
               end_handling=end)
    ref = j_batched_beam_search(
        _jax_step, (jnp.asarray(init), (jnp.zeros((NB, 1)),)), N_SYN,
        JBeamConfig(**cfg))
    out = batched_beam_search(
        _torch_step, (torch.tensor(init), (torch.zeros((NB, 1)),)), N_SYN,
        BeamConfig(**cfg))
    assert out["seqs"].dtype == torch.long and out["scores"].dtype == torch.float32
    np.testing.assert_array_equal(out["seqs"].numpy().astype(np.int32),
                                  np.asarray(ref["seqs"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-5)
    if end:  # some clip froze with <end> in its live beams
        assert (out["seqs"] == 2).any()


# --------------------------------------------------------------------- #
# next-word sampling
# --------------------------------------------------------------------- #
def test_categorical_is_gumbel_argmax_on_this_jax():
    """The premise of the `sample` parity below: on this JAX version
    categorical(key, x) == argmax(x + gumbel(key, x.shape))."""
    x = jnp.asarray(np.random.default_rng(1).normal(size=(5, 11)), jnp.float32)
    key = jax.random.key(9)
    np.testing.assert_array_equal(
        jax.random.categorical(key, x, axis=-1),
        jnp.argmax(x + jax.random.gumbel(key, x.shape, x.dtype), axis=-1))


@pytest.mark.parametrize("method", ["greedy", "gumbel", "sample"])
def test_sample_next_word_matches_jax(method):
    logits = np.random.default_rng(2).normal(size=(6, 13)).astype(np.float32) * 3
    key, temp = jax.random.key(3), 0.7
    w_ref, lp_ref = j_sample_next_word(jnp.asarray(logits), key, method, temp)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32)))
    w, lp = sample_next_word(torch.tensor(logits), method, temp,
                             gumbel=None if method == "greedy" else g)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), rtol=1e-5, atol=1e-6)


def test_sample_next_word_draws_from_its_generator():
    """Without given noise the draws come from the generator: the same seed
    gives the same words; a token with all the mass is always drawn."""
    logits = torch.randn((64, 9), generator=torch.Generator().manual_seed(0))
    a = sample_next_word(logits, "sample", generator=torch.Generator().manual_seed(5))
    b = sample_next_word(logits, "sample", generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0])
    peaked = torch.full((4, 9), -1e4)
    peaked[:, 6] = 0.0
    for m in ("gumbel", "sample"):
        assert (sample_next_word(peaked, m)[0] == 6).all()
    with pytest.raises(ValueError):
        sample_next_word(logits, "nucleus")


# --------------------------------------------------------------------- #
# the VAE's decodes
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_models():
    conf, model, variables = small_jax_model()
    return conf, model, variables, port_model(conf, variables)


@pytest.mark.parametrize("n", [1, 3])
def test_vae_beam_search_matches_jax(small_models, fixed_eps, n):
    conf, model, variables, port = small_models
    feats, lens = mels(n)
    ref = model.apply(variables, feats, lens, rngs={"sample": jax.random.key(0)},
                      decode_method="beam", beam_size=3, max_length=T)
    out = port.inference_forward(torch.tensor(feats), torch.tensor(lens),
                                 decode_method="beam", beam_size=3, max_length=T,
                                 eps=torch.tensor(eps_slab(T, n * 3, E)))
    assert out["seqs"].shape == (n, 3, T)
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-5)
    # beams come out in score order
    assert (np.diff(out["scores"].numpy(), axis=1) <= 0).all()


def test_vae_greedy_decode_matches_jax(small_models, fixed_eps):
    conf, model, variables, port = small_models
    feats, lens = mels(3)
    ref = model.apply(variables, feats, lens, rngs={"sample": jax.random.key(0)},
                      decode_method="greedy", max_length=T)
    out = port.inference_forward(torch.tensor(feats), torch.tensor(lens),
                                 decode_method="greedy", max_length=T,
                                 eps=torch.tensor(eps_slab(T, 3, E)))
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    for k in ("sampled_logprobs", "logits", "p_z"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_stepwise_noise_and_finished_mask(small_models):
    """`gumbel` with zero noise is the greedy decode; a decode with drawn
    noise is reproducible from its generator's seed; after a clip's first
    <end> every later word is <end>."""
    conf, model, variables, port = small_models
    feats, lens = (torch.tensor(a) for a in mels(3))
    eps = torch.tensor(eps_slab(T, 3, E))
    greedy = port.inference_forward(feats, lens, max_length=T, eps=eps)
    zero = port.inference_forward(feats, lens, decode_method="gumbel",
                                  max_length=T, eps=eps,
                                  gumbel=torch.zeros((T, 3, V)))
    assert torch.equal(zero["seqs"], greedy["seqs"])
    runs = [port.inference_forward(feats, lens, decode_method="sample",
                                   max_length=T, temp=3.0,
                                   generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(runs[0]["seqs"], runs[1]["seqs"])
    for out in [greedy, zero] + runs:
        seqs = out["seqs"].numpy()
        for row in seqs:
            ends = np.flatnonzero(row == 2)
            if ends.size:
                assert (row[ends[0]:] == 2).all()


def test_decode_method_checks(small_models):
    port = small_models[3]
    feats, lens = (torch.tensor(a) for a in mels(1))
    with pytest.raises(ValueError, match="does not support"):
        port.inference_forward(feats, lens, decode_method="nucleus")
    with pytest.raises(NotImplementedError, match="A14"):
        port.inference_forward(feats, lens, decode_method="dbs")
    # the arity dispatch: without captions, forward is the inference forward
    out = port(feats, lens, decode_method="beam", beam_size=2, max_length=3)
    assert out["seqs"].shape == (1, 2, 3) and not out["seqs"].requires_grad


def test_step_decode_api_reproduces_greedy(small_models):
    """Driving decode_ctx / init_decode_state / decode_step_api from outside,
    step by step with greedy words, gives the greedy decode's logits and
    words."""
    port = small_models[3]
    feats, lens = (torch.tensor(a) for a in mels(3))
    eps = torch.tensor(eps_slab(T, 3, E))
    ref = port.inference_forward(feats, lens, max_length=T, eps=eps)
    with torch.inference_mode():
        ctx = port.decode_ctx(port.encode(feats, lens))
        state = port.init_decode_state(3)
        words = torch.full((3,), 1)                       # <start>
        finished = torch.zeros(3, dtype=torch.bool)
        for t in range(T):
            logits, state = port.decode_step_api(ctx, state, words, eps[t])
            np.testing.assert_allclose(logits.numpy(), ref["logits"][:, t].numpy(),
                                       rtol=0, atol=1e-6)
            words = torch.where(finished, 2, sample_next_word(logits, "greedy")[0])
            finished |= words == 2
            assert torch.equal(words, ref["seqs"][:, t])
