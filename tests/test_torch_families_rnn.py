"""Port parity: the RNN model families of ``acvae_tpu_torch`` (``VAEModel``
with ``PosteriorRNN``, its GMM prior, ``SimpleVAEModel``,
``Seq2SeqAttnModel``, the RNN and Luong decoders, the ``ln`` adapter)
against ``acvae_tpu``.

Each family is its recipe in ``configs/`` cut to a small size (Cnn10
channels 4-8-8-16, decoder embed 16, or 12 behind the ``ln`` adapter; vocab
30; T_mel 64), its JAX weights carried across with ``from_flax``.  Noise:
the train forward's latent draws are recovered from the JAX outputs
(eps = (z - mean) / exp(½·log)) and its coins fixed by the ratios; the
decodes get the JAX package's own draws — ``eps_stack`` patched to a numpy
slab for the stepwise and beam decodes and ``forced_decode``, the real
per-group slabs for dbs, ``normal(make_rng("sample"), ...)`` for
SimpleVAE's global z.  Cnn10's dropouts are identity on the JAX side and 0
in the port; the decoders' dropout is 0 (torch cannot replay flax's masks).

Tolerances: train-forward arrays, loss and KL rtol 1e-4 (atol 1e-5);
decode tokens identical; ``forced_decode`` log-probs atol 1e-5; parameters
after one ``Trainer.step`` atol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.quant as jquant
import acvae_tpu.models.trans_vae as jtrans
import acvae_tpu.models.vae as jvae
import acvae_tpu_torch.models.quant as tquant
from acvae_tpu.decoding.ensemble import ensemble_decode as j_ensemble_decode
from acvae_tpu.models import encoders as jenc
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.models.common import eps_stack as j_eps_stack
from acvae_tpu.models.decoders import RNNDecoder as JRNNDecoder
from acvae_tpu.ops.losses import gmm_kl_loss as j_gmm_kl_loss
from acvae_tpu.train.trainer import TrainState, build_optimizer, make_train_step
from acvae_tpu_torch.convert import from_flax, quant_from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.decoding.ensemble import ensemble_decode
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.models.decoders import RNNDecoder
from acvae_tpu_torch.ops.amp import cast_floats_for_decode
from acvae_tpu_torch.ops.losses import gmm_kl_loss
from acvae_tpu_torch.train.trainer import Trainer
from tests.test_torch_quant import jax_baked

V, E, E_LN, FDIM, TMEL, N, T = 30, 16, 12, 16, 64, 3, 7
EPS_SLAB = np.random.default_rng(77).normal(size=(32, 40, 16)).astype(np.float32)
FAMILIES = ("vae", "gmm_vae", "simple_vae", "attn_rnn_xe")
LR = 1e-4


def small_conf(recipe, dec_embed=E, port=False, **over):
    """``configs/<recipe>.yaml`` at test size; ``port`` zeroes Cnn10's
    dropouts (the JAX side patches them out)."""
    conf = json.loads(json.dumps(load_config(f"configs/{recipe}.yaml")))
    conf["encoder_args"] = {"embed_size": E, "channels": [4, 8, 8, 16]}
    if port:
        conf["encoder_args"].update(conv_dropout=0.0, head_dropout=0.0)
    dec = dict(conf["decoder_args"], embed_size=dec_embed, dropout=0.0)
    if "nhead" in dec:
        dec.update(nhead=2, hidden_size=32)
    else:
        dec["hidden_size"] = dec_embed
    conf["decoder_args"] = dec
    for key, h in (("posterior_args", 8), ("prior_args", 12)):
        if key in conf.get("model_args", {}):
            conf["model_args"][key] = dict(conf["model_args"][key], hidden_size=h)
    conf.update(data_dim=FDIM, augments=None, **over)
    return conf


def batch(seed=0, n=N, L=8):
    rng = np.random.default_rng(seed)
    caps = rng.integers(3, V, size=(n, L)).astype(np.int32)
    caps[:, 0] = 1
    return {"feats": rng.normal(size=(n, TMEL, FDIM)).astype(np.float32),
            "feat_lens": np.array([TMEL, 48, 33][:n], np.int32),
            "caps": caps, "cap_lens": np.array([L, 5, 3][:n], np.int32)}


class Pair:
    """A JAX model with seeded variables (BatchNorm statistics and the GMM
    mixture logits moved off their init) and its port copy."""

    def __init__(self, recipe, dec_embed=E, seed=0, **over):
        self.recipe = recipe
        self.conf = small_conf(recipe, dec_embed, **over)
        self.port_conf = small_conf(recipe, dec_embed, port=True, **over)
        self.model = j_build_model(self.conf, V, FDIM)
        b = batch(seed)
        variables = jax.jit(lambda k1, k2: self.model.init(
            {"params": k1, "sample": k2}, b["feats"], b["feat_lens"], b["caps"],
            b["cap_lens"], train=False))(jax.random.key(seed),
                                         jax.random.key(seed + 1))
        variables = jax.tree_util.tree_map(np.array, variables)
        rng = np.random.default_rng(seed + 5)
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
            name = jax.tree_util.keystr(path)
            if "batch_stats" in name:
                leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape) if "var" in name
                             else rng.normal(0, 0.3, leaf.shape))
            elif "mixture_logits" in name:
                leaf[...] = [0.1, 0.9, 0.4]    # component 1 the argmax
        self.variables = variables
        self.port = self.port_model()

    def port_model(self):
        m = build_model(self.port_conf, V, FDIM, device="cpu")
        m.load_state_dict(from_flax(self.variables), strict=True)
        return m.eval()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: at these sizes it is as fast, and
    a parallel test run on shared cores makes torch's spinning thread pool
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def no_jax_dropout():
    mp = pytest.MonkeyPatch()
    mp.setattr(jenc._DropoutMixin, "_dropout", lambda self, x, rate, train: x)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pairs(no_jax_dropout):
    return {}


def get_pair(pairs, recipe, dec_embed=E):
    key = (recipe, dec_embed)
    if key not in pairs:
        pairs[key] = Pair(recipe, dec_embed)
    return pairs[key]


def slab(steps, rows, dim):
    return EPS_SLAB[:steps, :rows, :dim]


@pytest.fixture
def fixed_eps(monkeypatch):
    """The JAX models' eps_stack returns the leading block of EPS_SLAB."""
    for mod in (jvae, jtrans):
        monkeypatch.setattr(mod, "eps_stack", lambda key, steps, rows, dim,
                            dtype=None: jnp.asarray(slab(steps, rows, dim)))


def first_key_normal(pair, key, shape):
    """normal(make_rng("sample"), shape): the JAX model's first draw."""
    rk = pair.model.apply(pair.variables, rngs={"sample": key},
                          method=lambda m: m.make_rng("sample"))
    return np.asarray(jax.random.normal(rk, shape))


def dbs_eps(pair, key, G, steps, rows, dim):
    """The JAX model's per-group dbs prior noise [G, steps, rows, dim]."""
    rk = pair.model.apply(pair.variables, rngs={"sample": key},
                          method=lambda m: m.make_rng("sample"))
    return np.asarray(jax.vmap(lambda k: j_eps_stack(k, steps, rows, dim))(
        jax.random.split(rk, G)))


def recovered_noise(out, ss_ratio, dis_ratio, mixture=None):
    """The noise of a JAX train forward, from its outputs."""
    T_ = out["logits"].shape[1]

    def eps(z, mean, log):
        return torch.tensor((z - mean) / np.exp(0.5 * log))
    noise = {"ss_coins": torch.full((T_,), ss_ratio >= 1.0),
             "dis_coins": torch.full((T_,), dis_ratio > 0.0)}
    if "q_z" in out:
        noise["q_eps"] = eps(out["q_z"], out["q_means"], out["q_logs"])
    if "p_z" in out and out["p_means"].ndim == 4:     # GMM: [K, N, T, E]
        c = int(np.argmax(mixture))
        noise["p_eps"] = eps(out["p_z"], out["p_means"][c], out["p_logs"][c]
                             ).transpose(0, 1).contiguous()
    elif "p_z" in out and out["p_means"].ndim == 3:
        noise["p_eps"] = eps(out["p_z"], out["p_means"], out["p_logs"]
                             ).transpose(0, 1).contiguous()
    elif "p_z" in out:                                 # SimpleVAE
        noise["p_eps"] = eps(out["p_z"], out["p_means"], out["p_logs"])
    return noise


def jax_train_forward(pair, b, key, ss_ratio, dis_ratio):
    """The JAX train forward (jitted once a pair, the ratios traced)."""
    if not hasattr(pair, "train_fn"):
        pair.train_fn = jax.jit(lambda v, bt, k, ss, dis: pair.model.apply(
            v, bt["feats"], bt["feat_lens"], bt["caps"], bt["cap_lens"],
            ss_ratio=ss, dis_ratio=dis, train=True, rngs={"sample": k},
            mutable=["batch_stats"])[0])
    out = pair.train_fn(pair.variables, b, key, ss_ratio, dis_ratio)
    return jax.tree_util.tree_map(np.asarray, out)


def mixture_of(pair):
    return pair.variables["params"].get("pnet", {}).get("mixture_logits")


def close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5, err_msg=msg)


def check_train_forward(pairs, recipe, dec_embed, ss_ratio, dis_ratio):
    pair = get_pair(pairs, recipe, dec_embed)
    b = batch(1)
    ref = jax_train_forward(pair, b, jax.random.key(4), ss_ratio, dis_ratio)
    model = pair.port_model().train()
    tb = {k: torch.tensor(v) for k, v in b.items()}
    out = model.train_forward(
        tb["feats"], tb["feat_lens"], tb["caps"], tb["cap_lens"], ss_ratio,
        dis_ratio, noise=recovered_noise(ref, ss_ratio, dis_ratio,
                                         mixture_of(pair)))
    keys = [k for k in ("logits", "output", "p_means", "p_logs", "p_z",
                        "q_means", "q_logs", "q_z", "p_mixture_logits")
            if k in ref]
    assert set(keys) <= set(out), sorted(set(keys) - set(out))
    for k in keys:
        assert out[k].shape == ref[k].shape, (k, out[k].shape, ref[k].shape)
        close(out[k].detach(), ref[k], k)
    if "seqs" in ref:
        np.testing.assert_array_equal(out["seqs"].numpy(), ref["seqs"])


@pytest.mark.parametrize("dec_embed,ss_ratio,dis_ratio",
                         [(E, 1.0, 0.0), (E_LN, 0.0, 1.0)],
                         ids=["teacher", "feedback-ln"])
@pytest.mark.parametrize("recipe", FAMILIES)
def test_train_forward_matches_jax(pairs, recipe, dec_embed, ss_ratio, dis_ratio):
    check_train_forward(pairs, recipe, dec_embed, ss_ratio, dis_ratio)


def check_train_step(pairs, recipe):
    """One train step, the recipe's loss mix (label smoothing, the KL at
    kl_weight 0.7, alpha where the family has the global head): loss and
    every JAX metric rtol 1e-4; parameters after clip + Adam atol 1e-5;
    BatchNorm statistics rtol 1e-5.  The learning rate is 1e-4: Adam's
    first step moves a parameter by about lr·sign(g), so a gradient at
    float-noise size (~1e-8, the size of Adam's eps) turns its relative
    error into up to ~lr/40 of difference; at 1e-4 that stays under the
    tolerance while every real update (~1e-4) is ten times above it."""
    pair = get_pair(pairs, recipe)
    conf = dict(pair.port_conf, scheduler="constant",
                optimizer_args={"lr": LR}, scheduler_args={})
    b = batch(2)
    step = make_train_step(pair.model, smoothing=0.1, kl_mask="valid",
                           alpha=conf.get("alpha"), donate=False)
    state = TrainState.create(pair.variables,
                              build_optimizer("Adam", LR, max_grad_norm=1.0))
    rng = jax.random.key(11)
    new_state, ref_m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            rng, 0.0, 1.0, 0.7, 0.5)
    k_sample = jax.random.split(rng, 4)[0]
    out = jax_train_forward(pair, b, k_sample, 0.0, 1.0)
    trainer = Trainer(conf, V, FDIM, device="cpu", total_iters=100)
    trainer.model.load_state_dict(from_flax(pair.variables), strict=True)
    trainer.ratios = lambda it, ep: {"ss_ratio": 0.0, "dis_ratio": 1.0,
                                     "kl_weight": 0.7}
    metrics = trainer.step(b, iteration=1, epoch=1,
                           noise=recovered_noise(out, 0.0, 1.0, mixture_of(pair)))
    assert set(ref_m) <= set(metrics), sorted(set(ref_m) - set(metrics))
    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref_params = from_flax({"params": new_state.params})
    before = from_flax(pair.variables)
    named = dict(trainer.model.named_parameters())
    moved = 0.0
    for k, p in named.items():
        got, want = p.detach().numpy(), ref_params[k].numpy()
        if k.endswith("in_proj_bias"):
            # the key bias adds one constant to every logit of a query, so
            # its exact gradient is zero: Adam's first step turns its float
            # noise into a step anywhere within ±lr
            e = got.shape[0] // 3
            np.testing.assert_allclose(got[e:2 * e], want[e:2 * e], rtol=0,
                                       atol=2 * LR, err_msg=k)
            got, want = np.delete(got, np.s_[e:2 * e]), np.delete(want, np.s_[e:2 * e])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
        moved = max(moved, float((p.detach() - before[k]).abs().max()))
    assert moved > 5e-5, f"the step moved no parameter beyond 5e-5 ({moved})"
    ref_stats = from_flax({"batch_stats": new_state.batch_stats})
    sd = trainer.model.state_dict()
    for k, s in ref_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), s.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    return metrics


@pytest.mark.parametrize("recipe", FAMILIES)
def test_train_step_matches_jax(pairs, recipe):
    metrics = check_train_step(pairs, recipe)
    # the family's loss mix: CE only for the plain captioner, a KL without
    # the Normal prior's diagnostics for the GMM prior
    assert ("kl" in metrics) == (recipe != "attn_rnn_xe")
    assert ("active_units" in metrics) == (recipe in ("vae", "simple_vae"))
    assert "global" not in metrics


# --------------------------------------------------------------------- #
# decodes
# --------------------------------------------------------------------- #
def mels(n=N, seed=7):
    b = batch(seed, n)
    return b["feats"], b["feat_lens"]


def prior_eps(pair, method, rows, steps=T, dim=None):
    """The noise the port takes for a decode of ``pair``'s family."""
    dim = dim or pair.conf["decoder_args"]["embed_size"]
    return torch.tensor(slab(steps, rows, dim))


def check_decodes(pair, key=3):
    """greedy and beam-3 tokens identical (scores rtol 1e-5), then
    forced_decode of the greedy tokens, log-probs atol 1e-5."""
    feats, lens = mels()
    tf, tl = torch.tensor(feats), torch.tensor(lens)
    simple = pair.recipe == "simple_vae"
    De = pair.conf["decoder_args"]["embed_size"]
    for method, rows in (("greedy", N), ("beam", N * 3)):
        jk = jax.random.key(key)
        ref = pair.model.apply(pair.variables, feats, lens, decode_method=method,
                               beam_size=3, max_length=T, rngs={"sample": jk})
        eps = (torch.tensor(first_key_normal(pair, jk, (rows, De))) if simple
               else prior_eps(pair, method, rows))
        out = pair.port.inference_forward(tf, tl, decode_method=method,
                                          beam_size=3, max_length=T, eps=eps)
        np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]),
                                      err_msg=method)
        if method == "beam":
            np.testing.assert_allclose(out["scores"].numpy(),
                                       np.asarray(ref["scores"]), rtol=1e-5,
                                       atol=1e-5)
        else:
            seqs = ref["seqs"]
    jk = jax.random.key(key + 1)
    ref = pair.model.apply(pair.variables, feats, lens, seqs,
                           rngs={"sample": jk}, method=pair.model.forced_decode)
    eps = (torch.tensor(first_key_normal(pair, jk, (N, De))) if simple
           else prior_eps(pair, "greedy", N))
    out = pair.port.forced_decode(tf, tl, torch.tensor(np.asarray(seqs)), eps=eps)
    np.testing.assert_allclose(out["sampled_logprobs"].numpy(),
                               np.asarray(ref["sampled_logprobs"]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("recipe", FAMILIES)
def test_decodes_match_jax(pairs, fixed_eps, recipe):
    """Through the ``ln`` adapter (the train forward covers both sizes)."""
    check_decodes(get_pair(pairs, recipe, E_LN))


def check_dbs(pair, beam_size=4, group_size=2, key=5):
    feats, lens = mels()
    jk = jax.random.key(key)
    case = dict(beam_size=beam_size, group_size=group_size,
                diversity_lambda=0.5)
    ref = pair.model.apply(pair.variables, feats, lens, rngs={"sample": jk},
                           decode_method="dbs", max_length=T, **case)
    De = pair.conf["decoder_args"]["embed_size"]
    rows = N * (beam_size // group_size)
    if pair.recipe == "simple_vae":
        eps = first_key_normal(pair, jk, (group_size, rows, De))
    elif pair.recipe in ("attn_rnn_xe", "xe_baseline"):
        eps = None
    else:
        eps = dbs_eps(pair, jk, group_size, T + group_size - 1, rows, De)
        assert not np.array_equal(eps[0], eps[1])
    out = pair.port.inference_forward(
        torch.tensor(feats), torch.tensor(lens), decode_method="dbs",
        max_length=T, eps=None if eps is None else torch.tensor(eps), **case)
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("recipe", FAMILIES)
def test_dbs_matches_jax(pairs, recipe):
    check_dbs(get_pair(pairs, recipe, E_LN))


@pytest.mark.parametrize("recipe", ["vae", "gmm_vae"])
def test_int8_beam_matches_jax(pairs, recipe):
    """The int8 v2sym encoder (JAX's bake carried across) in front of the
    two families JAX serves in int8, through the ``ln`` adapter."""
    pair = get_pair(pairs, recipe, E_LN)
    jq = jquant.quant_encoder_for(pair.conf, pair.model,
                                  pair.variables["params"],
                                  pair.variables["batch_stats"],
                                  **jquant.scheme_kwargs("v2sym"))
    feats, lens = mels()
    kw = dict(decode_method="beam", beam_size=3, max_length=T)
    ref = jquant.int8_decode_fn(pair.model, jq, **kw)(
        pair.variables, feats, lens, jax.random.key(2))
    pq = quant_from_flax(jax_baked(jq), device="cpu")
    # the JAX side runs eps_stack unpatched under its jit: feed its draws
    rk = jax.random.key(2)
    eps = np.asarray(j_eps_stack(pair.model.apply(
        pair.variables, rngs={"sample": rk},
        method=lambda m: m.make_rng("sample")), T, N * 3, E_LN))
    out = tquant.int8_decode_fn(pair.port, pq, **kw)(
        torch.tensor(feats), torch.tensor(lens), eps=torch.tensor(eps))
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))


def test_ensemble_of_attn_captioners_matches_jax(pairs):
    """Seq2SeqAttn has the step-decode API: a two-member ensemble (one with
    the ``ln`` adapter) decodes as JAX's, beam and greedy."""
    a, b = get_pair(pairs, "attn_rnn_xe"), get_pair(pairs, "attn_rnn_xe", E_LN)
    feats, lens = mels()
    for method in ("beam", "greedy"):
        ref = j_ensemble_decode([(a.model, a.variables), (b.model, b.variables)],
                                jnp.asarray(feats), jnp.asarray(lens),
                                jax.random.key(0), decode_method=method,
                                beam_size=3, max_length=T)
        out = ensemble_decode([a.port, b.port], torch.tensor(feats),
                              torch.tensor(lens), decode_method=method,
                              beam_size=3, max_length=T)
        np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))


@pytest.mark.parametrize("recipe", ["simple_vae"])
def test_ensemble_int8_and_bf16_refuse_what_jax_refuses(pairs, recipe):
    """SimpleVAE has neither the step-decode API nor
    inference_from_encoded: the ensemble and the int8 encoder raise, with
    JAX's messages; the bf16 decode, which JAX's tests do not cover for it,
    raises too."""
    pair = get_pair(pairs, recipe)
    feats, lens = (torch.tensor(x) for x in mels())
    with pytest.raises(ValueError, match="step-decode API"):
        ensemble_decode([pair.port, pair.port], feats, lens)
    with pytest.raises(ValueError, match="inference_from_encoded") as ours:
        tquant.quant_encoder_for(pair.port_conf, pair.port)
    with pytest.raises(ValueError) as ref:
        jquant.quant_encoder_for(pair.conf, pair.model, pair.variables["params"],
                                 pair.variables["batch_stats"])
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="decode_dtype"):
        cast_floats_for_decode(pair.port, torch.bfloat16)
    gmm = get_pair(pairs, "gmm_vae")
    with pytest.raises(ValueError, match="decode_dtype"):
        cast_floats_for_decode(gmm.port, torch.bfloat16)


def test_bf16_decode_runs_for_the_covered_families(pairs):
    """As JAX's tests/test_amp.py: a bf16 decode of VAEModel (Normal prior)
    and Seq2SeqAttn runs beam and greedy, its state in bf16."""
    feats, lens = (torch.tensor(x) for x in mels())
    for recipe in ("vae", "attn_rnn_xe"):
        m = cast_floats_for_decode(get_pair(pairs, recipe, E_LN).port,
                                   torch.bfloat16)
        assert m.decoder.state_dtype() == torch.bfloat16
        for method in ("beam", "greedy"):
            seqs = m.inference_forward(feats, lens, decode_method=method,
                                       max_length=T)["seqs"]
            assert ((seqs >= 0) & (seqs < V)).all()


# --------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------- #
def test_gmm_kl_loss_matches_jax():
    rng = np.random.default_rng(3)
    K, n, t, e = 3, 2, 5, 4
    mq, lq = rng.normal(size=(2, n, t, e)).astype(np.float32)
    mp, lp = rng.normal(size=(2, K, n, t, e)).astype(np.float32)
    cq, cp = rng.normal(size=(2, K)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([[5], [2]])
    for m in (mask, None):
        ref = j_gmm_kl_loss(mq, lq, cq, mp, lp, cp, m)
        out = gmm_kl_loss(*(torch.tensor(x) for x in (mq, lq, cq, mp, lp, cp)),
                          None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_rnn_decoder_matches_jax():
    """RNNDecoder (no family routes it): teacher forcing over a pooled
    memory and one step."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, V, size=(N, 6)).astype(np.int32)
    mem = rng.normal(size=(N, 10)).astype(np.float32)
    dec = JRNNDecoder(vocab_size=V, enc_mem_size=10, embed_size=8, hidden_size=12)
    variables = jax.tree_util.tree_map(
        np.asarray, dec.init(jax.random.key(0), words, mem))
    ref = dec.apply(variables, words, mem)
    h0 = rng.normal(size=(N, 12)).astype(np.float32)
    ref_step = dec.apply(variables, words[:, 0], h0, mem, method=dec.step)
    port = RNNDecoder(V, 10, embed_size=8, hidden_size=12)
    port.load_state_dict(from_flax(variables), strict=True)
    with torch.no_grad():
        out = port(torch.tensor(words), torch.tensor(mem))
        step = port.step(torch.tensor(words[:, 0]), torch.tensor(h0),
                         torch.tensor(mem))
    for k in ("output", "logits"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(step[k].numpy(), ref_step[k], rtol=1e-5,
                                   atol=1e-5)


def test_luong_decoder_captioner_matches_jax(pairs, fixed_eps):
    """Seq2SeqAttn with the RNNLuongAttnDecoder: train forward and the
    decodes, as the recipe's Bahdanau decoder."""
    over = dict(decoder="RNNLuongAttnDecoder",
                decoder_args={"embed_size": E, "hidden_size": 12,
                              "attn_hidden_size": 10, "dropout": 0.0})
    pair = Pair("attn_rnn_xe", **over)
    pairs[("luong", E)] = pair
    check_train_forward(pairs, "luong", E, 0.0, 1.0)
    check_decodes(pair)
