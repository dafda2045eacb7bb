"""Port parity: each model module of ``acvae_tpu_torch`` against its JAX
counterpart, on JAX-initialised weights carried over by
``acvae_tpu_torch.convert.from_flax`` and seeded numpy inputs.

Tolerance rtol=1e-5, atol=1e-5 (float32 on both sides; matmul and
reduction order differ).  Cnn10's dropouts are patched to identity on the
JAX side and set to 0 in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.models import encoders as jenc
from acvae_tpu.models.attention import AdditiveAttention as JAttention
from acvae_tpu.models.decoders import VAERNNBahdanauAttnDecoder as JDecoder
from acvae_tpu.models.latent import PosteriorRNNHybrid as JPosterior
from acvae_tpu.models.latent import PriorRNN as JPrior
from acvae_tpu.models.rnn import GRU as JGRU
from acvae_tpu.models.rnn import GRUCell as JGRUCell
from acvae_tpu.models.rnn import LSTMCell as JLSTMCell
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.models import encoders as tenc
from acvae_tpu_torch.models.attention import AdditiveAttention
from acvae_tpu_torch.models.decoders import VAERNNBahdanauAttnDecoder
from acvae_tpu_torch.models.latent import PosteriorRNNHybrid, PriorRNN
from acvae_tpu_torch.models.rnn import GRU, GRUCell, LSTMCell
from tests.test_torch_decode import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, H, N, S = 25, 16, 16, 3, 5


def _close(port, ref):
    if isinstance(port, (tuple, list)):
        for p, r in zip(port, ref):
            _close(p, r)
        return
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _port(module, variables):
    module.load_state_dict(from_flax(variables), strict=True)
    return module


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_gru_cell(rng):
    x, h = _rand(rng, N, 7), _rand(rng, N, H)
    jm = JGRUCell(H, 7)
    v = jm.init(jax.random.key(0), x, h)
    _close(_port(GRUCell(7, H), v)(torch.tensor(x), torch.tensor(h)),
           jm.apply(v, x, h))


def test_lstm_cell(rng):
    x, h, c = _rand(rng, N, 7), _rand(rng, N, H), _rand(rng, N, H)
    jm = JLSTMCell(H, 7)
    v = jm.init(jax.random.key(0), x, (h, c))
    _close(_port(LSTMCell(7, H), v)(torch.tensor(x),
                                    (torch.tensor(h), torch.tensor(c))),
           jm.apply(v, x, (h, c)))


def test_masked_bigru(rng):
    x = _rand(rng, N, 6, 7)
    lens = np.array([6, 3, 1], np.int32)
    jm = JGRU(H, 7, bidirectional=True)
    v = jm.init(jax.random.key(0), x, lens)
    out, h_n = _port(GRU(7, H, bidirectional=True), v)(torch.tensor(x),
                                                       torch.tensor(lens))
    j_out, j_h = jm.apply(v, x, lens)
    _close((out, h_n), (j_out, j_h))
    assert (out[1, 3:] == 0).all() and (out[2, 1:] == 0).all()


def test_additive_attention(rng):
    h_dec, h_enc = _rand(rng, N, H), _rand(rng, N, S, E + 3)
    mask = np.arange(S)[None] < np.array([[5], [2], [1]])
    jm = JAttention(12)

    def call(m, hd, he, mk):
        return m(hd, he, m.project_enc(he), mk)

    v = jm.init(jax.random.key(0), h_dec, h_enc, mask, method=call)
    tm = _port(AdditiveAttention(H, E + 3, 12), v)
    he = torch.tensor(h_enc)
    _close(tm(torch.tensor(h_dec), he, tm.project_enc(he), torch.tensor(mask)),
           jm.apply(v, h_dec, h_enc, mask, method=call))


@pytest.fixture
def cnn10_pair(monkeypatch, rng):
    monkeypatch.setattr(jenc._DropoutMixin, "_dropout",
                        lambda self, x, rate, train: x)
    chans = (4, 8, 8, 16)
    feats = _rand(rng, N, 64, 16)
    lens = np.array([64, 48, 33], np.int32)
    jm = jenc.Cnn10(inputdim=16, embed_size=16, channels=chans)
    v = jm.init(jax.random.key(0), feats, lens, train=False)
    # non-trivial running statistics, so eval mode checks their use
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype),
        v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    tm = _port(tenc.Cnn10(16, 16, chans, conv_dropout=0.0, head_dropout=0.0), v)
    return jm, v, tm, feats, lens


def _enc_outputs(d):
    return [d["audio_embeds"], d["audio_embeds_pooled"], d["audio_embeds_lens"]]


def test_cnn10_eval(cnn10_pair):
    jm, v, tm, feats, lens = cnn10_pair
    port = tm(torch.tensor(feats), torch.tensor(lens), train=False)
    _close(_enc_outputs(port), _enc_outputs(jm.apply(v, feats, lens)))


def test_cnn10_train_updates_batch_stats(cnn10_pair):
    jm, v, tm, feats, lens = cnn10_pair
    port = tm(torch.tensor(feats), torch.tensor(lens), train=True)
    ref, upd = jm.apply(v, feats, lens, train=True, mutable=["batch_stats"])
    _close(_enc_outputs(port), _enc_outputs(ref))
    new_stats = from_flax({"batch_stats": upd["batch_stats"]})
    sd = tm.state_dict()
    assert len(new_stats) == 2 * 9   # bn0 + 2 per block, mean and var each
    for k, ref_v in new_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), ref_v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_posterior_rnn_hybrid(rng):
    L = 7
    caps = rng.integers(3, V, size=(N, L)).astype(np.int32)
    cap_lens = np.array([7, 4, 2], np.int32)
    eps = _rand(rng, N, L - 1, E)
    jm = JPosterior(V, word_dim=E, embed_size=E, hidden_size=H)
    v = jm.init(jax.random.key(0), caps, cap_lens, eps)
    port = _port(PosteriorRNNHybrid(V, E, E, H), v)(
        torch.tensor(caps), torch.tensor(cap_lens), torch.tensor(eps))
    ref = jm.apply(v, caps, cap_lens, eps)
    for k in ("q_means", "q_logs", "q_z", "q_means_utt"):
        _close(port[k], ref[k])


def _enc_ctx(rng):
    enc_mem = _rand(rng, N, S, E)
    mask = np.arange(S)[None] < np.array([[5], [3], [1]])
    return enc_mem, mask


def test_prior_rnn_step(rng):
    enc_mem, mask = _enc_ctx(rng)
    word = rng.integers(0, V, size=N).astype(np.int32)
    state = (_rand(rng, N, H), _rand(rng, N, H))
    last_z, eps = _rand(rng, N, E), _rand(rng, N, E)
    jm = JPrior(V, word_dim=E, audiofeats_size=E, embed_size=E, hidden_size=H)

    def step(m, *a):
        return m.step(a[0], a[1], m.project_enc(a[1]), *a[2:])

    args = (word, enc_mem, mask, state, last_z, eps)
    v = jm.init(jax.random.key(0), *args, method=step)
    tm = _port(PriorRNN(V, E, E, E, H), v)
    t_args = [torch.tensor(a) if not isinstance(a, tuple)
              else tuple(map(torch.tensor, a)) for a in args]
    t_args[0] = t_args[0].long()
    port = tm.step(t_args[0], t_args[1], tm.project_enc(t_args[1]), *t_args[2:])
    ref = jm.apply(v, *args, method=step)
    for k in ("mean", "log", "z", "state", "attn_weights"):
        _close(port[k], ref[k])


def test_decoder_step(rng):
    enc_mem, mask = _enc_ctx(rng)
    word = rng.integers(0, V, size=N).astype(np.int32)
    state, z = _rand(rng, N, H), _rand(rng, N, E)
    jm = JDecoder(V, E, embed_size=E, hidden_size=H)

    def step(m, w, st, em, mk, zz):
        return m.step(w, st, em, m.project_enc(em), mk, zz)

    args = (word, state, enc_mem, mask, z)
    v = jm.init(jax.random.key(0), *args, method=step)
    tm = _port(VAERNNBahdanauAttnDecoder(V, E, E, H), v)
    w, st, em, mk, zz = map(torch.tensor, args)
    port = tm.step(w.long(), st, em, tm.project_enc(em), mk, zz)
    ref = jm.apply(v, *args, method=step)
    for k in ("state", "logits", "attn_weights"):
        _close(port[k], ref[k])
