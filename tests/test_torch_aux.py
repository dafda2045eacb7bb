"""Port parity: the auxiliary training stack of ``acvae_tpu_torch`` (the
loss wrappers, the caption discriminators, the stage-1 GE2E embedder, the
global sentence VAE, the caption-only datasets, the sentence head and the
three recipe terms of the train step) against ``acvae_tpu``.

Small sizes (vocab 30, widths <= 16), inputs drawn by numpy from seeds,
weights carried across with ``from_flax``.  The JAX side's random draws are
handed to the port: Gumbel noise ``jax.random.gumbel`` of the JAX key (the
train step's ``k_adv`` of ``split(rng, 4)``), the global VAE's eps, word
dropout coins, prior z and sampling noise from its ``make_rng("sample")``
key, the train forwards' latent noise recovered from the JAX outputs
(``tests/test_torch_families_rnn.py``).  Cnn10's dropouts are identity on
the JAX side and 0 in the port.

Tolerances: float32 forwards, losses and gradients atol 1e-5 (``get_cossim``
1e-6); the flagship-family train forwards and steps as
``tests/test_torch_families_rnn.py`` holds them (metrics rtol 1e-4: the
recurrent decoder's float32 sums over 7 steps; parameters after one Adam
step at lr 1e-4 atol 1e-5); datasets' batches, ``equal_error_rate`` and
decoded tokens identical.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import acvae_tpu.losses.wrappers as jw
import acvae_tpu.models.stage1 as js1
from acvae_tpu.core.registry import ENCODERS as J_ENCODERS
from acvae_tpu.data import aux_datasets as jaux
from acvae_tpu.data import synthetic as jsyn
from acvae_tpu.models.discriminator import (
    Aud2CapDiscriminatorTrainer as JAud2Cap,
    Cap2CapDiscriminatorTrainer as JCap2Cap, DiscriminatorModel as JDM,
    DiscriminatorRNNModel as JD)
from acvae_tpu.models.global_vae import GlobalSentenceVAE as JGVAE
from acvae_tpu.ops.losses import cross_entropy as j_ce, normal_kl_loss as j_kl
from acvae_tpu.ops.masked import length_mask as j_length_mask
from acvae_tpu.train.trainer import TrainState, build_optimizer, make_train_step
import acvae_tpu_torch.losses.wrappers as tw
import acvae_tpu_torch.models.stage1 as ts1
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.data import aux_datasets as taux
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.discriminator import (
    Aud2CapDiscriminatorTrainer, Cap2CapDiscriminatorTrainer,
    DiscriminatorModel, DiscriminatorRNNModel)
from acvae_tpu_torch.models.encoders import build_encoder
from acvae_tpu_torch.models.global_vae import GlobalSentenceVAE
from acvae_tpu_torch.ops.losses import cross_entropy, normal_kl_loss
from acvae_tpu_torch.ops.masked import length_mask
from acvae_tpu_torch.train.optim import OptaxChain
from acvae_tpu_torch.train.trainer import Trainer, compute_loss
from tests.test_torch_families_rnn import (E, FDIM, LR, V, Pair, batch,
                                           get_pair, jax_train_forward,
                                           no_jax_dropout, one_torch_thread,  # noqa: F401
                                           pairs, recovered_noise)
from tests.test_torch_train_step import _capture_grads

N, T = 3, 6
LENS = np.array([6, 4, 1], np.int32)
DARGS = {"word_dim": 8, "hidden_size": 6, "embed_size": 5}
ATOL = 1e-5


def close(a, b, msg="", atol=ATOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol, err_msg=msg)


def _t(a):
    return torch.tensor(np.asarray(a))


def _logits(seed=0, shape=(N, T, V)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _targets(seed=1):
    return np.random.default_rng(seed).integers(0, V, size=(N, T)).astype(np.int32)


# --------------------------------------------------------------------- #
# losses/wrappers.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind", ["cross_entropy", "label_smoothing"])
def test_masked_losses_match_jax(kind, reduction):
    lg, tg = _logits(), _targets()
    if kind == "cross_entropy":
        got = tw.masked_cross_entropy(_t(lg), _t(tg), _t(LENS), reduction)
        want = jw.masked_cross_entropy(lg, tg, LENS, reduction)
    else:
        got = tw.masked_label_smoothing(_t(lg), _t(tg), _t(LENS), 0.1, reduction)
        want = jw.masked_label_smoothing(lg, tg, LENS, 0.1, reduction)
    close(got, want)


def test_augment_keep_mask_identical():
    """Same draws from the same numpy generator: identical masks."""
    ids = ["a", "aug_1", 3, "x_aug", "aug", "b", "augmented"]
    for p, seed in ((0.5, 0), (0.2, 7), (1.0, 3), (0.0, 4)):
        got = tw.augment_keep_mask(ids, p, np.random.default_rng(seed))
        want = jw.augment_keep_mask(ids, p, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tw.augment_keep_mask(ids, 0.0, np.random.default_rng(0)).tolist() == [
        True, False, True, False, False, True, False]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_augment_loss_matches_jax(smoothing):
    lg, tg = _logits(2), _targets(3)
    keep = np.array([1.0, 0.0, 1.0], np.float32)
    got = tw.augment_loss(_t(lg), _t(tg), _t(LENS), _t(keep), smoothing)
    close(got, jw.augment_loss(lg, tg, LENS, jnp.asarray(keep), smoothing))


def _st_grads(j_fn, t_fn, lg, w):
    """Value and gradient of sum(w · fn(logits)) on both sides."""
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(w * j_fn(x)))(jnp.asarray(lg))
    x = torch.tensor(lg, requires_grad=True)
    tv = torch.sum(_t(w) * t_fn(x))
    tv.backward()
    return (tv, jv), (x.grad, jg)


@pytest.mark.parametrize("method", ["argmax", "gumbel", "weighted"])
def test_straight_through_samples_match_jax(method):
    """``_sample_preds``: the values (one-hots for argmax and gumbel, the
    same Gumbel noise on both sides) and the straight-through gradients."""
    lg = _logits(4)
    w = np.random.default_rng(5).normal(size=lg.shape).astype(np.float32)
    key = jax.random.key(9)
    g = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))
    got = tw._sample_preds(_t(lg), method, _t(g))
    want = jw._sample_preds(jnp.asarray(lg), method, key)
    close(got, want)
    if method != "weighted":
        assert set(np.unique(got.numpy())) == {0.0, 1.0}
    (tv, jv), (tg, jg) = _st_grads(
        lambda x: jw._sample_preds(x, method, key),
        lambda x: tw._sample_preds(x, method, _t(g)), lg, w)
    close(tv, jv)
    close(tg, jg)
    if method == "argmax":      # the gradient of the logits themselves
        close(tg, w)
    if method != "weighted":
        fn = (tw.reparameterize_argmax(_t(lg)) if method == "argmax"
              else tw.gumbel_softmax(_t(lg), _t(g)))
        close(fn, want)


def test_bce_logits_loss_matches_jax():
    rng = np.random.default_rng(6)
    probs = np.concatenate([rng.uniform(size=8), [0.0, 1.0, 1e-9, 1 - 1e-9]])
    probs = probs.astype(np.float32)
    labels = rng.integers(0, 2, size=probs.shape).astype(np.float32)
    for pw in (1.0, 2.5):
        close(tw.bce_logits_loss(_t(probs), _t(labels), pw),
              jw.bce_logits_loss(probs, labels, pw))


@pytest.fixture(scope="module")
def dscrm():
    """A JAX DiscriminatorRNNModel (audio 16 wide) and its port copy."""
    jd = JD(vocab_size=V, audio_dim=E, **DARGS)
    rng = np.random.default_rng(11)
    audio = rng.normal(size=(N, 5, E)).astype(np.float32)
    caps = rng.integers(0, V, size=(N, T)).astype(np.int32)
    v = jax.jit(lambda k: jd.init(k, audio, np.array([5, 3, 2]), caps, LENS,
                                  method=jd.aud2cap))(jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, v)
    port = DiscriminatorRNNModel(V, audio_dim=E, device="cpu", **DARGS)
    port.load_state_dict(from_flax(v), strict=True)
    return jd, v, port


def test_condition_and_specificity_losses_match_jax(dscrm):
    """condition_loss through the discriminator's aud2cap against a fixed
    audio (value and the gradient of the logits); specificity_loss summed
    and averaged."""
    jd, v, port = dscrm
    rng = np.random.default_rng(12)
    lg, audio = _logits(13), rng.normal(size=(N, E)).astype(np.float32)
    cond = rng.uniform(size=N).astype(np.float32)
    lens = np.array([7, 5, 2], np.int32)
    key = jax.random.key(3)

    def j_dscrm(b):
        return jax.nn.sigmoid(jd.apply(v, audio, None, b["caps"], b["lens"],
                                       method=jd.aud2cap))

    def t_dscrm(b):
        return torch.sigmoid(port.aud2cap(_t(audio), None, b["caps"], b["lens"]))

    def j_loss(x):
        return jw.condition_loss(1.5, x, cond, lens, j_dscrm, key, 0.7)[0]

    x = torch.tensor(lg, requires_grad=True)
    got = tw.condition_loss(torch.tensor(1.5), x, _t(cond), _t(lens), t_dscrm, 0.7)
    got[0].backward()
    want = jw.condition_loss(1.5, lg, cond, lens, j_dscrm, key, 0.7)
    for a, b in zip(got, want):
        close(a, b)
    close(x.grad, jax.grad(j_loss)(jnp.asarray(lg)))
    spec = rng.uniform(size=V).astype(np.float32)
    for reduce in ("sum", "mean"):
        got = tw.specificity_loss(torch.tensor(0.5), _t(lg), _t(cond), _t(lens),
                                  _t(spec), 2.0, reduce)
        want = jw.specificity_loss(0.5, lg, cond, lens, spec, 2.0, reduce)
        for a, b in zip(got, want):
            close(a, b, reduce)


@pytest.mark.parametrize("method", ["argmax", "gumbel"])
def test_adverse_loss_matches_jax(dscrm, method):
    """The AdverseLossWrapper: (loss, ce, kl, dscrm) and the gradients of
    the caption logits and the posterior means, through the
    straight-through sample into a sigmoid DiscriminatorModel."""
    _, v, _ = dscrm
    jdm = JDM(vocab_size=V, audio_dim=E, **DARGS)
    tdm = DiscriminatorModel(V, audio_dim=E, device="cpu", **DARGS)
    tdm.load_state_dict(from_flax(v), strict=True)
    rng = np.random.default_rng(14)
    lg, tg = _logits(15), _targets(16)
    qm, ql, pm, pl = (rng.normal(size=(N, T, 4)).astype(np.float32) * 0.5
                      for _ in range(4))
    audio = rng.normal(size=(N, 5, E)).astype(np.float32)
    alens = np.array([5, 3, 2], np.int32)
    lens = np.array([7, 5, 2], np.int32)
    label = np.ones(N, np.float32)
    mask = np.asarray(j_length_mask(lens - 1, T))
    key = jax.random.key(21)
    g = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))

    def j_loss(x, q):
        return jw.adverse_loss(x, tg, q, ql, pm, pl, x, label, lens,
                               lambda b: jdm.apply(v, b), key, 0.5, 0.8,
                               method, mask, audio, alens)

    want = j_loss(jnp.asarray(lg), jnp.asarray(qm))
    jg = jax.grad(lambda x, q: j_loss(x, q)[0], argnums=(0, 1))(
        jnp.asarray(lg), jnp.asarray(qm))
    x = torch.tensor(lg, requires_grad=True)
    q = torch.tensor(qm, requires_grad=True)
    got = tw.adverse_loss(x, _t(tg), q, _t(ql), _t(pm), _t(pl), x, _t(label),
                          _t(lens), tdm, 0.5, 0.8, method, _t(mask), _t(audio),
                          _t(alens), gumbel=_t(g))
    got[0].backward()
    for a, b, name in zip(got, want, ("loss", "ce", "kl", "dscrm")):
        close(a, b, name)
    close(x.grad, jg[0], "logits grad")
    close(q.grad, jg[1], "q_means grad")


# --------------------------------------------------------------------- #
# models/discriminator.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("caps_kind", ["ids", "soft", "pooled_audio"])
def test_discriminator_aud2cap_matches_jax(dscrm, caps_kind):
    jd, v, port = dscrm
    rng = np.random.default_rng(17)
    audio = rng.normal(size=(N, 5, E)).astype(np.float32)
    alens = np.array([5, 3, 2], np.int32)
    if caps_kind == "pooled_audio":
        audio, alens = audio[:, 0], None
    caps = (rng.integers(0, V, size=(N, T)).astype(np.int32) if caps_kind != "soft"
            else np.asarray(jax.nn.softmax(_logits(18), -1)))
    want = jd.apply(v, audio, alens, jnp.asarray(caps), LENS, method=jd.aud2cap)
    got = port.aud2cap(_t(audio), None if alens is None else _t(alens),
                       _t(caps), _t(LENS))
    close(got, want)
    close(port({"audio_feats": _t(audio), "feats_lens": None if alens is None
                else _t(alens), "caps": _t(caps), "lens": _t(LENS)}), want)


@pytest.mark.parametrize("caps_kind", ["ids", "soft"])
def test_discriminator_cap2cap_matches_jax(dscrm, caps_kind):
    jd, v, port = dscrm
    rng = np.random.default_rng(19)
    if caps_kind == "ids":
        a, b = (rng.integers(0, V, size=(N, T)).astype(np.int32) for _ in "ab")
    else:
        a, b = (np.asarray(jax.nn.softmax(_logits(s), -1)) for s in (20, 21))
    lb = np.array([3, 6, 2], np.int32)
    want = jd.apply(v, jnp.asarray(a), LENS, jnp.asarray(b), lb,
                    method=jd.cap2cap)
    close(port.cap2cap(_t(a), _t(LENS), _t(b), _t(lb)), want)


def test_aud2cap_trainer_matches_jax(no_jax_dropout):
    """Cnn10 (channels 4-8-8-16) + the discriminator, train mode (BatchNorm
    on batch statistics): both probabilities and the running statistics."""
    enc_args = {"embed_size": E, "channels": (4, 8, 8, 16)}
    model = JAud2Cap(encoder=J_ENCODERS.build("Cnn10", inputdim=FDIM, **enc_args),
                     dscrm=JD(vocab_size=V, audio_dim=E, **DARGS))
    b = batch(3)
    args = (b["feats"], b["feat_lens"], b["caps"], b["cap_lens"])
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: model.init({"params": k}, *args, train=False))(jax.random.key(1)))
    (pos, neg), upd = model.apply(v, *args, train=True, mutable=["batch_stats"])
    enc = build_encoder("Cnn10", dict(enc_args, conv_dropout=0.0,
                                      head_dropout=0.0), FDIM, "cpu")
    port = Aud2CapDiscriminatorTrainer(
        enc, DiscriminatorRNNModel(V, audio_dim=E, device="cpu", **DARGS))
    port.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        tp, tn = port(*(_t(a) for a in args), train=True)
    close(tp, pos)
    close(tn, neg)
    sd = port.state_dict()
    for k, s in from_flax({"batch_stats": upd["batch_stats"]}).items():
        close(sd[k], s, k)
    with torch.no_grad():
        ep, en = port(*(_t(a) for a in args), train=False)
    jp, jn = model.apply(dict(v, batch_stats=upd["batch_stats"]), *args,
                         train=False)
    close(ep, jp)
    close(en, jn)


def test_cap2cap_trainer_matches_jax(dscrm):
    _, v, port = dscrm
    u, A = 3, 2
    model = JCap2Cap(dscrm=JD(vocab_size=V, audio_dim=E, **DARGS), uttnumbers=u)
    rng = np.random.default_rng(22)
    caps = rng.integers(3, V, size=(A * u, T)).astype(np.int32)
    lens = np.array([6, 2, 4, 5, 1, 3], np.int32)
    pos, neg = model.apply({"params": {"dscrm": v["params"]}}, caps, lens)
    tp, tn = Cap2CapDiscriminatorTrainer(port, u)(_t(caps), _t(lens))
    close(tp, pos)
    close(tn, neg)


# --------------------------------------------------------------------- #
# models/stage1.py
# --------------------------------------------------------------------- #
def test_stage1_encoder_matches_jax():
    """Train mode (batch statistics, the running statistics after the step
    at momentum 0.9 with the biased variance), then eval mode on them."""
    jenc = js1.Stage1Encoder(vocab_size=V, word_dim=8, hidden_size=6, embed_size=5)
    rng = np.random.default_rng(23)
    caps = rng.integers(3, V, size=(8, T)).astype(np.int32)
    lens = np.array([6, 2, 4, 5, 1, 3, 6, 2], np.int32)
    v = jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.key(2), caps, lens))
    out, upd = jenc.apply(v, caps, lens, train=True, mutable=["batch_stats"])
    port = ts1.Stage1Encoder(V, word_dim=8, hidden_size=6, embed_size=5,
                             device="cpu")
    port.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        close(port(_t(caps), _t(lens), train=True), out)
        for k, s in from_flax({"batch_stats": upd["batch_stats"]}).items():
            close(port.state_dict()[k], s, k)
        v2 = dict(v, batch_stats=upd["batch_stats"])
        close(port(_t(caps), _t(lens)), jenc.apply(v2, caps, lens))


def _embeddings(seed=24, A=3, M=4, Ed=5):
    return np.random.default_rng(seed).normal(size=(A, M, Ed)).astype(np.float32)


def test_ge2e_loss_and_cossim_match_jax():
    """GE2E: the loss and its gradients (embeddings, w, b) atol 1e-5;
    ``get_cossim`` within 1e-6; w clamped at 1e-6."""
    emb = _embeddings()
    cent = np.asarray(js1.get_centroids(emb))
    close(ts1.get_centroids(_t(emb)), cent)
    close(ts1.get_utterance_centroids(_t(emb)), js1.get_utterance_centroids(emb))
    close(ts1.get_cossim(_t(emb), _t(cent)), js1.get_cossim(emb, cent),
          atol=1e-6)
    loss = ts1.GE2ELoss(device="cpu")
    x = torch.tensor(emb, requires_grad=True)
    got = loss(x)
    got.backward()
    params = {"w": jnp.asarray(10.0), "b": jnp.asarray(-5.0)}
    fn = lambda p, e: js1.GE2ELoss().apply({"params": p}, e)  # noqa: E731
    want, (gp, ge) = jax.value_and_grad(fn, argnums=(0, 1))(params, jnp.asarray(emb))
    close(got, want)
    close(x.grad, ge)
    close(loss.w.grad, gp["w"])
    close(loss.b.grad, gp["b"])
    with torch.no_grad():
        loss.w.fill_(-3.0)
        close(loss(x), fn({"w": jnp.asarray(-3.0), "b": jnp.asarray(-5.0)}, emb))


def test_equal_error_rate_identical():
    """The same similarity matrices give the same (EER, threshold) exactly:
    a random one, a stage-1 cossim, one with values on the 0.01 grid, the
    degenerate all-equal one (EER 0.5) and a perfect one."""
    rng = np.random.default_rng(25)
    emb = _embeddings(26, A=4, M=2)
    mats = [rng.uniform(-0.2, 1.0, size=(4, 3, 4)).astype(np.float32),
            np.asarray(js1.get_cossim(emb, js1.get_centroids(_embeddings(27, A=4)))),
            (rng.integers(0, 100, size=(3, 2, 3)) / 100.0).astype(np.float32),
            np.zeros((3, 2, 3), np.float32)]
    perfect = np.full((3, 2, 3), 0.1, np.float32)
    perfect[np.arange(3), :, np.arange(3)] = 0.9
    for m in mats + [perfect]:
        assert ts1.equal_error_rate(m) == js1.equal_error_rate(m)
        assert ts1.equal_error_rate(torch.tensor(m)) == js1.equal_error_rate(m)
    assert ts1.equal_error_rate(mats[3])[0] == 0.5
    assert ts1.equal_error_rate(perfect)[0] == 0.0
    with pytest.raises(ValueError, match="at least 2 audios"):
        ts1.equal_error_rate(np.zeros((1, 2, 1)))


# --------------------------------------------------------------------- #
# data/aux_datasets.py
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A rich synthetic corpus, one clip cut to 3 captions; both packages'
    vocabularies from one pickle."""
    _, info, jvocab = jsyn.make_synthetic_clotho_rich(num_audios=10, seed=3)
    info[2]["captions"] = info[2]["captions"][:3]
    path = tmp_path_factory.mktemp("aux") / "vocab.pkl"
    jvocab.save(str(path))
    return info, jvocab, Vocabulary.load(str(path))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            np.testing.assert_array_equal(u, w)
            assert u.dtype == w.dtype


def test_caption_corpus_batches_identical(corpus):
    info, jv, tv = corpus
    got, want = taux.CaptionCorpus(info, tv), jaux.CaptionCorpus(info, jv)
    assert len(got) == len(want) == 48
    for shuffle, seed, epoch in ((True, 1, 0), (True, 1, 2), (False, 0, 0)):
        _same_batches(got.batches(7, shuffle, seed, epoch),
                      want.batches(7, shuffle, seed, epoch))
    short = taux.CaptionCorpus(info, tv, max_cap_len=5)
    _same_batches(short.batches(16), jaux.CaptionCorpus(info, jv, 5).batches(16))


def test_stage1_dataset_batches_identical(corpus):
    info, jv, tv = corpus
    for utt, per in ((5, 3), (4, 2), (2, 4)):
        got = taux.Stage1Dataset(info, tv, uttnumbers=utt)
        want = jaux.Stage1Dataset(info, jv, uttnumbers=utt)
        assert len(got) == len(want) == (9 if utt > 3 else 10)
        for seed, epoch in ((1, 0), (1, 3), (5, 1)):
            _same_batches(got.batches(per, seed, epoch),
                          want.batches(per, seed, epoch))
            _same_batches([got.require_batch(per, seed, epoch)],
                          [want.require_batch(per, seed, epoch)])
    assert list(taux.Stage1Dataset(info[:2], tv).batches(3)) == []
    with pytest.raises(ValueError) as e:
        taux.Stage1Dataset(info, tv).require_batch(12)
    with pytest.raises(ValueError) as j:
        jaux.Stage1Dataset(info, jv).require_batch(12)
    assert str(e.value) == str(j.value)


# --------------------------------------------------------------------- #
# models/global_vae.py
# --------------------------------------------------------------------- #
GV = {"word_dim": 8, "hidden_size": 6, "latent_size": 4}


@pytest.fixture(scope="module")
def gvae():
    jm = JGVAE(vocab_size=V, **GV)
    caps, lens = _gv_batch()
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.key(4), "sample": jax.random.key(5)}, caps, lens,
        train=False))
    port = GlobalSentenceVAE(V, device="cpu", **GV)
    port.load_state_dict(from_flax(v), strict=True)
    return jm, v, port


def _gv_batch(seed=28):
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, V, size=(4, 8)).astype(np.int32)
    caps[:, 0] = 1
    return caps, np.array([8, 5, 3, 2], np.int32)


def _sample_key(jm, v, key):
    """The model's first ``make_rng("sample")`` under ``key``."""
    return jm.apply(v, rngs={"sample": key}, method=lambda m: m.make_rng("sample"))


def _gv_draws(jm, v, key, caps):
    k_eps, k_drop = jax.random.split(_sample_key(jm, v, key))
    N_, L = caps.shape
    eps = np.asarray(jax.random.normal(k_eps, (N_, GV["latent_size"])))
    coins = np.asarray(jax.random.uniform(k_drop, (N_, L - 1)) < 0.3)
    return _t(eps), _t(coins)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_global_vae_forward_matches_jax(gvae, train):
    """Teacher forcing with word dropout (train: the JAX coins; ids below 4
    kept) and without."""
    jm, v, port = gvae
    caps, lens = _gv_batch()
    key = jax.random.key(6)
    want = jm.apply(v, caps, lens, train=train, rngs={"sample": key})
    eps, coins = _gv_draws(jm, v, key, caps)
    assert coins.any() and not coins.all()
    with torch.no_grad():
        got = port(_t(caps), _t(lens), train=train, eps=eps, coins=coins)
    for k in ("logits", "mu", "logvar", "z"):
        close(got[k], want[k], k)


def test_global_vae_train_step_matches_jax(gvae):
    """One ``global_vae`` step: CE + 0.5·KL against N(0, 1), clip 1.0, Adam
    at lr 1e-4: the loss atol 1e-5, the parameters after it atol 1e-5."""
    jm, v, _ = gvae
    caps, lens = _gv_batch(29)
    key = jax.random.key(7)

    def loss_fn(p):
        out = jm.apply({"params": p}, caps, lens, train=True, rngs={"sample": key})
        mask = j_length_mask(lens - 1, caps.shape[1] - 1)
        kl = j_kl(out["mu"], out["logvar"], jnp.zeros_like(out["mu"]),
                  jnp.zeros_like(out["logvar"]))
        return j_ce(out["logits"], caps[:, 1:], mask) + 0.5 * kl

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    want, g = jax.value_and_grad(loss_fn)(v["params"])
    upd, _ = tx.update(g, tx.init(v["params"]), v["params"])
    new = optax.apply_updates(v["params"], upd)
    port = GlobalSentenceVAE(V, device="cpu", **GV)
    port.load_state_dict(from_flax(v), strict=True)
    eps, coins = _gv_draws(jm, v, key, caps)
    opt = OptaxChain(port.named_parameters(), "Adam", lambda s: LR,
                     max_grad_norm=1.0)
    tc, tl = _t(caps), _t(lens)
    out = port(tc, tl, train=True, eps=eps, coins=coins)
    mask = length_mask(tl - 1, tc.shape[1] - 1)
    loss = (cross_entropy(out["logits"], tc[:, 1:], mask) + 0.5 * normal_kl_loss(
        out["mu"], out["logvar"], torch.zeros_like(out["mu"]),
        torch.zeros_like(out["logvar"])))
    loss.backward()
    opt.step()
    close(loss, want)
    ref = from_flax({"params": new})
    for k, p in port.named_parameters():
        close(p, ref[k], k)


@pytest.mark.parametrize("method", ["greedy", "sample", "gumbel"])
def test_global_vae_inference_tokens_identical(gvae, method):
    """z ~ N(0,1) and the per-step sampling noise of the JAX key: identical
    tokens (finished rows frozen at <end>), logits atol 1e-5."""
    jm, v, port = gvae
    key = jax.random.key(8)
    want = jm.apply(v, 5, 9, method, 1.3, rngs={"sample": key},
                    method=jm.inference)
    k_z, k_s = jax.random.split(_sample_key(jm, v, key))
    z = _t(jax.random.normal(k_z, (5, GV["latent_size"])))
    g = _t(np.stack([np.asarray(jax.random.gumbel(k, (5, V)))
                     for k in jax.random.split(k_s, 9)]))
    got = port.inference(5, 9, method, 1.3, z=z, gumbel=g)
    np.testing.assert_array_equal(got["seqs"].numpy(), np.asarray(want["seqs"]))
    close(got["logits"], want["logits"])


# --------------------------------------------------------------------- #
# the sentence head and the train step's recipe terms
# --------------------------------------------------------------------- #
def _sentence_pair(pairs, seq):
    key = ("sentence", seq)
    if key not in pairs:
        pairs[key] = Pair("sentence", model_args={"seq_output_size": seq})
    return pairs[key]


@pytest.mark.parametrize("seq", [E, 12], ids=["no_projection", "projection"])
def test_sentence_head_matches_jax(pairs, seq):
    """``seq_outputs``: the length-mean of the decoder outputs, projected by
    ``output_transform`` only where ``seq_output_size`` differs from the
    decoder's hidden size (16)."""
    pair = _sentence_pair(pairs, seq)
    assert (pair.port.output_transform is None) == (seq == E)
    b = batch(1)
    ref = jax_train_forward(pair, b, jax.random.key(4), 1.0, 0.0)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    model = pair.port_model().train()
    out = model.train_forward(tb["feats"], tb["feat_lens"], tb["caps"],
                              tb["cap_lens"], 1.0, 0.0,
                              noise=recovered_noise(ref, 1.0, 0.0))
    assert out["seq_outputs"].shape == (N, seq)
    close(out["seq_outputs"].detach(), ref["seq_outputs"])
    close(out["logits"].detach(), ref["logits"])


@pytest.fixture(scope="module")
def dscrm_dir(tmp_path_factory, dscrm):
    """A ``train_discriminator`` experiment dir holding the JAX
    discriminator (its trainer wrapper's ``dscrm.`` names)."""
    _, v, _ = dscrm
    d = tmp_path_factory.mktemp("dscrm")
    (d / "config.json").write_text(json.dumps(
        {"discriminator_audio_dim": E, "discriminator_args": DARGS}))
    torch.save({"state_dict": {f"dscrm.{k}": t for k, t in
                               from_flax(v).items()}}, d / "best.pt")
    return d


def _adversarial(dscrm, method):
    _, v, _ = dscrm
    jdm = JDM(vocab_size=V, audio_dim=E, **DARGS)
    return {"apply": lambda b: jdm.apply({"params": v["params"]}, b),
            "alpha": 0.5, "sample_method": method}


# (case, recipe, seq_output_size, JAX make_train_step kwargs, port conf keys)
TERMS = [
    ("aug", "vae", None, {}, {"use_aug_prob": 0.5}),
    ("cosine", "sentence", 12, {"embedding_loss": "Cosine", "dec_par": 0.7},
     {"embedding_loss": "Cosine", "dec_par": 0.7}),
    ("mse", "sentence", 12, {"embedding_loss": "MSE"}, {"embedding_loss": "MSE"}),
    ("mae", "sentence", 12, {"embedding_loss": "MAE", "dec_par": 2.0},
     {"embedding_loss": "MAE", "dec_par": 2.0}),
    ("pooled_cosine", "vae", None, {"embedding_loss": "Cosine"},
     {"embedding_loss": "Cosine"}),
    ("adverse_argmax", "vae", None, "argmax", None),
    ("adverse_gumbel", "vae", None, "gumbel", None),
]


def _term_setup(pairs, dscrm, dscrm_dir, case):
    """(pair, batch, JAX step kwargs, port conf keys) of a TERMS case."""
    _, recipe, seq, jkw, over = next(t for t in TERMS if t[0] == case)
    pair = (_sentence_pair(pairs, seq) if recipe == "sentence"
            else get_pair(pairs, recipe))
    b = batch(2)
    if case == "aug":
        b["keep_mask"] = np.array([1.0, 0.0, 1.0], np.float32)
    if over and "embedding_loss" in over:
        width = seq or E
        b["cap_embeds"] = np.random.default_rng(31).normal(
            size=(N, width)).astype(np.float32)
    if case.startswith("adverse"):
        method = jkw
        jkw = {"adversarial": _adversarial(dscrm, method)}
        over = {"adverse_loss": {"discriminator": str(dscrm_dir), "alpha": 0.5,
                                 "sample_method": method}}
    return pair, b, jkw, over


def _port_noise(pair, b, rng, case):
    """The JAX step's draws: latent noise from its k_sample forward, the
    adverse Gumbel noise from k_adv."""
    k_sample, _, _, k_adv = jax.random.split(rng, 4)
    out = jax_train_forward(pair, {k: v for k, v in b.items()
                                   if k in ("feats", "feat_lens", "caps",
                                            "cap_lens")}, k_sample, 0.0, 1.0)
    noise = recovered_noise(out, 0.0, 1.0)
    if case == "adverse_gumbel":
        noise["adv_gumbel"] = _t(jax.random.gumbel(k_adv, out["logits"].shape))
    return noise


@pytest.mark.parametrize("case", [t[0] for t in TERMS])
def test_train_step_terms_match_jax(pairs, dscrm, dscrm_dir, case):
    """One train step with ``use_aug_prob`` (a keep mask), each
    ``embedding_loss`` (through the sentence head, and a VAE's pooled
    outputs) and ``adverse_loss`` (argmax, gumbel): every JAX metric rtol
    1e-4, the parameters after clip + Adam at lr 1e-4 atol 1e-5."""
    pair, b, jkw, over = _term_setup(pairs, dscrm, dscrm_dir, case)
    conf = dict(pair.port_conf, scheduler="constant", optimizer_args={"lr": LR},
                scheduler_args={}, **over)
    step = make_train_step(pair.model, smoothing=0.1, kl_mask="valid",
                           alpha=conf.get("alpha"), donate=False, **jkw)
    state = TrainState.create(pair.variables,
                              build_optimizer("Adam", LR, max_grad_norm=1.0))
    rng = jax.random.key(11)
    new_state, ref_m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            rng, 0.0, 1.0, 0.7, 0.5)
    trainer = Trainer(conf, V, FDIM, device="cpu", total_iters=100)
    trainer.model.load_state_dict(from_flax(pair.variables), strict=True)
    trainer.ratios = lambda it, ep: {"ss_ratio": 0.0, "dis_ratio": 1.0,
                                     "kl_weight": 0.7}
    metrics = trainer.step(b, iteration=1, epoch=1,
                           noise=_port_noise(pair, b, rng, case))
    term = {"aug": "ce", "adverse_argmax": "adverse",
            "adverse_gumbel": "adverse"}.get(case, "embed")
    assert term in ref_m and term in metrics
    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref = from_flax({"params": new_state.params})
    for k, p in trainer.model.named_parameters():
        close(p, ref[k], k)
    if case.startswith("adverse"):
        assert all(not p.requires_grad
                   for p in trainer.adversarial["dscrm"].parameters())


@pytest.mark.parametrize("method", ["argmax", "gumbel"])
def test_adverse_gradients_match_jax(pairs, dscrm, dscrm_dir, method):
    """The captioner's gradients through the adverse term (the
    straight-through sample into the frozen discriminator, which reads the
    raw audio_embeds) against JAX's, rtol 1e-3 / atol 1e-5, and the
    discriminator gets none.  ``tests/test_torch_train_step.py`` holds the
    flagship's grads at atol 1e-6; here the conv weights' gradients also
    take the discriminator's path back through the encoder's train-mode
    BatchNorms over 3 clips, whose mean subtraction cancels the float32
    sum-order noise into up to 8.7e-6 on entries of ~4e-3."""
    pair, b, jkw, over = _term_setup(pairs, dscrm, dscrm_dir, f"adverse_{method}")
    step = make_train_step(pair.model, smoothing=0.1, kl_mask="valid",
                           alpha=pair.conf.get("alpha"), donate=False, **jkw)
    rng = jax.random.key(12)
    new_state, _ = step(TrainState.create(pair.variables, _capture_grads()),
                        {k: jnp.asarray(v) for k, v in b.items()}, rng,
                        0.0, 1.0, 0.7, 0.5)
    trainer = Trainer(dict(pair.port_conf, **over), V, FDIM, device="cpu",
                      total_iters=100)
    model = trainer.model
    model.load_state_dict(from_flax(pair.variables), strict=True)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    loss, m = compute_loss(model, tb, 0.0, 1.0, 0.7, pair.conf.get("alpha"),
                           noise=_port_noise(pair, b, rng, f"adverse_{method}"),
                           adversarial=trainer.adversarial)
    loss.backward()
    ref = from_flax({"params": new_state.opt_state})
    ref.pop("encoder.stem_pad_lanes")
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for k, g in ref.items():
        grad = named[k].grad
        grad = torch.zeros_like(g) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert all(p.grad is None for p in trainer.adversarial["dscrm"].parameters())
    assert float(m["adverse"].detach()) > 0


def test_recipe_terms_raise_as_jax(pairs, dscrm, dscrm_dir):
    """The embedding-size mismatch and an adverse term on a model without
    audio_embeds raise JAX's ValueErrors, word for word."""
    pair = _sentence_pair(pairs, 12)
    b = batch(2)
    cases = [({**b, "cap_embeds": np.zeros((N, 5), np.float32)},
              {"embedding_loss": "MSE"}, {"embedding_loss": "MSE"}),
             (b, {"adversarial": _adversarial(dscrm, "argmax")},
              {"adverse_loss": {"discriminator": str(dscrm_dir)}})]
    for bt, jkw, over in cases:
        step = make_train_step(pair.model, smoothing=0.1, donate=False, **jkw)
        with pytest.raises(ValueError) as j:
            step(TrainState.create(pair.variables, _capture_grads()),
                 {k: jnp.asarray(v) for k, v in bt.items()}, jax.random.key(0),
                 1.0, 0.0, 0.7, 0.5)
        trainer = Trainer(dict(pair.port_conf, **over), V, FDIM, device="cpu",
                          total_iters=10)
        with pytest.raises(ValueError) as t:
            trainer.step(bt, 1, 1)
        assert str(t.value) == str(j.value)
