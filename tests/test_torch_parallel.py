"""Port parity: parallelism (``acvae_tpu_torch/parallel``) against
``acvae_tpu/parallel/mesh.py`` and the JAX package's mesh train steps.

The port's steps run in one 4-rank gloo group on the CPU, started once for
the module (``parallel/pool.py``); the JAX references on the suite's 8
virtual CPU devices (4 of them), two mesh steps compiled once for the
module: the port's DP, TP and SP steps on a batch of 16 are held to JAX's
(2 data × 2 model) sequence-parallel step on it (JAX holds that step to its
DP and TP ones, ``tests/test_parallel.py``), and the port's DP step on a
batch of 6, padded to 8 with its first rows, to JAX's 4-data step on it.
Noise protocol as in ``tests/test_torch_train_step.py``: the JAX step draws
the global batch's noise (threefry is sharding-invariant), the port's ranks
are handed the same global draws (recovered from JAX's unsharded forward;
augment draws from the JAX key recipe) and each keeps its rows.  Dropouts
are off on both sides.

Tolerances: the loss at rtol 2e-5 (JAX's own DP check), the gradients before
Adam at rtol 1e-3 / atol 2e-6 (float32 sum order over ranks; the single
step's port check is 1e-3 / 1e-6), BatchNorm running statistics at 1e-5,
the weights after one Adam step (lr 1e-4) at rtol 5e-3 / atol 5e-4, as
``tests/test_parallel.py`` holds the JAX mesh step to the unsharded one.

The encoders that sequence parallelism splits (Cnn14 and ResNet38 at their
fixed widths, the double-conv ones at channels 4-8-8-16) run their
train-mode forward and a backward on the pool's 2 data x 2 model grid,
time split over the model ranks, against the JAX encoder's forward and
``jax.vjp`` on the same weights and batch: the outputs at rtol 1e-5 /
atol 1e-4 (``tests/test_torch_encoders.py``'s train-mode tolerance),
BatchNorm's running statistics at 1e-5, the summed gradients per tensor
within ``SPLIT_GRAD_REL`` of JAX's in norm (a planted fault, the halo
exchange's backward dropped, must fall outside it).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acvae_tpu.data import dataset as jds
from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu.models import encoders as jenc
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.ops.specaug import build_augment as j_build_augment
from acvae_tpu.parallel import mesh as jmesh
from acvae_tpu.train.trainer import TrainState, build_optimizer, make_train_step
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.data import dataset as tds
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.encoders import (ENCODERS, build_encoder,
                                             seq_split_encoders)
from acvae_tpu_torch.parallel import mesh as tmesh
from acvae_tpu_torch.parallel.parity import (encoder_split_case, errors,
                                             train_step_case)
from acvae_tpu_torch.parallel.pool import RankPool
from tests.test_torch_encoders import _init as _jax_encoder_init
from tests.test_torch_train_step import _jax_forward, _recovered_noise
from tests.test_torch_warp import jax_augment_draws

V, E, TMEL, FDIM, L = 26, 16, 64, 16, 8
AUG_ARGS = {"p": 1.0, "W": 8, "T": 10, "F": 4}
AUGS = ["timewarp", "timemask", "freqmask"]
SMALL = dict(
    encoder_args={"embed_size": E, "channels": (4, 8, 8, 16)},
    decoder_args={"embed_size": E, "hidden_size": E, "dropout": 0.0},
    model_args={"posterior_model": "PosteriorRNN_hybrid",
                "posterior_args": {"hidden_size": E},
                "prior_model": "PriorRNN", "prior_args": {"hidden_size": E}},
    augment_args=AUG_ARGS, max_grad_norm=1.0, optimizer_args={"lr": 1e-4},
    scheduler="constant", scheduler_args={})
PORT_CONF = flagship_conf(**dict(SMALL, encoder_args=dict(
    SMALL["encoder_args"], conv_dropout=0.0, head_dropout=0.0)))
TOL = {"loss": 2e-5, "grad": (1e-3, 2e-6), "stats": 1e-5, "param": (5e-3, 5e-4)}


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,m", [(3, 8), (6, 4), (16, 4), (5, 5), (1, 3)])
def test_pad_to_multiple_matches_jax(n, m):
    """Repeat the first rows, tiling when the pad exceeds the batch; numpy,
    tensors and lists."""
    batch = {"feats": np.arange(n * 4).reshape(n, 4),
             "lens": np.arange(5, 5 + n, dtype=np.int32)}
    ref = jmesh.pad_to_multiple(batch, m)
    got = tmesh.pad_to_multiple(batch, m)
    tgot = tmesh.pad_to_multiple({k: torch.as_tensor(v)
                                  for k, v in batch.items()}, m)
    ids = tmesh.pad_to_multiple({"ids": [f"a{i}" for i in range(n)]}, m)["ids"]
    for k in batch:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
        np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(ref[k]))
    assert ids == [f"a{i % n}" for i in range(len(ref["lens"]))]


@pytest.mark.parametrize("shape", [(V, 16), (16, V), (V,), (16, 16), (),
                                   (3, V, 4)])
def test_vocab_pspec_matches_jax(shape):
    leaf = np.zeros(shape)
    assert tuple(jmesh.vocab_pspec(leaf, V)) == tmesh.vocab_pspec(leaf, V)


def test_mesh_guards_match_jax():
    for mp, n in ((3, 8), (0, 4)):
        for fn in (jmesh.make_mesh_2d, tmesh.make_mesh_2d):
            with pytest.raises(ValueError, match="does not divide"):
                fn(mp, n)
    for v, mp in ((34, 2), (31, 2), (30, 3), (4981, 2), (4982, 2)):
        assert (tmesh.check_vocab_divisible(v, mp)
                == jmesh.check_vocab_divisible(v, mp))
    # one process: a 1-D grid of itself
    g = tmesh.make_mesh()
    assert (g.world, g.data, g.model, g.shape()) == (1, 1, 1, {"data": 1})
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_batch({"feats": np.zeros((7, 33, 4))}, tmesh.Grid(4, 0, 4, 1))


# ---------------------------------------------------------------- loader
@pytest.mark.parametrize("hosts", [2, 3])
def test_host_sharded_loader_matches_jax(hosts):
    """Each host's stride of the padded permutation, batch for batch: rows,
    lengths and the bucket every host shares (clips of 40-700 frames)."""
    rng = np.random.default_rng(hosts)
    feats = {f"a{i}": rng.normal(size=(int(rng.integers(40, 700)), 8)
                                 ).astype(np.float32) for i in range(11)}
    info = [{"audio_id": a, "captions": [
        {"tokens": " ".join(rng.choice(["a", "b", "c"], size=int(k)))}
        for k in rng.integers(2, 6, size=int(rng.integers(1, 4)))]}
        for a in feats]
    jv, tv = JVocabulary(), Vocabulary()
    for w in ("a", "b", "c"):
        jv.add_word(w), tv.add_word(w)
    for h in range(hosts):
        kw = dict(shuffle=True, seed=5, host_id=h, host_count=hosts)
        got = tds.CaptionLoader(tds.CaptionDataset(features=feats,
                                                   caption_info=info,
                                                   vocabulary=tv), 3, **kw)
        want = jds.CaptionLoader(jds.CaptionDataset(features=feats,
                                                    caption_info=info,
                                                    vocabulary=jv), 3, **kw)
        got.set_epoch(2), want.set_epoch(2)
        pairs = list(zip(got, want))
        assert len(got) == len(want) == len(pairs) > 0
        for gb, wb in pairs:
            assert gb.audio_ids == wb.audio_ids
            for k in ("feats", "feat_lens", "caps", "cap_lens"):
                np.testing.assert_array_equal(getattr(gb, k), getattr(wb, k))


# ------------------------------------------------------------------ steps
@pytest.fixture(scope="module")
def pool():
    p = RankPool("gloo", ["cpu"] * 4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_model():
    conf = flagship_conf(**SMALL)
    model = j_build_model(conf, V, FDIM)
    b = _batch(4, 0)
    variables = jax.jit(lambda k1, k2: model.init(
        {"params": k1, "sample": k2}, b["feats"], b["feat_lens"], b["caps"],
        b["cap_lens"], train=False))(jax.random.key(0), jax.random.key(1))
    return model, variables


@pytest.fixture(scope="module", autouse=True)
def no_jax_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc._DropoutMixin, "_dropout",
                   lambda self, x, rate, train: x)
        yield


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(n, TMEL, FDIM)).astype(np.float32),
            "feat_lens": rng.integers(TMEL // 2, TMEL + 1, size=n
                                      ).astype(np.int32),
            "caps": rng.integers(3, V, size=(n, L)).astype(np.int32),
            "cap_lens": rng.integers(3, L + 1, size=n).astype(np.int32)}


def _capture(tx):
    """``tx`` that also keeps the gradient it was handed in its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(g, state, params=None):
        u, s = tx.update(g, state[1], params)
        return u, (g, s)
    return optax.GradientTransformation(init, update)


# (port grid, the batch's rows): on 16 rows every word is fed back (the
# global argmax) and every z is the prior's; on 6 (padded to 8) all teacher
CASES = {"dp16": ("dp", 16), "tp": ("tp", 16), "sp": ("sp", 16),
         "dp6": ("dp", 6), "sp_warm": ("sp", 16)}
# cases whose step follows warm-up steps from the same state, restored
# from a snapshot on the CPU
WARMUP = {"sp_warm": 2}
RATIOS = {16: (0.0, 1.0), 6: (1.0, 0.0)}
KEY = 7


def _jax_mesh_step(model, variables, b, kind, ss, dis, key):
    step = make_train_step(model, smoothing=0.1, kl_mask="valid", alpha=0.5,
                           augment=j_build_augment(AUGS, crop_size=992,
                                                   **AUG_ARGS), donate=False)
    state = TrainState.create(variables, _capture(build_optimizer(
        "Adam", 1e-4, max_grad_norm=1.0)))
    if kind == "dp":
        mesh = jmesh.make_mesh(4)
        state = jmesh.replicate(state, mesh)
        arrays = jmesh.shard_batch(b, mesh)
    else:
        mesh = jmesh.make_mesh_2d(2, 4)
        state = jmesh.shard_by_vocab(state, mesh, V)
        arrays = jmesh.shard_batch(b, mesh, seq_axis="model"
                                   if kind == "sp" else None)
    new_state, metrics = step(state, arrays, key, ss, dis, 0.5, 0.5)
    return jax.device_get(new_state), jax.device_get(metrics)


def _global_draws(model, variables, b, ss, dis, key):
    """The JAX step's draws for the global batch ``b``, as port inputs."""
    k_sample, _k_dropout, k_aug, _k_adv = jax.random.split(key, 4)
    feats, lens = jax.jit(j_build_augment(AUGS, crop_size=992, **AUG_ARGS))(
        jnp.asarray(b["feats"]), jnp.asarray(b["feat_lens"]), k_aug)
    out = _jax_forward(model, variables, dict(b, feats=feats, feat_lens=lens),
                       k_sample, ss, dis)
    draws = jax_augment_draws(k_aug, b["feats"].shape,
                              jnp.asarray(b["feat_lens"]), **AUG_ARGS)
    return draws, _recovered_noise(out, ss, dis)


@pytest.fixture(scope="module")
def jax_refs(pool, jax_model):
    """Per batch: the global batch, JAX's mesh step on it and its draws
    (compiled while the pool's workers start)."""
    model, variables = jax_model

    def ref(n, kind):
        b = tmesh.pad_to_multiple(_batch(n, n), 4)
        ss, dis = RATIOS[n]
        key = jax.random.key(KEY)
        return (b, _jax_mesh_step(model, variables, b, kind, ss, dis, key),
                _global_draws(model, variables, b, ss, dis, key))
    # the two batches' programs compile at once
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futures = {n: ex.submit(ref, n, kind)
                   for n, kind in ((16, "sp"), (6, "dp"))}
        return {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_step_matches_jax_mesh_step(pool, jax_model, jax_refs, case):
    """One step of 4 ranks against JAX's 4-device mesh step: DP on 4 data
    ranks (a batch of 16; one of 6 padded to 8 with its first rows), vocab
    TP and TP + sequence parallelism on 2 data x 2 model; the last again
    after two warm-up steps, the state restored between."""
    kind, n = CASES[case]
    ss, dis = RATIOS[n]
    b, (new_state, ref), (draws, noise) = jax_refs[n]
    full = from_flax(jax.tree_util.tree_map(np.asarray, jax_model[1]))
    ranks = pool.run(train_step_case, PORT_CONF, V, FDIM, full, b,
                     model_parallel=1 if kind == "dp" else 2, seq=kind == "sp",
                     draws=draws, noise=noise, warmup=WARMUP.get(case, 0),
                     ratios={"ss_ratio": ss, "dis_ratio": dis, "kl_weight": 0.5})
    r0 = ranks[0]
    assert r0["vocab_rows"] == (V if kind == "dp" else V // 2)
    assert r0["seq_split"] == (kind == "sp")
    # the ranks agree; the vocab shards gathered are the unsplit tensors
    assert all(r["metrics"] == r0["metrics"] for r in ranks)
    for k, v in full.items():
        assert torch.equal(r0["placed"][k], v), k
    for k in ("loss", "ce", "kl", "global", "ntokens", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], float(ref[k]),
                                   rtol=TOL["loss"], err_msg=k)
    grads = from_flax({"params": new_state.opt_state[0]})
    assert not grads.pop("encoder.stem_pad_lanes").any()
    assert set(r0["grads"]) <= set(grads)
    for k, g in grads.items():
        got = r0["grads"].get(k, torch.zeros_like(g))   # off the loss path
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=TOL["grad"][0],
                                   atol=TOL["grad"][1], err_msg=k)
    after = from_flax({"params": new_state.params,
                       "batch_stats": new_state.batch_stats})
    after.pop("encoder.stem_pad_lanes")
    for k, w in after.items():
        tol = ((TOL["stats"], TOL["stats"]) if "running" in k else TOL["param"])
        np.testing.assert_allclose(r0["weights"][k].numpy(), w.numpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=k)


# ------------------------------------------------------ split encoders
SUB_ENC = {"embed_size": 16, "channels": (4, 8, 8, 16)}
# (encoder, args, T): T = 64 splits every one over 2 model ranks; Cnn14's
# T = 32·2 + 16 does not (its 5 pools need 32 frames a shard), so each
# rank runs whole clips
SPLIT_CASES = {"Cnn14": ("Cnn14", {}, 64), "ResNet38": ("ResNet38", {}, 64),
               "CNN10QEncoder": ("CNN10QEncoder", SUB_ENC, 64),
               "CNN10DEncoder": ("CNN10DEncoder", SUB_ENC, 64),
               "CRNN8_Sub4": ("CRNN8_Sub4", SUB_ENC, 64),
               "Cnn14_whole_clips": ("Cnn14", {}, 80)}
ENC_F = 64
# the largest ||split - JAX|| / ||JAX|| of a gradient tensor: float32 sum
# order reads up to 2.7e-5 (the unsplit port reads 1.1e-5 on Cnn14, whose
# deep BatchNorms over 2x2 maps put single elements 150x outside the
# step's elementwise 1e-3 / 2e-6)
SPLIT_GRAD_REL = 1e-3


# the encoders sequence parallelism splits, each with its time stride (a
# composite's the lcm of its branches', built with COMPOSITE_ARGS)
SPLIT_STRIDES = {"CNN10CRNNEncoder": 16, "CNN10DEncoder": 16,
                 "CNN10Encoder": 4, "CNN10QEncoder": 16, "CNNEncoder": 1,
                 "CRNN8_Sub4": 4, "CRNNEncoder": 4, "Cnn10": 16, "Cnn14": 32,
                 "E2EASREncoder": 4, "M2TransformerEncoder": 1,
                 "PreTrainedCNN": 16, "ResNet38": 32, "ResNetEncoder": 32,
                 "TransformerEncoder": 1}
COMPOSITE_ARGS = {"PreTrainedCNN": {"trunk": {"name": "Cnn10"}},
                  "CNN10CRNNEncoder": {"crnn": {"name": "CRNNEncoder"},
                                       "cnn": {"name": "CNN10QEncoder"}}}


def test_split_encoders_are_the_listed_ones():
    """Every registered encoder but RNNEncoder splits; the time strides
    are the trunks' subsampling (the lcm of a composite's branches'), and a
    composite with a branch that does not split runs whole clips."""
    assert seq_split_encoders() == sorted(SPLIT_STRIDES)
    assert set(ENCODERS) - set(SPLIT_STRIDES) == {"RNNEncoder"}
    for name, stride in SPLIT_STRIDES.items():
        enc = build_encoder(name, COMPOSITE_ARGS.get(name, {}), 64,
                            device="meta")
        assert enc.time_stride == stride, name
        for m in (1, 2, 4, 8):
            assert enc.seq_split_ok(256 * 4, m), name
        assert not enc.seq_split_ok(stride * 2 + max(stride // 2, 1), 2), name
        assert enc.seq_split_params(), name
    rnn_trunk = build_encoder("PreTrainedCNN", {"trunk": {"name": "RNNEncoder"}},
                              64, device="meta")
    assert not rnn_trunk.seq_split_ok(256 * 4, 2)
    assert rnn_trunk.seq_split_params() == []


@pytest.mark.parametrize("k,s,p,T", [(3, 1, 0, 8), (4, 1, 1, 8), (4, 1, 2, 8),
                                     (1, 1, 1, 8), (3, 2, 2, 8), (3, 2, 1, 7)])
def test_split_conv_raises_where_the_halo_does_not_cover(k, s, p, T):
    """Inside a split region a conv whose shards' outputs would not tile
    the whole clip's (a VALID or even kernel, padding past SAME, a shard
    that does not divide by the stride) raises instead of padding each
    shard's edges with zeros."""
    from types import SimpleNamespace

    from acvae_tpu_torch.models.encoders import _conv2d
    from acvae_tpu_torch.parallel import state as pstate
    conv = torch.nn.Conv2d(2, 2, k, bias=False)
    x = torch.zeros(1, 2, T, 8)
    _conv2d(x, conv, torch.float32, s, p)   # unsplit: any geometry
    with pstate.step_context(SimpleNamespace(model=2), seq_split=True), \
            pstate.split_region(), pytest.raises(ValueError, match="cannot run"):
        _conv2d(x, conv, torch.float32, s, p)


@pytest.fixture(scope="module")
def split_encoders(tmp_path_factory):
    """Per encoder: the JAX module and variables (initialised once), the
    port's weights written to a file for the ranks."""
    out, cache = tmp_path_factory.mktemp("split_enc"), {}

    def get(name, args):
        if name not in cache:
            enc, v = _jax_encoder_init(name, args)
            path = str(out / f"{name}.pt")
            torch.save(from_flax(v), path)
            cache[name] = enc, v, path
        return cache[name]
    return get


def check_split_matches_jax(pool, split_encoders, name, args, T, split,
                            faults=(), rows=2, zero_grads=()):
    """Encoder ``name``'s train-mode forward on ``rows`` clips on the pool's
    2 data x 2 model ranks (its time split over the model ranks when
    ``split``, else whole clips) and the backward of a fixed scalar of its
    outputs, against JAX's forward and vjp: outputs, lengths, running
    statistics, summed gradients; each planted fault of ``faults``
    (``parity.FAULTS``) fails the gradient check.  The gradients named in
    ``zero_grads`` are zero in exact arithmetic (a bias a train-mode
    BatchNorm subtracts again), so both sides' are rounding: they are held
    below 1e-6 of the largest gradient's norm instead."""
    enc, v, path = split_encoders(name, args)
    rng = np.random.default_rng(T)
    feats = rng.normal(size=(rows, T, ENC_F)).astype(np.float32)
    # the second ends in shard 2
    lens = np.array([T, T // 2 + 9, T - 5, T // 4 + 3][:rows], np.int32)

    def forward(params):
        return enc.apply({"params": params,
                          "batch_stats": v.get("batch_stats", {})},
                         jnp.asarray(feats), jnp.asarray(lens), train=True,
                         mutable=["batch_stats"])

    def loss(params, probe):
        out, upd = forward(params)
        value = (jnp.sum(out["audio_embeds"] * probe["embeds"])
                 + jnp.sum(out["audio_embeds_pooled"] * probe["pooled"]))
        return value, (out, upd)
    shapes = jax.eval_shape(forward, v["params"])[0]
    probe = {k: rng.normal(size=shapes[key].shape).astype(np.float32)
             for k, key in (("embeds", "audio_embeds"),
                            ("pooled", "audio_embeds_pooled"))}
    (_, (ref, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], probe)
    ranks = pool.run(encoder_split_case, name, args, ENC_F, path, feats, lens,
                     probe, model_parallel=2)
    r0 = ranks[0]
    assert all(r["seq_split"] == split for r in ranks)
    for k in ("audio_embeds", "audio_embeds_pooled"):
        np.testing.assert_allclose(r0["outputs"][k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(r0["outputs"]["audio_embeds_lens"].numpy(),
                                  np.asarray(ref["audio_embeds_lens"]))
    want = from_flax({"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        np.asarray, upd.get("batch_stats", {}))})
    for k, val in want.items():
        if "running" in k:
            np.testing.assert_allclose(r0["state"][k].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    g_want = from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    assert not g_want.pop("stem_pad_lanes", torch.zeros(1)).any()
    g_want = {k: g for k, g in g_want.items() if k in r0["grads"] or g.any()}
    assert set(r0["grads"]) == set(g_want)
    scale = max(float(g.norm()) for g in g_want.values())
    for k in zero_grads:
        assert max(float(g_want.pop(k).norm()),
                   float(r0["grads"][k].norm())) <= 1e-6 * scale, k
    err = errors(r0["grads"], g_want, TOL["grad"][0], TOL["grad"][1])
    assert err["rel"] <= SPLIT_GRAD_REL, err
    for fault in faults:   # a planted fault fails the check
        bad = pool.run(encoder_split_case, name, args, ENC_F, path, feats,
                       lens, probe, model_parallel=2, fault=fault)[0]
        err = errors(bad["grads"], g_want, TOL["grad"][0], TOL["grad"][1])
        assert err["rel"] > SPLIT_GRAD_REL, (fault, err)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_encoder_matches_jax(pool, split_encoders, case):
    """The train-mode forward on 2 data x 2 model ranks, the time split
    over the model ranks (whole clips where T does not split), and the
    backward of a fixed scalar of its outputs, against JAX's forward and
    vjp: outputs, lengths, running statistics, summed gradients; for
    CNN10QEncoder the halo's backward dropped fails the gradient check."""
    name, args, T = SPLIT_CASES[case]
    check_split_matches_jax(
        pool, split_encoders, name, args, T,
        split=case != "Cnn14_whole_clips",
        faults=("halo_dropped",) if case == "CNN10QEncoder" else ())
