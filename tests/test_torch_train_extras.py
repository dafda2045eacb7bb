"""Port parity: the rest of ``cli train`` (the KL variants and schedules,
optax's optimizers with weight decay, freezing and the clip, gradient
accumulation, ReduceLROnPlateau, warm starts, mid-epoch snapshots and
resume), ``average_checkpoints`` and ``diagnose`` of ``acvae_tpu_torch``
against ``acvae_tpu``, on the CPU at small widths.

Tolerances: schedules, the plateau, the frozen set, the merges and the
averages exactly; the loss and its metrics rtol 1e-4 and the gradients
within 1e-3 of each tensor's largest; parameters after
optimizer steps atol 1e-6 at lr 1e-3; the diagnostics atol 3e-4 on JAX's
4-5 rounded decimals.  A fault and a resume are bit-identical to an
uninterrupted run.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import acvae_tpu.models.encoders as jenc
from acvae_tpu.cli.main import Runner
from acvae_tpu.core.config import load_config as j_load_config
from acvae_tpu.data import embeddings as jemb
from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.train import checkpoints as jckpt
from acvae_tpu.train import diagnose as jdiag
from acvae_tpu.train import pretrained as jpre
from acvae_tpu.train import trainer as jtr
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import experiment_from_flax, from_flax
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.models.vae import VAECaptionModel
from acvae_tpu_torch.train import checkpoints as tckpt
from acvae_tpu_torch.train import pretrained as tpre
from acvae_tpu_torch.train.optim import OptaxChain, ReduceLROnPlateau
from acvae_tpu_torch.train.schedules import kl_weight_for, parse_kl_anneal
from acvae_tpu_torch.train.trainer import Trainer
from tests.test_torch_cli import _exp, _metrics, ws  # noqa: F401
from tests.test_torch_decode import SMALL as DEC_SMALL
from tests.test_torch_families_rnn import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import (FDIM, SMALL, V, _batch,  # noqa: F401
                                         _capture_grads, _port_conf,
                                         _recovered_noise, jax_model,
                                         no_jax_dropout)


# --------------------------------------------------------------------- #
# KL schedules
# --------------------------------------------------------------------- #
ANNEALS = [{}, {"mode": "linear"}, {"mode": "linear", "floor": 0.1},
           {"mode": "cyclical"},
           {"mode": "cyclical", "cycles": 3, "ramp": 0.25, "floor": 0.05},
           {"mode": "constant"}]


@pytest.mark.parametrize("anneal", ANNEALS,
                         ids=["reference", "linear", "linear_floor", "cyclical",
                              "cyclical_3", "constant"])
def test_kl_weight_schedule_matches_jax(anneal):
    """Every epoch of 25 (and of 7) for two betas, exactly."""
    parsed = parse_kl_anneal(anneal)
    for epochs in (25, 7):
        for beta in (0.5, 1.5):
            for epoch in range(1, epochs + 1):
                ref = jtr.kl_weight_schedule(
                    epoch, epochs, beta, mode=anneal.get("mode", "reference"),
                    cycles=int(anneal.get("cycles", 4)),
                    ramp=float(anneal.get("ramp", 0.5)),
                    floor=float(anneal.get("floor", 0.0)))
                assert kl_weight_for(parsed, epoch, epochs, beta) == ref


@pytest.mark.parametrize("raw", ["linear", {"mode": "linear", "warmup": 3},
                                 {"mode": "cosine"}],
                         ids=["scalar", "unknown_key", "unknown_mode"])
def test_kl_anneal_errors_match_jax(raw):
    def run(parse, schedule):
        a = parse(raw)
        return schedule(1, 10, 0.5, mode=a.get("mode", "reference"))
    from acvae_tpu_torch.train.schedules import kl_weight_schedule
    with pytest.raises(ValueError) as ref:
        run(jtr.parse_kl_anneal, jtr.kl_weight_schedule)
    with pytest.raises(ValueError) as ours:
        run(parse_kl_anneal, kl_weight_schedule)
    assert str(ours.value) == str(ref.value)


# --------------------------------------------------------------------- #
# global_loss: kl and free_bits
# --------------------------------------------------------------------- #
def test_global_kl_and_free_bits_match_jax(jax_model, no_jax_dropout):  # noqa: F811
    """One step with ``global_loss: kl`` and ``free_bits`` 0.3 (some
    dimensions floored, some not): the loss and every metric, ``kl_raw``
    included, rtol 1e-4; each gradient within 1e-3 of its tensor's largest
    magnitude (the conv backward sums in another order)."""
    conf, model, variables = jax_model
    b = _batch(3)
    step = jtr.make_train_step(model, smoothing=0.1, kl_mask="valid", alpha=0.5,
                               global_loss="kl", free_bits=0.3, donate=False)
    rng = jax.random.key(13)
    state = jtr.TrainState.create(variables, _capture_grads())
    new_state, ref_m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            rng, 1.0, 0.0, 0.5, 0.5)
    k_sample = jax.random.split(rng, 4)[0]
    out, _ = jax.jit(lambda v, k: model.apply(
        v, b["feats"], b["feat_lens"], b["caps"], b["cap_lens"], ss_ratio=1.0,
        dis_ratio=0.0, train=True, rngs={"sample": k},
        mutable=["batch_stats"]))(variables, k_sample)
    out = jax.tree_util.tree_map(np.asarray, out)
    trainer = Trainer(_port_conf(dict(SMALL, augments=None, global_loss="kl",
                                      free_bits=0.3)),
                      V, FDIM, device="cpu", total_iters=100)
    trainer.model.load_state_dict(from_flax(variables), strict=True)
    metrics = trainer.step(b, iteration=1, epoch=1,
                           noise=_recovered_noise(out, 1.0, 0.0))
    assert {"kl", "kl_raw", "global"} <= set(ref_m)
    assert float(ref_m["kl"]) != float(ref_m["kl_raw"])
    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref_grads = from_flax({"params": new_state.opt_state})
    ref_grads.pop("encoder.stem_pad_lanes")
    named = dict(trainer.model.named_parameters())
    for k, g in ref_grads.items():
        grad = named[k].grad
        grad = torch.zeros_like(g) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(g.abs().max()), err_msg=k)


# --------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------- #
SHAPES = {"encoder/conv/kernel": (3, 4), "decoder/word_embeddings/embedding": (6, 3),
          "decoder/out/bias": (5,), "pnet/word_embedding/embedding": (6, 3),
          "qnet/cell/wh": (2, 2, 3)}
OPTIMIZERS = [("Adam", {}), ("AdamW", {}), ("SGD", {}),
              ("SGD", {"momentum": 0.9}), ("SGD", {"momentum": 0.9, "nesterov": True}),
              ("RMSprop", {}), ("RMSprop", {"momentum": 0.5, "eps_in_sqrt": False}),
              ("Adagrad", {}), ("Adam", {"b1": 0.8, "nesterov": True})]


def _tree(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(leaf)
    return tree


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _run_both(name, kwargs, frozen=("word_embedding",), accum=1, steps=3,
              max_grad_norm=1.0, scales=(3.0, 0.05, 1.7, 0.2), lr=1e-3,
              resume_at=None):
    """``steps`` updates of the optax chain and of the port's on the same
    gradients; yields (step, JAX params, port params)."""
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    j_params = _tree(params)
    mask = jemb.freeze_mask(j_params, frozen) if frozen else None
    tx = jtr.build_optimizer(name, lambda c: lr * (1 + 0.1 * c),
                             max_grad_norm=max_grad_norm, trainable_mask=mask,
                             accum_steps=accum, **kwargs)
    j_state = tx.init(j_params)
    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}

    def chain():
        return OptaxChain(list(t_params.items()), name,
                          lambda c: lr * (1 + 0.1 * c),
                          max_grad_norm=max_grad_norm, frozen=frozen,
                          accum_steps=accum, **dict(kwargs))
    opt = chain()
    yield -1, _flat(j_params), {k: p.detach().numpy().copy()
                                for k, p in t_params.items()}
    for step in range(steps):
        grads = {k: (rng.normal(size=s) * scales[step % len(scales)]).astype(
            np.float32) for k, s in SHAPES.items()}
        upd, j_state = tx.update(_tree(grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for k, p in t_params.items():
            p.grad = torch.tensor(grads[k])
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            _tree(grads))), rtol=1e-6)
        if resume_at == step:
            saved = pickle.loads(pickle.dumps(opt.state_dict()))
            opt = chain()
            opt.load_state_dict(saved)
        yield step, _flat(j_params), {k: p.detach().numpy()
                                      for k, p in t_params.items()}


@pytest.mark.parametrize("weight_decay", [None, 0.01], ids=["no_wd", "wd"])
@pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                         ids=[f"{n}{''.join(f'_{k}' for k in kw)}"
                              for n, kw in OPTIMIZERS])
def test_optimizer_matches_optax(name, kwargs, weight_decay):
    """Three steps of the chain (clip at 1.0 with gradient norms above and
    below it, coupled L2 or AdamW's decay, the base, the word embeddings
    frozen) against ``build_optimizer``: parameters atol 1e-6; the frozen
    ones never move."""
    kw = dict(kwargs) if weight_decay is None else dict(kwargs,
                                                        weight_decay=weight_decay)
    first = None
    for step, ref, ours in _run_both(name, kw):
        first = first or {k: v.copy() for k, v in ours.items()}
        assert step >= 0 or all(np.array_equal(ours[k], ref[k]) for k in SHAPES)
        for k in SHAPES:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=f"{k} step {step}")
    for k in SHAPES:
        if "word_embedding" in k:
            assert np.array_equal(ours[k], first[k])


def test_optimizer_arguments_refused_as_optax():
    """A key the optax function does not take raises its TypeError; an
    unknown name raises KeyError on both sides."""
    p = [("w", torch.zeros(2, requires_grad=True))]
    with pytest.raises(TypeError, match="unexpected keyword argument 'foo'"):
        jtr.build_optimizer("Adam", 1e-3, foo=1)
    with pytest.raises(TypeError, match="adam\\(\\) got an unexpected keyword "
                                        "argument 'foo'"):
        OptaxChain(p, "Adam", foo=1)
    with pytest.raises(TypeError, match="momentum"):
        OptaxChain(p, "Adagrad", momentum=0.9)
    with pytest.raises(KeyError):
        jtr.build_optimizer("Lion", 1e-3)
    with pytest.raises(KeyError):
        OptaxChain(p, "Lion")


def test_frozen_set_matches_freeze_mask(jax_model):  # noqa: F811
    """The port freezes exactly the tensors JAX's ``freeze_mask`` marks
    for freeze_word_embedding and freeze_encoder."""
    _, _, variables = jax_model
    params = variables["params"]
    mask = jemb.freeze_mask(params, ("word_embedding", "encoder"))
    # 1 where frozen, converted to the port's names
    flags = from_flax({"params": jax.tree_util.tree_map(
        lambda p, t: np.full(np.shape(p), 0.0 if t else 1.0, np.float32),
        params, mask)})
    flags.pop("encoder.stem_pad_lanes")
    want = {k for k, v in flags.items() if bool(v.all())}
    assert not any(v.any() for k, v in flags.items() if k not in want)
    conf = _port_conf(dict(SMALL, freeze_word_embedding=True,
                           model_args=dict(SMALL["model_args"],
                                           freeze_encoder=True)))
    trainer = Trainer(conf, V, FDIM, device="cpu", total_iters=10)
    trainable = {id(p) for p in trainer.optimizer.trainable}
    assert {n for n, p in trainer.model.named_parameters()
            if id(p) not in trainable} == want
    assert {n.split(".")[0] for n in want} == {"encoder", "decoder", "qnet", "pnet"}


@pytest.mark.parametrize("name,kwargs", [("Adam", {}), ("SGD", {"momentum": 0.9})],
                         ids=["Adam", "SGD_momentum"])
def test_accum_steps_matches_multisteps(name, kwargs):
    """``accum_steps: 2`` over 4 micro-batches against ``optax.MultiSteps``
    (parameters still after micro-batches 1 and 3), the chain's state saved
    and loaded mid-accumulation: atol 1e-6."""
    before = None
    for step, ref, ours in _run_both(name, kwargs, accum=2, steps=4,
                                     resume_at=0):
        for k in SHAPES:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=f"{k} micro-batch {step}")
        if before is not None:
            moved = any(not np.array_equal(ours[k], before[k]) for k in SHAPES)
            assert moved == (step % 2 == 1), step
        before = {k: v.copy() for k, v in ours.items()}


@pytest.mark.parametrize("kw", [{}, {"mode": "min", "patience": 1, "factor": 0.5},
                                {"patience": 0, "threshold": 0.1}],
                         ids=["max", "min", "threshold"])
def test_reduce_lr_on_plateau_matches_jax(kw):
    """best / num_bad / scale after every score of a sequence, exactly;
    the JAX one's scale lands in its optimizer state."""
    scores = [0.1, 0.2, 0.2, 0.19, 0.18, 0.25, 0.25, 0.3, -0.1, -0.2, -0.3,
              0.31, 0.3, 0.3]
    kw = dict(kw, patience=kw.get("patience", 2))
    ref, ours = jtr.ReduceLROnPlateau(**kw), ReduceLROnPlateau(**kw)
    state = jtr.TrainState.create({"params": {"w": jnp.zeros(2)}},
                                  jtr.build_optimizer("Adam", 1e-3))
    for s in scores:
        state = ref.step(state, s)
        assert ours.step(s) == ours.scale
        assert (ours.best, ours.num_bad, ours.scale) == (ref.best, ref.num_bad,
                                                         ref.scale)
    assert ours.scale < 1.0
    leaves = jax.tree_util.tree_leaves(state.opt_state)
    assert any(np.asarray(x).dtype == np.float32 and np.asarray(x).shape == ()
               and float(x) == np.float32(ref.scale) for x in leaves)
    fresh = ReduceLROnPlateau(**kw)
    fresh.load(json.loads(json.dumps(ours.state())))
    assert fresh.state() == ours.state()


# --------------------------------------------------------------------- #
# warm starts
# --------------------------------------------------------------------- #
def _variables(conf, vocab, seed):
    model = j_build_model(conf, vocab, FDIM)
    b = _batch()
    caps = np.minimum(b["caps"], vocab - 1)
    return jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: model.init(
        {"params": k, "sample": k}, b["feats"], b["feat_lens"], caps,
        b["cap_lens"], train=False))(jax.random.key(seed)))


@pytest.fixture(scope="module")
def warm(jax_model):  # noqa: F811
    """The target (the tiny flagship) and a source of other weights whose
    vocabulary is 2 words larger, on both sides."""
    conf, _, target = jax_model
    target = jax.tree_util.tree_map(np.asarray, target)
    source = _variables(conf, V + 2, seed=9)
    return target, source, from_flax(target), from_flax(source)


def _quiet(*a):
    pass


@pytest.mark.parametrize("subtree", [None, "encoder", "decoder"])
def test_merge_pretrained_matches_jax(warm, subtree):
    """The merged weights equal JAX's merge, converted: the vocabulary-sized
    tensors are skipped (logged with their shapes), the rest load."""
    target, source, t_target, t_source = warm
    log = []
    for col in ("params", "batch_stats"):
        if subtree is None:
            ref, n_ref, tot_ref = jpre.merge_pretrained(target[col], source[col],
                                                        _quiet)
        elif subtree in target[col]:
            ref, n_ref, tot_ref = jpre.load_subtree(target[col],
                                                    source[col][subtree],
                                                    subtree, _quiet)
        else:
            continue
        want = from_flax({col: ref})
        if subtree is None:
            ours, n, tot = tpre.merge_pretrained(t_target, t_source, log.append)
        else:
            pre = subtree + "."
            ours, n, tot = tpre.load_subtree(
                t_target, {k[len(pre):]: v for k, v in t_source.items()
                           if k.startswith(pre)}, subtree, log.append)
        for k, v in want.items():
            assert torch.equal(ours[k], v), (col, k)
    if subtree != "encoder":
        name = "word_embeddings.weight" if subtree else "decoder.word_embeddings.weight"
        assert any(m.startswith(f"skip {name}: shape ({V + 2}, 16) != ({V}, 16)")
                   for m in log), log
    if subtree is None:
        assert n < tot


def test_pretrained_sources(warm, tmp_path):
    """The port's own ``.pt`` and a reference ``{"model": module.*}`` dict
    merge through the config keys (one ``loaded`` line per collection);
    PANN and espnet encoder dicts merge into the encoder as JAX converts
    them (``pann_to_flax``/``espnet_to_flax`` then ``from_flax``), the
    stem's padded lanes zero; a directory or a pickled tree raise naming
    the JAX-side route; a missing file FileNotFoundError."""
    _, _, _, t_source = warm
    src = {k: v for k, v in t_source.items()
           if not k.startswith(("decoder.word_embeddings", "decoder.classifier"))}
    torch.save({"state_dict": src}, tmp_path / "own.pt")
    torch.save({"model": {"module." + k: v for k, v in src.items()},
                "vocabulary": "v"}, tmp_path / "ref.pth")
    for key, path in (("pretrained", "own.pt"), ("pretrained_global", "ref.pth")):
        model = build_model(_port_conf(SMALL), V, FDIM, device="cpu")
        log = []
        tpre.apply_pretrained({key: str(tmp_path / path)}, model, log.append)
        sd = model.state_dict()
        for k, v in src.items():
            if k in sd and sd[k].shape == v.shape:
                assert torch.equal(sd[k], v), k
        assert any(line.startswith(f"{key}[params]: loaded ") for line in log)
        assert any(line.startswith(f"{key}[batch_stats]: loaded ") for line in log)
    # a PANN-layout Cnn10 (the encoder's own names, a live stem lane and
    # PANN's frontend and tagger head, which are skipped)
    model = build_model(_port_conf(SMALL), V, FDIM, device="cpu")
    enc = {k[len("encoder."):]: v for k, v in src.items() if k.startswith("encoder.")}
    enc["stem_pad_lanes"] = torch.ones_like(enc["stem_pad_lanes"])
    enc["fc_audioset.weight"] = torch.zeros(3, 16)
    enc["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(2, 1, 4)
    torch.save(enc, tmp_path / "enc.pt")
    want = from_flax(jpre.pann_to_flax({k: v.numpy() for k, v in enc.items()}))
    assert not want["stem_pad_lanes"].any()
    log = []
    tpre.apply_pretrained({"pretrained_encoder": str(tmp_path / "enc.pt")},
                          model, log.append)
    sd = model.state_dict()
    n_enc = {c: sum(k.startswith("encoder.") and (k in dict(model.named_parameters()))
                    == (c == "params") for k in sd) for c in ("params", "batch_stats")}
    for col, n in n_enc.items():
        assert f"pretrained_encoder[{col}]: loaded {n}/{n} tensors" in " ".join(log)
    assert sorted(want) == sorted(k[len("encoder."):] for k in sd
                                  if k.startswith("encoder."))
    for k, v in want.items():
        assert torch.equal(sd["encoder." + k], v), k
    # an espnet VGG2L + BiGRU (GRU and LSTM layers) into an E2EASREncoder
    conf = flagship_conf(**dict(SMALL, encodermodel="E2EASREncoder", encoder_args={
        "embed_size": 16, "hidden_size": 8, "nlayers": 2}))
    model = build_model(conf, V, FDIM, device="cpu")
    rng = np.random.default_rng(4)
    esp = {f"enc.enc.0.conv{s_}_{j}.{leaf}": rng.normal(size=shape).astype(np.float32)
           for s_, (ci, co) in ((1, (1, 64)), (2, (64, 128))) for j in (1, 2)
           for leaf, shape in (("weight", (co, ci if j == 1 else co, 3, 3)),
                               ("bias", (co,)))}
    for i, (d_in, gates) in enumerate(((128 * FDIM // 4, 3), (16, 4))):
        for rev in ("", "_reverse"):
            for leaf, shape in (("weight_ih", (gates * 8, d_in)),
                                ("weight_hh", (gates * 8, 8)),
                                ("bias_ih", (gates * 8,)), ("bias_hh", (gates * 8,))):
                esp[f"enc.enc.1.birnn{i}.{leaf}_l0{rev}"] = rng.normal(
                    size=shape).astype(np.float32)
        esp[f"enc.enc.1.bt{i}.weight"] = rng.normal(size=(16, 16)).astype(np.float32)
        esp[f"enc.enc.1.bt{i}.bias"] = rng.normal(size=(16,)).astype(np.float32)
    torch.save({k: torch.tensor(v) for k, v in esp.items()}, tmp_path / "espnet.pth")
    jlog = []
    want = from_flax(jpre.espnet_to_flax(esp, FDIM, jlog.append))
    before = model.state_dict()
    log = []
    tpre.apply_pretrained({"pretrained_encoder": str(tmp_path / "espnet.pth"),
                           "espnet_inputdim": FDIM}, model, log.append)
    sd = model.state_dict()
    assert len(want) == 18 and any("not a GRU" in m for m in jlog)
    assert any("skip 1.birnn1: 4-gate RNN is not a GRU" in m for m in log)
    assert any(m.startswith("pretrained_encoder[params]: loaded 18/") for m in log)
    for k, v in sd.items():
        name = k[len("encoder."):]
        assert torch.equal(v, want[name] if name in want else before[k]), k
    with pytest.raises(ValueError, match="not divisible by 4"):
        tpre.apply_pretrained({"pretrained_encoder": str(tmp_path / "espnet.pth"),
                               "espnet_inputdim": 18}, model, _quiet)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for bad in (tmp_path, tmp_path / "tree.pkl"):
        with pytest.raises(ValueError, match="experiment_from_flax"):
            tpre.apply_pretrained({"pretrained": str(bad)}, model, _quiet)
    with pytest.raises(FileNotFoundError):
        tpre.apply_pretrained({"pretrained_decoder": str(tmp_path / "x.pth")},
                              model, _quiet)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_word_embeddings_match_jax(jax_model, tmp_path, ws):  # noqa: F811
    """``pretrained_word_embedding``: a ``.npy`` installed at init as JAX's
    ``set_embedding_param`` installs it; a GloVe file read into the same
    matrix as JAX's; a wrong shape raises."""
    _, _, variables = jax_model
    m = np.random.default_rng(2).normal(size=(V, 16)).astype(np.float32)
    np.save(tmp_path / "e.npy", m)
    ref = jemb.set_embedding_param(
        dict(variables["params"]), "decoder",
        jemb.load_word_embeddings(str(tmp_path / "e.npy")))
    trainer = Trainer(_port_conf(dict(SMALL, pretrained_word_embedding=str(
        tmp_path / "e.npy"))), V, FDIM, device="cpu", total_iters=10)
    want = from_flax({"params": ref})["decoder.word_embeddings.weight"]
    assert torch.equal(trainer.model.decoder.word_embeddings.weight.detach(), want)
    vocab, jvocab = (cls.load(str(ws / "vocab.pkl")) for cls in (Vocabulary,
                                                                  JVocabulary))
    words = list(vocab.word2idx)[:7]
    (tmp_path / "g.txt").write_text("".join(
        f"{w} {' '.join(str(i + j / 8) for j in range(4))}\n"
        for i, w in enumerate(words)) + "short 1\n")
    ours = tpre.load_word_embeddings(str(tmp_path / "g.txt"), vocab)
    assert np.array_equal(ours, jemb.load_word_embeddings(str(tmp_path / "g.txt"),
                                                          jvocab))
    with pytest.raises(ValueError, match="embedding shape"):
        tpre.set_embedding_param(trainer.model, ours)


# --------------------------------------------------------------------- #
# profiling
# --------------------------------------------------------------------- #
def test_step_timer_and_trace(tmp_path):
    """``StepTimer`` skips its warm-up steps, calls ``sync`` at every step's
    end and summarises as JAX's does; ``trace`` writes one Chrome trace
    (and nothing without a directory)."""
    from acvae_tpu.train.profiling import StepTimer as JStepTimer
    from acvae_tpu_torch.train.profiling import StepTimer, trace

    synced = []
    timer = StepTimer(warmup=2, sync=lambda: synced.append(1))
    for _ in range(5):
        with timer:
            torch.ones(8).sum()
    assert len(synced) == 5 and len(timer.times) == 3
    ref = JStepTimer(warmup=2)
    ref.times = list(timer.times)
    assert timer.summary() == ref.summary()
    assert StepTimer().summary() == {}
    with trace(None):
        pass
    with trace(str(tmp_path / "t")):
        torch.ones(4) @ torch.ones(4)
    (path,) = (tmp_path / "t").glob("*.json")
    assert "traceEvents" in json.loads(path.read_text())


# --------------------------------------------------------------------- #
# mid-epoch snapshots and resume
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def snapshots(ws, tmp_path_factory):
    """2 epochs (4 iterations each) with the time warp and a snapshot
    every 3 iterations: stopped at step 7 (``last`` at 4, ``step_0`` at 6),
    resumed; and the same command uninterrupted."""
    out = tmp_path_factory.mktemp("snap")
    args = ["train", str(ws / "port.yaml"), "--device=cpu",
            "--augments=[timewarp,timemask,freqmask]",
            "--checkpoint_every_steps=3"]
    a, b = out / "a", out / "b"
    with pytest.raises(SystemExit, match="injected failure at step 7"):
        cli.main(args + [f"--outputpath={a}", "--fault_abort_step=7"])
    stopped = tckpt.read_ckpt_steps(str(_exp(a)))
    resumed = cli.main(args + [f"--outputpath={a}", "--resume=true"])
    straight = cli.main(args + [f"--outputpath={b}"])
    return stopped, _exp(a), _exp(b), resumed, straight


def test_fault_then_resume_is_bit_identical(snapshots):
    """The resume restores step 6 (newer than ``last``'s 4) and skips 2
    batches of epoch 2; the weights, the optimizer state, the generators'
    states, epoch 1's metrics and epoch 2's validation equal the
    uninterrupted run's."""
    stopped, exp_a, exp_b, resumed, straight = snapshots
    assert stopped == {"last": 4, "best_score": stopped["best_score"], "step_0": 6}
    log = (exp_a / "train_caption.log").read_text()
    assert "resumed from" in log and "step_0 at step 6 → epoch 2 (skipping 2" in log
    a, b = (torch.load(d / "last.pt", weights_only=True) for d in (exp_a, exp_b))
    assert a["step"] == b["step"] == 8
    for k, v in b["state_dict"].items():
        assert torch.equal(a["state_dict"][k], v), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"]) == (8, 0)
    for i in ob["state"]:
        for k in ob["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    for k in ("generator", "torch"):
        assert torch.equal(a["rng"][k], b["rng"][k]), k
    ma, mb = _metrics(exp_a), _metrics(exp_b)
    assert len(ma) == len(mb) == 2
    for x in ma + mb:
        x.pop("epoch_wall_s")
    assert ma[0] == mb[0]
    # epoch 2's averages cover the batches after the resume only, as the
    # JAX CLI's do; what the weights decide is equal
    for k in ("epoch", "val_cider", "ss_ratio", "kl_weight", "dis_ratio"):
        assert ma[1][k] == mb[1][k], k
    for d in (exp_a, exp_b):
        assert not list(d.glob("step*.pt"))
        assert json.loads((d / "ckpt_steps.json").read_text()).keys() == {
            "last", "best_score"}


def _tiny_trainer():
    return Trainer(_port_conf(dict(SMALL, augments=None)), V, FDIM,
                   device="cpu", total_iters=10)


def test_resume_newest_picks_the_largest_restored_step(tmp_path, caplog):
    """Tried in the order of the recorded steps, ``last`` first on a tie;
    a torn snapshot is skipped with a warning; a stale-low entry loses to
    the larger restored step; nothing readable raises."""
    trainer = _tiny_trainer()
    exp = str(tmp_path)
    for name, step in (("last", 4), ("step_0", 6), ("step_1", 3)):
        trainer.step(_batch(step), step, 1)
        tckpt.save_checkpoint(exp, name, trainer, step)
    # stale-low meta: step_0 recorded below its restored 6
    tckpt.write_ckpt_step(exp, "last", 4)
    tckpt.write_ckpt_step(exp, "step_0", 2)
    tckpt.write_ckpt_step(exp, "step_1", 3)
    fresh = _tiny_trainer()
    assert tckpt.resume_newest(exp, fresh) == (6, "step_0")
    want = torch.load(tmp_path / "step_0.pt", weights_only=True)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want["state_dict"][k]), k
    assert fresh.optimizer.count == want["optimizer"]["count"]
    # a torn newest snapshot with a stale-high entry: skipped, warned
    (tmp_path / "step_0.pt").write_bytes(b"torn")
    tckpt.write_ckpt_step(exp, "step_0", 9)
    with caplog.at_level("WARNING", logger="acvae_tpu_torch"):
        assert tckpt.resume_newest(exp, _tiny_trainer()) == (4, "last")
    assert "step_0 unrestorable" in caplog.text
    for n in ("last", "step_1"):
        (tmp_path / f"{n}.pt").write_bytes(b"torn")
    with pytest.raises(RuntimeError, match="could not be read"):
        tckpt.resume_newest(exp, _tiny_trainer())


# --------------------------------------------------------------------- #
# average_checkpoints and diagnose, on a JAX experiment and its port copy
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jexp(ws, tmp_path_factory):
    """A tiny JAX flagship experiment with ``best`` and ``last`` of other
    weights (BatchNorm statistics moved off their init), and its port copy
    (``experiment_from_flax`` of each)."""
    root = tmp_path_factory.mktemp("jexp")
    jvocab = JVocabulary.load(str(ws / "vocab.pkl"))
    conf = flagship_conf(**dict(DEC_SMALL, data_dim=64),
                         h5_csv=str(ws / "h5.csv"),
                         caption_file=str(ws / "text.json"))
    model = j_build_model(conf, len(jvocab), 64)
    trees = {}
    for seed, name in ((2, "best"), (5, "last")):
        v = jax.tree_util.tree_map(np.array, jax.jit(lambda k: model.init(
            {"params": k, "sample": k}, np.zeros((2, 64, 64), np.float32),
            np.array([64, 40]), np.ones((2, 6), np.int32), np.array([6, 4]),
            train=False))(jax.random.key(seed)))
        rng = np.random.default_rng(seed)
        for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
            leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape)
                         if "var" in jax.tree_util.keystr(path)
                         else rng.normal(0, 0.3, leaf.shape))
        state = jtr.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v),
                                      optax.adam(1e-3))
        jckpt.save_checkpoint(str(root / "jax"), name, state, jvocab, dict(conf))
        trees[name] = v
        experiment_from_flax(v, j_load_config(str(root / "jax/config.yaml")),
                             Vocabulary.load(str(ws / "vocab.pkl")),
                             str(root / "port"), name)
    return root / "jax", root / "port", model, trees


def test_average_checkpoints_matches_jax(jexp):
    """``average_checkpoints best,last``: the port's ``avg.pt`` equals JAX's
    ``avg``, converted, exactly; ``evaluate --checkpoint=avg`` reads it."""
    jax_exp, port_exp, _, _ = jexp
    Runner().average_checkpoints(str(jax_exp), names="best,last")
    out = cli.main(["average_checkpoints", str(port_exp), "--names=best,last",
                    "--device=cpu"])
    assert out == str(port_exp / "avg.pt")
    ref = from_flax(jckpt.load_raw_checkpoint(str(jax_exp), "avg",
                                              subset=("params", "batch_stats")))
    ours = torch.load(port_exp / "avg.pt", weights_only=True)
    assert set(ours) == {"state_dict", "step"}
    assert ours["state_dict"].keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(ours["state_dict"][k], v), k
    _, _, model = tckpt.load_experiment(str(port_exp), "avg", device="cpu")
    assert torch.equal(model.state_dict()["decoder.word_embeddings.weight"],
                       ref["decoder.word_embeddings.weight"])


@pytest.mark.parametrize("names,exc", [("best", ValueError),
                                       ("best, best", ValueError),
                                       ("best,nope", FileNotFoundError)],
                         ids=["one", "duplicate", "missing"])
def test_average_checkpoints_refuses_as_jax(jexp, names, exc):
    jax_exp, port_exp, _, _ = jexp
    with pytest.raises(exc) as ref:
        Runner().average_checkpoints(str(jax_exp), names=names)
    with pytest.raises(exc) as ours:
        cli.average_checkpoints(str(port_exp), names=names)
    assert str(ours.value) == str(ref.value).replace(str(jax_exp), str(port_exp))


def test_diagnose_matches_jax(jexp, monkeypatch):
    """``diagnose`` of the same experiment, the dropouts off on both sides
    and the port's train forwards handed the draws of JAX's (its key
    100 + i, recovered from its outputs): every key JAX writes, atol 3e-4
    on its rounded values."""
    jax_exp, port_exp, model, trees = jexp
    variables = trees["best"]
    monkeypatch.setattr(jenc._DropoutMixin, "_dropout",
                        lambda self, x, rate, train: x)
    monkeypatch.setattr(torch.nn.functional, "dropout",
                        lambda x, p=0.5, training=True, inplace=False: x)
    fwd = jax.jit(lambda f, fl, c, cl, k, dis: model.apply(
        variables, f, fl, c, cl, ss_ratio=1.0, dis_ratio=dis, train=True,
        rngs={"sample": k}, mutable=["batch_stats"])[0])
    real, calls = VAECaptionModel.train_forward, []

    def fed(self, feats, feat_lens, caps, cap_lens, ss_ratio=1.0,
            dis_ratio=0.0, train=True, noise=None, generator=None):
        i = len(calls) // 2
        calls.append(dis_ratio)
        out = jax.tree_util.tree_map(np.asarray, fwd(
            feats.numpy(), feat_lens.numpy(), caps.numpy(), cap_lens.numpy(),
            jax.random.key(100 + i), dis_ratio))
        return real(self, feats, feat_lens, caps, cap_lens, ss_ratio, dis_ratio,
                    train, noise=_recovered_noise(out, 1.0, dis_ratio))
    monkeypatch.setattr(VAECaptionModel, "train_forward", fed)
    kw = dict(batches=2, batch_size=8)
    ref = jdiag.diagnose_experiment(str(jax_exp), **kw)
    ours = cli.main(["diagnose", str(port_exp), "--batches=2", "--batch_size=8",
                     "--device=cpu", f"--output={port_exp / 'diag.json'}"])
    assert calls == [0.0, 1.0, 0.0, 1.0]
    assert json.loads((port_exp / "diag.json").read_text()) == ours
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if k == "exp":
            assert ours[k] == str(port_exp)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=3e-4, err_msg=k)
        elif isinstance(v, list):
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=3e-4, err_msg=k)
        else:
            assert ours[k] == v, k
    assert os.path.exists(port_exp / "diag.json")
