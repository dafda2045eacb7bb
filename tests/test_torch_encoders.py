"""Port parity: the encoder zoo of ``acvae_tpu_torch`` (``models/encoders.py``
and ``build_encoder``, ``from_flax``'s encoder names, the int8 Cnn14, the PANN
and espnet warm starts, the kaldi tables and a non-PANN encoder through the
CLI) against ``acvae_tpu``.

Every registered encoder at ``tests/test_encoders.py``'s widths (N 2, T 64,
F 64); the fixed-width Cnn14 and ResNet38 are initialised once for the
module and shared by their float, int8 and ingest cases.  The JAX side runs
on the CPU with its dropouts off (``_DropoutMixin._dropout`` patched, the
TransformerEncoder's attention dropout at 0) and the port's
``F.dropout`` patched to identity, so that train-mode forwards compare
(BatchNorm on batch statistics, running statistics updated).  Weights cross
with ``from_flax``.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import acvae_tpu.models.encoders as jenc
import acvae_tpu.models.quant as jquant
from acvae_tpu.cli.main import Runner
from acvae_tpu.core.registry import ENCODERS as J_ENCODERS
from acvae_tpu.data import kaldi as jkaldi
from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.train import checkpoints as jckpt
from acvae_tpu.train import pretrained as jpre
from acvae_tpu.train.trainer import TrainState
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import experiment_from_flax, from_flax, quant_from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data import kaldi as tkaldi
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models import quant as tquant
from acvae_tpu_torch.models.encoders import ENCODERS, build_encoder, lp_pool
from acvae_tpu_torch.train import pretrained as tpre
from tests.test_encoders import CONFIGS
from tests.test_torch_cli import EPOCH_KEYS, _eval_files, _metrics, ws  # noqa: F401
from tests.test_torch_decode import SMALL, fixed_eps, one_torch_thread  # noqa: F401
from tests.test_torch_quant import _assert_same_bake, jax_baked

N, T, F = 2, 64, 64
LENS = np.array([T, 32], np.int32)
SUB = {"embed_size": 16, "channels": (4, 8, 8, 16)}
# tests/test_encoders.py's CONFIGS, then the encoders it tests apart
CASES = [(name, args) for name, args, _, _ in CONFIGS] + [
    ("ResNet38", {}),
    ("CNNEncoder", {"embed_size": 16}),
    ("PreTrainedCNN", {"trunk": {"name": "CNN10Encoder"}, "embed_size": 8}),
    ("CNN10CRNNEncoder", {"crnn": dict(SUB, name="CRNN8_Sub4"),
                          "cnn": dict(SUB, name="CNN10QEncoder")})]
BIG = ("Cnn14", "ResNet38")
FIXED_WIDTH = BIG + ("CNN10Encoder",)


def _jax_encoder(name, args):
    args = dict(args)
    for key in ("trunk", "crnn", "cnn"):
        if isinstance(args.get(key), dict):
            sub = dict(args[key])
            args[key] = J_ENCODERS.build(sub.pop("name"), inputdim=F, **sub)
    if name == "TransformerEncoder":
        args["dropout"] = 0.0
    return J_ENCODERS.build(name, inputdim=F, **args)


def _port_args(name, args):
    return dict(args, dropout=0.0) if name == "TransformerEncoder" else args


def _feats(seed=0):
    return np.random.default_rng(seed).normal(size=(N, T, F)).astype(np.float32)


def _init(name, args, seed=0):
    """JAX variables as numpy, the BatchNorm statistics drawn away from
    (0, 1) so that every fold shows."""
    enc = _jax_encoder(name, args)
    v = jax.jit(lambda k: enc.init({"params": k, "dropout": k}, _feats(),
                                   LENS, train=False))(jax.random.key(seed))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(seed + 5)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v.get("batch_stats", {})):
        leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape) if "var" in jax.tree_util.keystr(path)
                     else rng.normal(0, 0.3, leaf.shape))
    return enc, v


@pytest.fixture(scope="module")
def big():
    """The fixed-width Cnn14 and ResNet38, initialised once: name -> (JAX
    module, numpy variables)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _init(name, dict(CASES)[name])
        return cache[name]
    return get


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jenc._DropoutMixin, "_dropout",
                        lambda self, x, rate, train: x)
    monkeypatch.setattr(torch.nn.functional, "dropout",
                        lambda x, p=0.5, training=True, inplace=False: x)


def _close(a, b, what, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=1e-5, atol=atol, err_msg=what)


def test_registry_names_every_jax_encoder():
    assert sorted(ENCODERS) == sorted(J_ENCODERS)
    assert sorted(ENCODERS) == sorted({name for name, _ in CASES})
    with pytest.raises(KeyError, match="registered"):
        build_encoder("Cnn12", {}, F)


@pytest.mark.parametrize("name,args", CASES, ids=[name for name, _ in CASES])
def test_encoder_matches_jax(big, no_dropout, name, args):
    """Eval forward, then a train-mode forward (batch statistics) and the
    running statistics it leaves: within rtol/atol 1e-5, lengths exact,
    the state dict loading strictly.  The train-mode outputs of the
    fixed-width encoders (Cnn14, ResNet38, CNN10Encoder, up to 2048
    channels) take atol 1e-4: their deep BatchNorms normalise each channel
    over a few values (Cnn14's and ResNet38's last over the 8 of a 2×2
    map at N 2), which magnifies the float32 sum-order noise of the convs
    under them (3e-5 measured; their eval outputs agree to 1e-6)."""
    enc, v = big(name) if name in BIG else _init(name, args)
    port = build_encoder(name, _port_args(name, args), F, device="cpu")
    port.load_state_dict(from_flax(v), strict=True)
    x, lens = jnp.asarray(_feats(1)), jnp.asarray(LENS)

    @jax.jit
    def run(v):
        ev = enc.apply(v, x, lens, train=False)
        tr, upd = enc.apply(v, x, lens, train=True, mutable=["batch_stats"])
        return ev, tr, upd
    ev, tr, upd = run(v)
    xt, lt = torch.tensor(_feats(1)), torch.tensor(LENS)
    with torch.no_grad():
        outs = {"eval": port(xt, lt, train=False), "train": port(xt, lt, train=True)}
    for mode, ref in (("eval", ev), ("train", tr)):
        for k in ("audio_embeds", "audio_embeds_pooled"):
            assert tuple(outs[mode][k].shape) == ref[k].shape, (mode, k)
            _close(ref[k], outs[mode][k], f"{mode} {k}",
                   1e-4 if mode == "train" and name in FIXED_WIDTH else 1e-5)
        np.testing.assert_array_equal(outs[mode]["audio_embeds_lens"].numpy(),
                                      np.asarray(ref["audio_embeds_lens"]))
    want = from_flax({"params": v["params"],
                      "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                            upd.get("batch_stats", {}))})
    sd = port.state_dict()
    for k, val in want.items():
        if "running" in k:
            _close(val.numpy(), sd[k], k)
    assert any("running" in k for k in want) == bool(v.get("batch_stats"))


def test_lp_pool_and_flatten_order():
    """``lp_pool`` written out as JAX's ``_lp_pool`` (not ``F.lp_pool2d``),
    odd edges dropped."""
    x = np.random.default_rng(3).normal(size=(2, 3, 9, 13)).astype(np.float32)
    ref = np.asarray(jenc._lp_pool(jnp.asarray(x.transpose(0, 2, 3, 1)), 4.0, (2, 4)))
    out = lp_pool(torch.tensor(x), 4.0, (2, 4)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_pretrained_cnn_trunk_is_frozen():
    """PreTrainedCNN: no gradient reaches the trunk, the head trains; the
    trunk's running statistics stay in a train-mode forward."""
    port = build_encoder("PreTrainedCNN", {"trunk": dict(SUB, name="Cnn10"),
                                           "embed_size": 8}, F, device="cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = port(torch.tensor(_feats()), torch.tensor(LENS), train=True)
    (out["audio_embeds_pooled"] ** 2).sum().backward()
    assert all(p.grad is None for p in port.trunk.parameters())
    assert port.outputlayer.weight.grad.abs().sum() > 0
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


# --------------------------------------------------------------------- #
# int8 Cnn14
# --------------------------------------------------------------------- #
def _jax_int8(jq, x, lens):
    """The JAX encoder's codes at every quantize point (as
    ``tests/test_torch_quant.py::jax_codes``) and its output, compiled once
    with the baked weights as arguments (as constants, Cnn14's 80 M would
    take XLA seconds to fold)."""
    pools = [b["pool"] for b in jq.blocks]
    arrays = [{k: jnp.asarray(a) for k, a in b.items() if k[0] in "wAB"}
              for b in jq.blocks]

    @jax.jit
    def run(x, lens, arrays):
        q = copy.copy(jq)
        q.blocks = [dict(a, pool=p) for a, p in zip(arrays, pools)]
        codes = [q._quant_stem(x)]
        y, k = codes[0], 0
        for bi, blk in enumerate(q.blocks):
            for j in (1, 2):
                k += 1
                acc = q._conv(y, blk, j, offset_input=k > 1)
                z = acc.astype(jnp.float32) * blk[f"A{j}"] + blk[f"B{j}"]
                if bi == len(pools) - 1 and j == 2 and not q.quant_tail:
                    y = jnp.maximum(z, 0.0)
                else:
                    y = q._requantize(z)
                    codes.append(y)
            if blk["pool"]:
                y = jquant._avgpool_i8(y)
        return codes, q(x, lens)
    codes, out = run(jnp.asarray(x), jnp.asarray(lens), arrays)
    codes = [np.asarray(c) for c in codes]
    assert not codes[0][..., 1:].any()
    codes[0] = codes[0][..., :1]
    return codes, out


@torch.no_grad()
def _calibration_f64(port, feats, lens):
    """Cnn14's calibration pass in float64 on the same float32 weights: per
    quantize point and channel, the largest valid |activation| and the
    largest sum of |terms| behind one (|bn scale|·(|W|∗|x|) + |bn bias|),
    M.  Two float32 summations of the same terms in different orders
    differ by a small multiple of u·M; a channel whose max nearly cancels
    (block 5's 4×4 maps hold a few valid values per channel at N 2) shows
    that as a large relative gap."""
    def fold(bn):
        s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
        return s, bn.bias.double() - bn.running_mean.double() * s

    def valid(v, n):                                      # v: [N, C, T, F]
        m = (torch.arange(v.shape[2])[None, :] < n[:, None])[:, None, :, None]
        return torch.amax(torch.where(m, v, 0.0), dim=(0, 2, 3)).numpy()

    s0, b0 = fold(port.bn0)
    feats, n = torch.tensor(feats, dtype=torch.float64)[:, None], torch.tensor(lens)
    x = feats * s0 + b0                                   # NCHW, H time
    maxima, sizes = [valid(x.abs(), n)], [valid(feats.abs() * s0.abs() + b0.abs(), n)]
    for i, blk in enumerate(port.blocks):
        for j in (1, 2):
            w = getattr(blk, f"conv{j}").weight.double()
            s, b = (a[:, None, None] for a in fold(getattr(blk, f"bn{j}")))
            sizes.append(valid(torch.nn.functional.conv2d(x.abs(), w.abs(), padding=1)
                               * s.abs() + b.abs(), n))
            x = torch.relu(torch.nn.functional.conv2d(x, w, padding=1) * s + b)
            maxima.append(valid(x, n))
        if i < 5:
            x, n = torch.nn.functional.avg_pool2d(x, 2), torch.clamp_min(n // 2, 1)
    return maxima, sizes


@pytest.fixture(scope="module")
def cnn14_calibration(big):
    """(JAX variables, the port Cnn14 of them, calibration feats, the
    float64 pass of its calibration)."""
    _, v = big("Cnn14")
    port = build_encoder("Cnn14", {}, F, device="cpu")
    port.load_state_dict(from_flax(v), strict=True)
    feats = (_feats(2) * 2 - 1).astype(np.float32)
    return v, port, feats, _calibration_f64(port, feats, LENS)


@pytest.mark.parametrize("scheme", ["v1", "v2sym", "v4"])
def test_int8_cnn14_matches_jax(cnn14_calibration, scheme):
    """JAX's bake of the Cnn14 carried across (``quant_from_flax``): the
    codes at every quantize point (stem, 11 requantized convs, the v4
    tail) identical, the embeddings within 1e-5, the lengths equal.

    The port's own calibration of the same weights (``from_flax``, the live
    padded stem lane in ``stem_pad_lanes`` for v1's weight scale): each
    scale, JAX's and the port's, within rtol 1e-5 plus 8·u·M/levels of the
    float64 pass (``_calibration_f64``), and of each other; the ratios to
    u·M/levels are printed.  Given the port's scales, JAX bakes the same
    int8 weights and the same A/B (``_assert_same_bake``)."""
    v, port, feats, (maxima, sizes) = cnn14_calibration
    kw = jquant.scheme_kwargs(scheme)
    jq = jquant.QuantPannEncoder(v, jnp.asarray(feats), jnp.asarray(LENS),
                                 arch="Cnn14", **kw)
    pq = quant_from_flax(jax_baked(jq), device="cpu")
    assert [b["pool"] for b in pq.blocks] == [True] * 5 + [False]
    x = (_feats(3) * 2 - 1).astype(np.float32)
    got = []
    out = pq(torch.tensor(x), torch.tensor(LENS), codes=got)
    ref_codes, ref = _jax_int8(jq, x, LENS)
    assert len(got) == len(ref_codes) == 12 + jq.quant_tail
    for i, (a, b) in enumerate(zip(got, ref_codes)):
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"quantize point {i}")
    for k in ("audio_embeds", "audio_embeds_pooled"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["audio_embeds_lens"].numpy(), LENS // 32)
    own = tquant.QuantPannEncoder(port, torch.tensor(feats), torch.tensor(LENS),
                                  arch="Cnn14", **tquant.scheme_kwargs(scheme))
    js = [np.asarray(s) for s in jq.act_scales]
    stem = np.concatenate([own.act_scales[0], js[0][1:]]) if js[0].ndim else None
    js[0] = js[0][:1] if js[0].ndim else js[0]
    assert len(own.act_scales) == len(js) == 12 + jq.quant_tail
    worst = {}
    for i, (a, b) in enumerate(zip(own.act_scales, js)):
        m, top = ((sizes[i], maxima[i]) if kw["per_channel"]
                  else (sizes[i].max(), maxima[i].max()))
        ulp = 2.0 ** -24 * m / own._levels(i)
        r = top / own._levels(i) + 1e-12
        for what, gap in (("port - jax", a - b), ("port - f64", a - r),
                          ("jax - f64", b - r)):
            gap = np.abs(np.asarray(gap, np.float64))
            assert np.all(gap <= 1e-5 * np.abs(r) + 8 * ulp), (what, i)
            worst[what] = max(worst.get(what, 0.0), np.max(gap / ulp))
        worst["relative port - jax"] = max(worst.get("relative port - jax", 0.0),
                                           np.max(np.abs(a - b) / b))
    print(scheme, {k: f"{w:.3g}" for k, w in worst.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant.QuantPannEncoder, "_calibrate", lambda self, f, n: (
            [own.act_scales[0] if stem is None else stem] + own.act_scales[1:]))
        same = jquant.QuantPannEncoder(v, jnp.asarray(feats), jnp.asarray(LENS),
                                       arch="Cnn14", **kw)
    _assert_same_bake(own, same)


# --------------------------------------------------------------------- #
# warm starts
# --------------------------------------------------------------------- #
def _pann_layout(sd):
    """A port PANN encoder's state dict as PANN writes it: numpy, the
    frontend's and the tagger head's keys added, no ``stem_pad_lanes``."""
    rng = np.random.default_rng(8)
    out = {k: v.numpy() for k, v in sd.items() if k != "stem_pad_lanes"}
    out.update({"spectrogram_extractor.stft.conv_real.weight": rng.normal(size=(4, 1, 8)),
                "logmel_extractor.melW": rng.normal(size=(8, 64)),
                "fc_audioset.weight": rng.normal(size=(527, 8)),
                "fc_audioset.bias": rng.normal(size=(527,)),
                "bn0.num_batches_tracked": np.array(3)})
    return out


def _assert_same(ours, want):
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], v), k


@pytest.mark.parametrize("arch", ["Cnn10", "Cnn14", "ResNet38"])
def test_pann_ingest_matches_jax(big, arch):
    """A PANN state dict of each arch renames exactly as ``pann_to_flax``
    then ``from_flax`` (the stem's padded lanes zero, the frontend and
    ``fc_audioset`` skipped; Cnn10's ``fc1`` is ``embed_pooled``), and
    loads strictly into the port encoder.  ResNet38's stride-2 shortcut
    written as PANN writes it (``downsample.1``/``.2`` behind its
    AvgPool2d) reads as ``downsample.0``/``.1``."""
    if arch == "Cnn10":
        port = build_encoder("Cnn10", SUB, F, device="cpu")
        sd = _pann_layout(port.state_dict())
        sd["fc1.weight"] = sd.pop("embed_pooled.weight")
        sd["fc1.bias"] = sd.pop("embed_pooled.bias")
    else:
        port = build_encoder(arch, {}, F, device="cpu")
        sd = _pann_layout(from_flax(big(arch)[1]))
    want = from_flax(jpre.pann_to_flax(sd))
    assert not want["stem_pad_lanes"].any()
    ours = tpre.pann_state_dict(sd)
    _assert_same(ours, want)
    port.load_state_dict(ours, strict=True)
    if arch == "ResNet38":
        shifted = {}
        for k, val in sd.items():
            if ".downsample." in k and not k.startswith("resnet.layer1."):
                head, idx, leaf = k.rsplit(".", 2)
                k = f"{head}.{int(idx) + 1}.{leaf}"
            shifted[k] = val
        _assert_same(tpre.pann_state_dict(shifted), want)


def _espnet_dict(lstm_layer=True):
    """A seeded espnet VGG2L + RNNP dict under ``enc.enc.``: BiGRU layer 0
    (input 128·F/4), then a BiLSTM (or BiGRU) layer 1, hidden 8, bt 16."""
    rng = np.random.default_rng(4)
    sd = {}
    for s, (ci, co) in ((1, (1, 64)), (2, (64, 128))):
        for j in (1, 2):
            sd[f"enc.enc.0.conv{s}_{j}.weight"] = rng.normal(
                size=(co, ci if j == 1 else co, 3, 3)).astype(np.float32)
            sd[f"enc.enc.0.conv{s}_{j}.bias"] = rng.normal(size=(co,)).astype(np.float32)
    for i, (d_in, gates) in enumerate(((128 * F // 4, 3), (16, 4 if lstm_layer else 3))):
        for rev in ("", "_reverse"):
            for leaf, shape in (("weight_ih", (gates * 8, d_in)), ("weight_hh", (gates * 8, 8)),
                                ("bias_ih", (gates * 8,)), ("bias_hh", (gates * 8,))):
                sd[f"enc.enc.1.birnn{i}.{leaf}_l0{rev}"] = rng.normal(
                    size=shape).astype(np.float32)
        sd[f"enc.enc.1.bt{i}.weight"] = rng.normal(size=(16, 16)).astype(np.float32)
        sd[f"enc.enc.1.bt{i}.bias"] = rng.normal(size=(16,)).astype(np.float32)
    return sd


@pytest.mark.parametrize("lstm", [False, True], ids=["gru", "lstm"])
def test_espnet_ingest_matches_jax(lstm):
    """espnet -> the port's E2EASREncoder names exactly as
    ``espnet_to_flax`` then ``from_flax`` (the first GRU layer's input
    columns permuted freq-major; an LSTM layer skipped with a log line);
    the GRU-only dict loads strictly and the encoder computes what JAX's
    does on the converted tree; ``inputdim % 4`` raises on both sides."""
    sd = _espnet_dict(lstm)
    jlog, log = [], []
    want = from_flax(jpre.espnet_to_flax(sd, F, jlog.append))
    ours = tpre.espnet_state_dict({k: torch.tensor(v) for k, v in sd.items()}, F,
                                  log.append)
    _assert_same(ours, want)
    assert any("not a GRU" in m for m in log) == lstm == any("not a GRU" in m for m in jlog)
    if not lstm:
        args = {"embed_size": 16, "hidden_size": 8, "nlayers": 2}
        port = build_encoder("E2EASREncoder", args, F, device="cpu")
        port.load_state_dict(ours, strict=True)
        enc = J_ENCODERS.build("E2EASREncoder", inputdim=F, **args)
        ref = jax.jit(lambda p: enc.apply({"params": p}, _feats(), LENS))(
            jpre.espnet_to_flax(sd, F, jlog.append)["params"])
        with torch.no_grad():
            out = port(torch.tensor(_feats()), torch.tensor(LENS))
        _close(ref["audio_embeds"], out["audio_embeds"], "audio_embeds")
    for fn in (lambda: jpre.espnet_to_flax(sd, 66, print),
               lambda: tpre.espnet_state_dict(sd, 66, print)):
        with pytest.raises(ValueError, match="not divisible by 4"):
            fn()


# --------------------------------------------------------------------- #
# kaldi tables
# --------------------------------------------------------------------- #
def test_kaldi_round_trip_matches_jax(tmp_path):
    """The port's writer writes the JAX writer's bytes (float32 and float64
    matrices, the scp offsets); both read back the matrices; a text-format
    entry raises naming it."""
    rng = np.random.default_rng(1)
    mats = {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b-2": rng.normal(size=(1, 5)).astype(np.float64),
            "c": np.zeros((0, 5), np.float32)}
    jkaldi.write_mat_ark(str(tmp_path / "j.ark"), mats, str(tmp_path / "j.scp"))
    tkaldi.write_mat_ark(str(tmp_path / "t.ark"), mats, str(tmp_path / "t.scp"))
    assert (tmp_path / "t.ark").read_bytes() == (tmp_path / "j.ark").read_bytes()
    assert ((tmp_path / "t.scp").read_text().replace("t.ark", "j.ark")
            == (tmp_path / "j.scp").read_text())
    for reader, path in ((tkaldi.read_mat_ark, "j.ark"), (tkaldi.read_mat_scp, "j.scp")):
        got = dict(reader(str(tmp_path / path)))
        assert list(got) == list(mats)
        for k, m in mats.items():
            assert got[k].dtype == m.dtype and np.array_equal(got[k], m), k
    (tmp_path / "text.ark").write_bytes(b"a  [ 1 2 ]\n")
    with pytest.raises(ValueError, match="not a kaldi binary entry"):
        list(tkaldi.read_mat_ark(str(tmp_path / "text.ark")))


# --------------------------------------------------------------------- #
# a non-PANN encoder through the CLI
# --------------------------------------------------------------------- #
CRNN = {"embed_size": 16, "channels": [4, 8, 8, 16]}


def test_cli_trains_and_evaluates_crnn8_sub4(ws, fixed_eps, tmp_path):  # noqa: F811
    """``train`` with ``--encodermodel=CRNN8_Sub4`` writes the experiment
    and JAX's epoch keys; a JAX CRNN8_Sub4 flagship carried across by
    ``experiment_from_flax`` evaluates to JAX's files exactly, and the same
    corpus as a kaldi ``.scp`` table to the same captions."""
    args = ["--device=cpu", "--epochs=1", "--encodermodel=CRNN8_Sub4",
            "--encoder_args={embed_size: 16, channels: [4, 8, 8, 16]}"]
    exp = Path(cli.main(["train", str(ws / "port.yaml"),
                         f"--outputpath={tmp_path}"] + args))
    (m,) = _metrics(exp)
    assert set(m) == EPOCH_KEYS and all(np.isfinite(x) for x in m.values())
    jvocab = JVocabulary.load(str(ws / "vocab.pkl"))
    conf = flagship_conf(**dict(SMALL, data_dim=F, encodermodel="CRNN8_Sub4",
                                encoder_args=CRNN),
                         h5_csv=str(ws / "h5.csv"), caption_file=str(ws / "text.json"))
    model = j_build_model(conf, len(jvocab), F)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "sample": k}, np.zeros((2, 64, F), np.float32),
        np.array([64, 40]), np.ones((2, 6), np.int32), np.array([6, 4]),
        train=False))(jax.random.key(4))
    state = TrainState.create(variables, optax.adam(1e-3))
    jckpt.save_checkpoint(str(tmp_path / "jax"), "best", state, jvocab, dict(conf))
    tree = jckpt.load_raw_checkpoint(str(tmp_path / "jax"), "best",
                                     subset=("params", "batch_stats"))
    experiment_from_flax(tree, load_config(str(tmp_path / "jax/config.yaml")),
                         Vocabulary.load(str(tmp_path / "jax/vocab.pkl")),
                         str(tmp_path / "port"))
    kw = dict(eval_h5_csv=str(ws / "h5.csv"), eval_caption_file=str(ws / "text.json"))
    assert cli.evaluate(str(tmp_path / "port"), device="cpu", **kw) == \
        Runner().evaluate(str(tmp_path / "jax"), **kw)
    assert _eval_files(tmp_path / "port") == _eval_files(tmp_path / "jax")
    with np.load(ws / "mels.npz") as z:
        tkaldi.write_mat_ark(str(tmp_path / "mels.ark"), {k: z[k] for k in z.files},
                             str(tmp_path / "mels.scp"))
    cli.evaluate(str(tmp_path / "port"), device="cpu", tag="scp",
                 eval_h5_csv=str(tmp_path / "mels.scp"),
                 eval_caption_file=str(ws / "text.json"))
    assert (_eval_files(tmp_path / "port", "_scp")[0]
            == _eval_files(tmp_path / "port")[0])
