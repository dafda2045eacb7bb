"""Port parity: the int8 serving encoder of ``acvae_tpu_torch`` (plain ops,
kernel wrappers, ``models/quant.py``, ``quant_from_flax``, the int8 decode
and ``CaptionService(encoder_int8=True)``) against ``acvae_tpu.models.quant``.

The JAX package serves its int8 encoder as a compiled program, and XLA's CPU
compiler fuses the epilogue ``acc·A + B`` into one fused multiply-add (the
first test pins this); the port computes that single rounding too, so the
JAX side of every bit-exact comparison here runs under ``jax.jit``.  Small
shapes as ``tests/test_quant.py``: channels (4, 8, 8, 16), N 4, T 128, F 64,
ragged lengths.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.quant as jquant
from acvae_tpu.models.encoders import Cnn10 as JCnn10
from acvae_tpu_torch.convert import from_flax, quant_from_flax
from acvae_tpu_torch.models import quant as tquant
from acvae_tpu_torch.models.encoders import Cnn10
from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (pack_conv3x3_weight,
                                                     stem_conv3x3_i8)
from acvae_tpu_torch.ops.int8 import (avgpool2x2_i8_ref, conv3x3_i8_ref,
                                      fma_f32, quant_stem, stem_coeffs)
from acvae_tpu_torch.train.checkpoints import load_experiment
from tests.test_torch_int8_kernels import conv_case
from tests.test_torch_decode import (E, T, eps_slab, fixed_eps,  # noqa: F401
                                     mels, port_model, small_jax_model)
from tests.test_torch_serve import (BATCH, BUCKET, MAXLEN,  # noqa: F401
                                    _quantize, _request_mels, experiments)
from tests.test_torch_decode import one_torch_thread  # noqa: F401

CH = (4, 8, 8, 16)
N, TQ, F = 4, 128, 64
LENS = np.array([TQ, TQ, 96, 64], np.int32)
SCHEMES = ["v1", "v2", "v2sym", "v3", "v4"]


# --------------------------------------------------------------------- #
# the epilogue's rounding
# --------------------------------------------------------------------- #
def test_xla_cpu_fuses_the_epilogue_into_fma():
    """Compiled, XLA's CPU rounds ``float(acc)·A + B`` once (an FMA);
    op by op it rounds twice.  ``fma_f32`` equals the compiled result,
    including sums that land next to a float32 halfway point, where
    rounding a float64 sum to float32 would round twice."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    a = rng.integers(-2**26, 2**26, size=n).astype(np.float32)
    b = (rng.normal(size=n) * 1e-3).astype(np.float32)
    c = (rng.normal(size=n) * 10).astype(np.float32)
    # a·b = 2^-24 - 2^-60: a float64 sum with c lands on a float32 midpoint
    a[:2], b[:2] = np.float32(1 + 2**-18), np.float32(2**-24 * (1 - 2**-18))
    c[:2] = np.float32(1 + 2**-23), np.float32(1.0)
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    eager = np.asarray(jnp.asarray(a) * jnp.asarray(b) + jnp.asarray(c))
    assert np.array_equal(eager, a * b + c)             # two roundings
    assert (fused != eager).sum() > n // 10
    out = fma_f32(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    np.testing.assert_array_equal(out, fused)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] != fused[0] and out[0] == np.float32(1 + 2**-23)


# --------------------------------------------------------------------- #
# plain ops against the JAX package's own methods, compiled
# --------------------------------------------------------------------- #
def _bare_jax_quant(**attrs):
    """A JAX QuantPannEncoder without calibration, for calling its methods."""
    q = object.__new__(jquant.QuantPannEncoder)
    q.__dict__.update(attrs)
    return q


def _jax_conv_epilogue(x, w, A, B, mode, pad):
    """``_conv`` then the affine, then ``_requantize`` / the final relu /
    nothing, as ``quant.py:455-472`` and ``:393-394`` chain them."""
    jq = _bare_jax_quant(offset=mode == "offset" or pad != 0)
    blk = {"w1": jnp.asarray(w)}

    def f(x, A, B):
        acc = jq._conv(x, blk, 1, offset_input=pad != 0)
        y = acc.astype(jnp.float32) * A + B
        if mode == "f32relu":
            return jnp.maximum(y, 0.0)
        return y if mode == "f32" else jq._requantize(y)
    return np.asarray(jax.jit(f)(x, A, B))


@pytest.mark.parametrize("mode,pad", [
    ("sym", 0), ("offset", -128), ("offset", 0), ("f32relu", 0),
    ("f32relu", -128), ("f32", -128)])
@pytest.mark.parametrize("big", [False, True], ids=["codes", "acc_past_2^24"])
def test_conv3x3_i8_ref_matches_jax(mode, pad, big):
    ci = 192 if big else 8
    x, w, A, B = conv_case(ci, 16, big, seed=ci - pad)
    ref = _jax_conv_epilogue(x, w, A, B, mode, pad)
    out = conv3x3_i8_ref(torch.tensor(x), torch.tensor(w), torch.tensor(A),
                         torch.tensor(B), mode, pad).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    if mode in ("sym", "offset"):   # the codes are not all clipped
        assert len(np.unique(out)) > 20


def test_avgpool2x2_i8_ref_matches_jax():
    x = np.random.default_rng(1).integers(-128, 128, size=(3, 11, 9, 16)
                                          ).astype(np.int8)
    ref = np.asarray(jax.jit(jquant._avgpool_i8)(x))
    out = avgpool2x2_i8_ref(torch.tensor(x)).numpy()
    assert out.shape == (3, 5, 4, 16)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("per_channel", [True, False], ids=["vector", "scalar"])
def test_quant_stem_matches_jax(per_channel):
    rng = np.random.default_rng(2)
    feats = (rng.normal(size=(3, 40, F)) * 4 - 3).astype(np.float32)
    s0 = rng.uniform(0.2, 2.0, size=F).astype(np.float32)
    b0 = rng.normal(size=F).astype(np.float32)
    s = np.array([0.037, 1e-12], np.float32) if per_channel else np.float32(0.041)
    jq = _bare_jax_quant(bn0=(jnp.asarray(s0), jnp.asarray(b0)), act_scales=[s],
                         stem_lane_pad=2)
    ref = np.asarray(jax.jit(jq._quant_stem)(feats))
    assert not ref[..., 1:].any()
    out = quant_stem(torch.tensor(feats), torch.tensor(s0), torch.tensor(b0),
                     s[0] if per_channel else s).numpy()
    np.testing.assert_array_equal(out, ref[..., :1])
    assert out.min() == -127 and out.max() == 127      # the clip is reached


def _stem_mel(rng, n, t, c1, c2):
    """A mel [n, t, 8] for the bins' c1, c2 (float32): bins 0-3 on a grid
    of 1/4, so that x·c1 + c2 lands on ties (.5) there; bins 4-7 random,
    with the values where one rounding of x·c1 + c2 and two (the product,
    then the sum) give different codes planted among them."""
    feats = (np.round(rng.normal(size=(n, t, 8)) * 24) / 4).astype(np.float32)
    for f in range(4, 8):
        # the floats next to each (k + 1/2 - c2) / c1, where x·c1 + c2 is
        # within a few ulps of a half: keep those whose codes differ
        x0 = ((np.arange(-120, 120) + 0.5 - c2[f]) / c1[f]).astype(np.float32)
        x = (x0[:, None] + np.spacing(x0)[:, None] * np.arange(-4, 5)).ravel()
        exact = x.astype(np.float64) * c1[f] + np.float64(c2[f])   # exact sum
        one = np.rint(exact.astype(np.float32))
        two = np.rint((x * c1[f]) + c2[f])
        found = rng.permutation(x[one != two])[:n * t // 4]
        col = rng.uniform(-4, 4, size=n * t).astype(np.float32)
        col[:found.size] = found
        feats[:, :, f] = rng.permutation(col).reshape(n, t)
    return feats


@pytest.mark.parametrize("scheme,mode", [("v1", "sym"), ("v2sym", "sym"),
                                         ("v2", "offset")])
def test_stem_operator_matches_jax(scheme, mode):
    """The fused stem's plain version (``stem_conv3x3_i8`` on the CPU)
    against JAX's ``_quant_stem``, the stem's ``_conv`` and ``_requantize``,
    compiled: codes and outputs identical, on ties and on values where two
    roundings of the multiply-add would give another code than one."""
    rng = np.random.default_rng(12)
    co, n, t = 16, 2, 40
    s0 = np.array([1.0, 2.0, 4.0, 0.5], np.float32)
    s0 = np.concatenate([s0, rng.uniform(5, 30, size=4).astype(np.float32)])
    b0 = np.array([0.5, 0.25, -0.5, 1.5], np.float32)
    b0 = np.concatenate([b0, (rng.normal(size=4) * 5).astype(np.float32)])
    # a stem scale of 1: c1, c2 are bn0's affine exactly
    s = np.float32(1.0) if scheme == "v1" else np.array([1.0, 1e-12], np.float32)
    feats = _stem_mel(rng, n, t, s0, b0)
    w = rng.integers(-127, 128, size=(3, 3, 2, co)).astype(np.int8)
    w[:, :, 1] = 0                                   # the padded lane
    A = (rng.uniform(0.5, 1.5, size=co) * 40 / (3 * 73.0 * 73.0)).astype(np.float32)
    B = (rng.normal(size=co) * 20).astype(np.float32)
    jq = _bare_jax_quant(bn0=(jnp.asarray(s0), jnp.asarray(b0)), act_scales=[s],
                         stem_lane_pad=2, offset=mode == "offset")
    blk = {"w1": jnp.asarray(w)}

    def f(feats):
        x = jq._quant_stem(feats)
        acc = jq._conv(x, blk, 1, offset_input=False)
        return x, jq._requantize(acc.astype(jnp.float32) * A + B)
    ref_codes, ref = (np.asarray(a) for a in jax.jit(f)(feats))
    c1, c2 = stem_coeffs(torch.tensor(s0), torch.tensor(b0),
                         s if scheme == "v1" else s[0])
    out, codes = stem_conv3x3_i8(torch.tensor(feats), c1, c2,
                                 pack_conv3x3_weight(torch.tensor(w[:, :, :1])),
                                 torch.tensor(A), torch.tensor(B), mode, codes=True)
    np.testing.assert_array_equal(codes.numpy(), ref_codes[..., :1])
    np.testing.assert_array_equal(out.numpy(), ref)
    # the data holds what the test is about: ties and double-rounding cases
    y = feats.astype(np.float64) * s0 + b0
    assert (np.abs(y - np.floor(y) - 0.5) == 0).sum() > 20
    two = np.clip(np.rint(feats * s0 + b0), -127, 127)
    assert (two != codes.numpy()[..., 0]).sum() >= 10
    assert len(np.unique(ref)) > 40


# --------------------------------------------------------------------- #
# calibration and baking
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def encoders():
    """(JAX Cnn10 variables as numpy, the port Cnn10 of them, feats): the
    BatchNorm statistics made non-trivial so that every fold is exercised."""
    rng = np.random.default_rng(0)
    feats = (rng.normal(size=(N, TQ, F)) * 2 - 1).astype(np.float32)
    enc = JCnn10(embed_size=CH[-1], channels=CH)
    v = enc.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                 feats, LENS, train=False)
    v = jax.tree_util.tree_map(np.array, v)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        name = jax.tree_util.keystr(path)
        leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape) if "var" in name
                     else rng.normal(-1.0, 0.3, leaf.shape))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        if "bn" in jax.tree_util.keystr(path):
            leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape) if "scale" in
                         jax.tree_util.keystr(path) else rng.normal(0, 0.5, leaf.shape))
    # the stem conv's second input lane reads only padding; zero its
    # initialised weights, as a model converted from the port has them
    # (the f32 encoder computes the same either way)
    stem = v["params"]["block0_4"]["conv1"]["kernel"]
    live = stem.copy()
    stem[:, :, 1:] = 0.0
    port = Cnn10(inputdim=F, embed_size=CH[-1], channels=CH, device="cpu")
    port.load_state_dict(from_flax(v), strict=True)
    return v, port, feats, live


@pytest.fixture(scope="module")
def jax_bakes(encoders):
    """scheme -> the JAX QuantPannEncoder calibrated on the encoders'
    batch, made once for the module."""
    v, _, feats, _ = encoders
    cache = {}

    def get(scheme):
        if scheme not in cache:
            cache[scheme] = jquant.QuantPannEncoder(
                v, jnp.asarray(feats), jnp.asarray(LENS), channels=CH,
                **jquant.scheme_kwargs(scheme))
        return cache[scheme]
    return get


def jax_baked(jq):
    """The baked arrays of a JAX QuantPannEncoder, as numpy."""
    return {"act_scales": [np.asarray(s) for s in jq.act_scales],
            "bn0": tuple(np.asarray(a) for a in jq.bn0),
            "fc": tuple(np.asarray(a) for a in jq.fc),
            "subsample": jq.subsample,
            **{k: getattr(jq, k) for k in ("per_channel", "offset", "mse_clip",
                                           "bias_correct", "quant_tail")},
            "blocks": [{k: (v if k == "pool" else np.asarray(v))
                        for k, v in b.items()
                        if k == "pool" or k[0] in "wAB" and k[1:] in "12"}
                       for b in jq.blocks]}


def _assert_same_bake(pq, jq):
    """Scales, affines within rtol 1e-5 (f32 convs summed in other orders);
    int8 weights identical."""
    js = [np.asarray(s) for s in jq.act_scales]
    js[0] = js[0][:1] if js[0].ndim else js[0]
    assert len(pq.act_scales) == len(js)
    for i, (a, b) in enumerate(zip(pq.act_scales, js)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=f"scale {i}")
    for bi, (pb, jb) in enumerate(zip(pq.blocks, jq.blocks)):
        for j in (1, 2):
            jw = np.asarray(jb[f"w{j}"])
            if bi == 0 and j == 1:
                jw = jw[:, :, :1]                # the padded stem lane
            np.testing.assert_array_equal(pb[f"w{j}"].numpy(), jw,
                                          err_msg=f"block {bi} w{j}")
            for k in ("A", "B"):
                ref = np.asarray(jb[f"{k}{j}"])
                np.testing.assert_allclose(
                    pb[f"{k}{j}"].numpy(), ref, rtol=1e-5,
                    atol=1e-5 * np.abs(ref).max(), err_msg=f"block {bi} {k}{j}")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_calibration_matches_jax(encoders, jax_bakes, scheme):
    """Both packages calibrate from the same batch and from bn0's
    statistics (the same numpy draws)."""
    v, port, feats, _ = encoders
    kw = jquant.scheme_kwargs(scheme)
    jq = jax_bakes(scheme)
    pq = tquant.QuantPannEncoder(port, torch.tensor(feats), torch.tensor(LENS),
                                 **tquant.scheme_kwargs(scheme))
    _assert_same_bake(pq, jq)
    jq0 = jquant.QuantPannEncoder.from_bn0_stats(v, channels=CH, **kw)
    pq0 = tquant.QuantPannEncoder.from_bn0_stats(port, **tquant.scheme_kwargs(scheme))
    _assert_same_bake(pq0, jq0)


def jax_codes(jq, feats, lens):
    """The JAX encoder's int8 activation at every quantize point (stem, then
    each requantized conv output, before pooling): ``quant.py:459-477``
    compiled, the codes kept."""
    def run(feats):
        x = jq._quant_stem(feats)
        codes = [x]
        n, k = len(jq.blocks), 0
        for bi, blk in enumerate(jq.blocks):
            for j in (1, 2):
                k += 1
                acc = jq._conv(x, blk, j, offset_input=k > 1)
                y = acc.astype(jnp.float32) * blk[f"A{j}"] + blk[f"B{j}"]
                if bi == n - 1 and j == 2 and not jq.quant_tail:
                    x = jnp.maximum(y, 0.0)
                else:
                    x = jq._requantize(y)
                    codes.append(x)
            if blk["pool"]:
                x = (jquant._avgpool_f32(x) if x.dtype == jnp.float32
                     else jquant._avgpool_i8(x))
        return codes
    codes = [np.asarray(c) for c in jax.jit(run)(feats)]
    assert not codes[0][..., 1:].any()
    codes[0] = codes[0][..., :1]
    return codes


def _flipped_codes(pq, jq, feats, lens):
    """How many codes differ between the two encoders over every quantize
    point of one batch (their int8 weights included)."""
    got = []
    pq(torch.tensor(feats), torch.tensor(lens), codes=got)
    n = sum(int((a.numpy() != b).sum())
            for a, b in zip(got, jax_codes(jq, feats, lens)))
    for pb, jb in zip(pq.blocks, jq.blocks):
        for j in (1, 2):
            jw = np.asarray(jb[f"w{j}"])
            n += int((pb[f"w{j}"].numpy() != jw[:, :, :pb[f"w{j}"].shape[2]]).sum())
    return n


@pytest.mark.parametrize("scheme", SCHEMES)
def test_same_calibration_same_codes(jax_bakes, scheme):
    """The JAX encoder carried across by ``quant_from_flax``: identical codes
    at every quantize point, embeddings within 1e-5, lengths equal."""
    jq = jax_bakes(scheme)
    pq = quant_from_flax(jax_baked(jq), device="cpu")
    x = (np.random.default_rng(5).normal(size=(N, TQ, F)) * 2 - 1).astype(np.float32)
    got = []
    out = pq(torch.tensor(x), torch.tensor(LENS), codes=got)
    ref_codes = jax_codes(jq, x, LENS)
    assert len(got) == len(ref_codes) == 8 + jq.quant_tail
    for i, (a, b) in enumerate(zip(got, ref_codes)):
        assert a.dtype == torch.int8 and a.shape == b.shape, i
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"quantize point {i}")
    ref = jax.jit(lambda f, l: jq(f, l))(x, LENS)
    for k in ("audio_embeds", "audio_embeds_pooled"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["audio_embeds_lens"].numpy(),
                                  np.asarray(ref["audio_embeds_lens"]))


def test_quant_from_flax_refuses_live_stem_lanes(jax_bakes):
    baked = jax_baked(jax_bakes("v2sym"))
    baked["act_scales"][0] = np.array([0.05, 0.05], np.float32)
    with pytest.raises(ValueError, match="lanes"):
        quant_from_flax(baked, device="cpu")


def test_v1_stem_weight_scale_reads_the_padded_lane(encoders):
    """With one activation scale for the whole stem (v1), the JAX package
    folds it into the padded lane's weights too, so their initialised
    values enter the stem conv's per-channel weight scale (``quant.py:80``,
    the max over HWI).  ``from_flax`` keeps those weights in
    ``stem_pad_lanes`` and the port's bake reads them: the stem's weight
    codes, A and B equal JAX's, and the rest of the bake agrees."""
    v, _, feats, live = encoders
    v_live = jax.tree_util.tree_map(np.array, v)
    v_live["params"]["block0_4"]["conv1"]["kernel"][...] = live
    port = Cnn10(inputdim=F, embed_size=CH[-1], channels=CH, device="cpu")
    port.load_state_dict(from_flax(v_live), strict=True)
    jq = jquant.QuantPannEncoder(v_live, jnp.asarray(feats), jnp.asarray(LENS),
                                 channels=CH, **jquant.scheme_kwargs("v1"))
    pq = tquant.QuantPannEncoder(port, torch.tensor(feats), torch.tensor(LENS),
                                 **tquant.scheme_kwargs("v1"))
    w_jax = np.asarray(jq.blocks[0]["w1"])
    np.testing.assert_array_equal(pq.blocks[0]["w1"].numpy(), w_jax[:, :, :1])
    for k in ("A1", "B1"):
        np.testing.assert_array_equal(pq.blocks[0][k].numpy(),
                                      np.asarray(jq.blocks[0][k]), err_msg=k)
    _assert_same_bake(pq, jq)
    # the live lane matters: without it (a port-native stem) the codes move
    zero = tquant.QuantPannEncoder(encoders[1], torch.tensor(feats),
                                   torch.tensor(LENS), **tquant.scheme_kwargs("v1"))
    assert (zero.blocks[0]["w1"].numpy() != w_jax[:, :, :1]).sum() > 0


def test_from_flax_keeps_the_padded_stem_lanes(encoders):
    """The JAX stem's padded lanes land in ``stem_pad_lanes`` (OIHW); the
    forward never reads them; a port-native Cnn10 has zeros there."""
    v, port, feats, live = encoders
    v_live = jax.tree_util.tree_map(np.array, v)
    v_live["params"]["block0_4"]["conv1"]["kernel"][...] = live
    sd = from_flax(v_live)
    np.testing.assert_array_equal(sd["stem_pad_lanes"].numpy(),
                                  live[:, :, 1:].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv_block1.conv1.weight"].numpy(),
                                  live[:, :, :1].transpose(3, 2, 0, 1))
    assert not from_flax(v)["stem_pad_lanes"].any()
    other = Cnn10(inputdim=F, embed_size=CH[-1], channels=CH, device="cpu")
    assert not other.stem_pad_lanes.any()
    assert "stem_pad_lanes" not in dict(other.named_parameters())
    other.load_state_dict(sd, strict=True)
    a = other(torch.tensor(feats), torch.tensor(LENS))
    b = port(torch.tensor(feats), torch.tensor(LENS))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_experiment_without_stem_lanes_loads(experiments, tmp_path):
    """An experiment dir written before ``stem_pad_lanes`` existed loads,
    with zero lanes; any other missing key still raises."""
    import shutil
    _, port_exp, _ = experiments
    for name in ("config.json", "vocab.pkl"):
        shutil.copy(f"{port_exp}/{name}", tmp_path / name)
    sd = torch.load(f"{port_exp}/best.pt", weights_only=True)["state_dict"]
    assert "encoder.stem_pad_lanes" in sd
    old = {k: v for k, v in sd.items() if k != "encoder.stem_pad_lanes"}
    torch.save({"state_dict": old}, tmp_path / "best.pt")
    _, _, model = load_experiment(str(tmp_path), device="cpu")
    assert not model.encoder.stem_pad_lanes.any()
    got = model.state_dict()
    for k, v in old.items():
        assert torch.equal(got[k], v), k
    old.pop("encoder.bn0.running_mean")
    torch.save({"state_dict": old}, tmp_path / "broken.pt")
    with pytest.raises(RuntimeError, match="Missing"):
        load_experiment(str(tmp_path), "broken", device="cpu")


# --------------------------------------------------------------------- #
# the slice end to end: int8 decode
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_int8():
    conf, model, variables = small_jax_model(seed=2)
    jq = jquant.quant_encoder_for(conf, model, variables["params"],
                                  variables["batch_stats"],
                                  **jquant.scheme_kwargs("v2sym"))
    return model, variables, jq, port_model(conf, variables)


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_int8_decode_matches_jax(small_int8, fixed_eps, method):
    model, variables, jq, port = small_int8
    feats, lens = mels(3)
    kw = dict(decode_method=method, max_length=T)
    if method == "beam":
        kw["beam_size"] = 3
    ref = jquant.int8_decode_fn(model, jq, **kw)(variables, feats, lens,
                                                 jax.random.key(0))
    pq = quant_from_flax(jax_baked(jq), device="cpu")
    rows = 3 * (3 if method == "beam" else 1)
    out = tquant.int8_decode_fn(port, pq, **kw)(
        torch.tensor(feats), torch.tensor(lens),
        eps=torch.tensor(eps_slab(T, rows, E)))
    np.testing.assert_array_equal(out["seqs"].numpy(), np.asarray(ref["seqs"]))
    score = "scores" if method == "beam" else "sampled_logprobs"
    np.testing.assert_allclose(out[score].numpy(), np.asarray(ref[score]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# the service
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", ["v2sym", "v4"])
def test_int8_caption_service_matches_jax(experiments, fixed_eps, monkeypatch,
                                          scheme):
    """Each service calibrates on its own; if the two calibrations disagree
    on any code, the count is reported and the comparison runs again with
    the JAX encoder carried across."""
    from acvae_tpu.serve import CaptionService as JCaptionService
    from acvae_tpu_torch.serve import CaptionService

    jax_exp, port_exp, _ = experiments
    baked = {}
    make = jquant.quant_encoder_for
    monkeypatch.setattr(jquant, "quant_encoder_for", lambda *a, **k:
                        baked.setdefault("jq", make(*a, **k)))
    kw = dict(batch_size=BATCH, mel_bucket=BUCKET, max_length=MAXLEN,
              encoder_int8=True, int8_scheme=scheme)
    jsvc = JCaptionService(jax_exp, **kw)
    psvc = CaptionService(port_exp, device="cpu", **kw)
    jq = baked["jq"]
    mels_ = _request_mels()
    q8 = [_quantize(m) for m in mels_]
    feats = np.zeros((BATCH, BUCKET, mels_[0].shape[1]), np.float32)
    lens = np.ones((BATCH,), np.int32)
    for i, m in enumerate(mels_):
        feats[i], lens[i] = psvc._prep(m)
    flipped = _flipped_codes(psvc.quant, jq, feats, lens)
    if flipped:
        warnings.warn(f"int8 {scheme}: the two calibrations differ in "
                      f"{flipped} codes; captions compared with the JAX "
                      f"scales carried across")
        psvc.quant = quant_from_flax(jax_baked(jq), device="cpu")
    assert psvc.caption(mels_) == jsvc.caption(mels_)
    assert psvc.caption(q8) == jsvc.caption(q8)


def test_invalid_int8_compositions_raise(experiments, encoders):
    from acvae_tpu.serve import CaptionService as JCaptionService
    from acvae_tpu_torch.serve import CaptionService

    jax_exp, port_exp, _ = experiments
    base = dict(batch_size=2, mel_bucket=BUCKET, max_length=MAXLEN,
                encoder_int8=True)
    for bad, match in (({"decode_dtype": "bfloat16"}, "decode_dtype"),
                       ({"int8_scheme": "v9"}, "int8_scheme")):
        with pytest.raises(ValueError, match=match):
            JCaptionService(jax_exp, **base, **bad)
        with pytest.raises(ValueError, match=match):
            CaptionService(port_exp, device="cpu", **base, **bad)
    v, port, feats, _ = encoders
    for bad in ({"quant_tail": True, "offset": True},
                {"quant_tail": True, "offset": False, "bias_correct": True}):
        with pytest.raises(ValueError, match="quant_tail"):
            jquant.QuantPannEncoder(v, feats, LENS, channels=CH, **bad)
        with pytest.raises(ValueError, match="quant_tail"):
            tquant.QuantPannEncoder(port, torch.tensor(feats), torch.tensor(LENS),
                                    **bad)
    _, _, model = load_experiment(port_exp, device="cpu")
    with pytest.raises(ValueError, match="Cnn10/Cnn14"):
        tquant.quant_encoder_for({"encodermodel": "CRNN"}, model)
    # Cnn14 bakes, as JAX's _arch_spec lays it out: its five pooled blocks
    # and the unpooled last one, head fc1, subsample 32 (its scales and
    # codes against JAX's: tests/test_torch_encoders.py)
    from acvae_tpu_torch.configs import flagship_conf
    from acvae_tpu_torch.models.build import build_model
    from tests.test_torch_train_step import SMALL

    conf14 = flagship_conf(**dict(SMALL, encodermodel="Cnn14",
                                  encoder_args={"embed_size": 2048}))
    model14 = build_model(conf14, 9, F, device="cpu")
    feats14 = np.random.default_rng(3).normal(size=(2, 64, F)).astype(np.float32)
    pq = tquant.quant_encoder_for(conf14, model14, calib=(
        torch.tensor(feats14), torch.tensor([64, 40])),
        **tquant.scheme_kwargs("v2sym"))
    spec = jquant._arch_spec("Cnn14", CH)
    assert [b["pool"] for b in pq.blocks] == [p for _, p in spec["blocks"]]
    assert pq.subsample == spec["subsample"] == 32
    assert tuple(pq.fc[0].shape) == (2048, 2048)
    assert [tuple(b["w2"].shape) for b in pq.blocks] == [
        (3, 3, c, c) for c in (64, 128, 256, 512, 1024, 2048)]
    with pytest.raises(ValueError, match="inference_from_encoded"):
        tquant.quant_encoder_for({"encodermodel": "Cnn10"}, model.encoder)


def test_serve_main_parses_the_int8_flags(experiments, monkeypatch):
    import acvae_tpu_torch.serve as serve_mod

    got = {}
    monkeypatch.setattr(serve_mod, "run_server",
                        lambda svc, **kw: got.update(svc=svc, **kw))
    serve_mod.main([experiments[1], "--device", "cpu", "--port", "0",
                    "--batch_size", "2", "--mel_bucket", str(BUCKET),
                    "--max_length", "4", "--encoder_int8", "--int8_scheme", "v4"])
    q = got["svc"].quant
    assert q.quant_tail and q.per_channel and not q.offset
    assert len(got["svc"].caption([_request_mels()[0]])) == 1
    with pytest.raises(SystemExit):
        serve_mod.main([experiments[1], "--encoder_int8", "--int8_scheme", "v9"])
