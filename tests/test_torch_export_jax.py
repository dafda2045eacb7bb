"""Port parity: the exported beam decode of ``acvae_tpu_torch`` against
``acvae_tpu``'s decode on the same weights and noise.

The port's seeded weights cross to JAX with ``acvae_to_flax`` (at Cnn10's
reference widths, whose block names it knows; mel 32 x 16, so that the
convs stay cheap), and the exported program is fed the noise JAX draws
from the same seed (``eps_stack`` of the model's ``make_rng("sample")``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.quant as jquant
from acvae_tpu.export import build_decode_fn as j_build_decode_fn
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.models.common import eps_stack as j_eps_stack
from acvae_tpu.train.pretrained import acvae_to_flax, merge_pretrained
from acvae_tpu_torch import export as texport
from acvae_tpu_torch.cli.main import main
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import quant_from_flax
from acvae_tpu_torch.data.vocab import Vocabulary as PortVocabulary
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.train.checkpoints import save_experiment
from tests.test_torch_decode import (E, FDIM, SMALL, V,  # noqa: F401
                                     one_torch_thread)
from tests.test_torch_quant import jax_baked
from tests.test_torch_serve import jax_vocab

MAXLEN, TMEL = 6, 32


def _batch(n, seed=9):
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(size=(n, TMEL, FDIM)).astype(np.float32))
    return feats, torch.tensor([TMEL, 20, 17][:n], dtype=torch.int32)


@pytest.fixture(scope="module")
def reference_width(tmp_path_factory):
    """A Hybrid AC-VAE with Cnn10 at 64-128-256-512 channels: the port's
    seeded weights carried to JAX with ``acvae_to_flax`` (every leaf
    loaded), and the port experiment exported f32 and int8 (v2sym)."""
    conf = flagship_conf(**dict(SMALL, encoder_args={"embed_size": 512}))
    torch.manual_seed(0)
    port = build_model(conf, V, FDIM, device="cpu").eval()
    rng = np.random.default_rng(2)
    for name, buf in port.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.tensor(rng.normal(0, 0.3, buf.shape)))
        elif name.endswith("running_var"):
            buf.copy_(torch.tensor(rng.uniform(0.5, 2.0, buf.shape)))
    port.encoder.stem_pad_lanes.zero_()   # acvae_to_flax pads with zeros
    jmodel = j_build_model(conf, V, FDIM)
    feats, lens = _batch(2)
    template = jax.jit(lambda k: jmodel.init(
        {"params": k, "sample": k}, feats.numpy(), lens.numpy(),
        np.full((2, 6), 4, np.int32), np.array([6, 4]), train=False))(
            jax.random.key(0))
    tree = acvae_to_flax(port.state_dict(), conf, log=lambda *a: None)
    variables = {}
    for coll in ("params", "batch_stats"):
        variables[coll], n, total = merge_pretrained(
            template[coll], tree[coll], log=lambda *a: None)
        assert n == total, f"{coll}: {n}/{total} leaves carried"
    root = tmp_path_factory.mktemp("reference_width")
    exp = str(root / "exp")
    jax_vocab().save(str(root / "vocab.pkl"))
    save_experiment(exp, port, conf, PortVocabulary.load(str(root / "vocab.pkl")))
    out = main(["export_model", exp, "--device=cpu", f"--max_length={MAXLEN}",
                f"--t_mel={TMEL}", f"--output_dir={root / 'f32'}"])
    return conf, port, jmodel, variables, out


def _jax_beam_eps(jmodel, variables, seed, rows):
    """The beam's prior noise JAX draws from ``seed`` (vae.py:449)."""
    rk = jmodel.apply(variables, rngs={"sample": jax.random.key(jnp.uint32(seed))},
                      method=lambda m: m.make_rng("sample"))
    return torch.tensor(np.asarray(j_eps_stack(rk, MAXLEN, rows, E)))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_exported_beam_matches_jax(reference_width, int8):
    """The exported beam decode fed JAX's draws gives JAX's tokens: f32
    against ``build_decode_fn``; int8 against ``int8_decode_fn`` (the path
    of ``tests/test_cli.py::test_export_model_int8_roundtrip``), the port's
    program exported on JAX's bake carried across."""
    conf, port, jmodel, variables, out = reference_width
    feats, lens = _batch(3)
    seed = 9
    eps = _jax_beam_eps(jmodel, variables, seed, 3 * 3)
    kw = dict(decode_method="beam", beam_size=3, max_length=MAXLEN)
    if int8:
        jq = jquant.quant_encoder_for(conf, jmodel, variables["params"],
                                      variables["batch_stats"],
                                      **jquant.scheme_kwargs("v2sym"))
        want = jquant.int8_decode_fn(jmodel, jq, **kw)(
            variables, feats.numpy(), lens.numpy(),
            jax.random.key(jnp.uint32(seed)))
        fn = texport.build_decode_fn_int8(
            port, quant_from_flax(jax_baked(jq), device="cpu"), **kw)
        ep, desc = texport.export_decode(fn, TMEL, FDIM)
        assert desc == "symbolic"
        with torch.inference_mode():
            got = ep.module()(feats, lens, eps)
    else:
        want = jax.jit(j_build_decode_fn(jmodel, variables, **kw))(
            feats.numpy(), lens.numpy(), jnp.uint32(seed))
        decode, _ = texport.load_exported(out, "cpu")
        got = decode.program(feats, lens, eps)
    np.testing.assert_array_equal(got["seqs"].numpy(), np.asarray(want["seqs"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-5, atol=1e-5)
