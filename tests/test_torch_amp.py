"""Port parity: the bf16 decode (``acvae_tpu_torch/ops/amp.py`` and the
decode state that follows the parameter dtype) against ``acvae_tpu``.

JAX casts the whole variables tree but ``batch_stats`` and lets dtype
promotion carry the step; the port casts the model's parameters and follows
JAX's dtype op by op.  One step from the same bf16 state is held to
``max|Δlogit| <= 3e-2 · max|logit|`` (bf16 keeps 8 bits of mantissa, and
the two libraries round the matmuls' and the softmaxes' accumulations
differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.ops.amp import cast_floats_for_decode as j_cast
from acvae_tpu.ops.amp import resolve_decode_dtype as j_resolve
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.ops.amp import cast_floats_for_decode, resolve_decode_dtype
from tests.test_torch_decode import (SMALL, E, T, V, mels,  # noqa: F401
                                     one_torch_thread, port_model,
                                     small_jax_model)


def test_cast_keeps_batchnorm_statistics_f32():
    conf, _, variables = small_jax_model()
    port = port_model(conf, variables)
    cast = cast_floats_for_decode(port, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    stats = {n: b for n, b in cast.named_buffers() if "running" in n}
    assert stats and all(b.dtype == torch.float32 for b in stats.values())
    # the model cast from is left as it was
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert cast.decoder.state_dtype() == torch.bfloat16
    assert port.decoder.state_dtype() == torch.float32
    # JAX's cast: the same split
    jv = j_cast(variables, jnp.bfloat16)
    assert all(x.dtype == jnp.bfloat16
               for x in jax.tree_util.tree_leaves(jv["params"]))
    assert all(x.dtype == jnp.float32
               for x in jax.tree_util.tree_leaves(jv["batch_stats"]))


def test_resolve_decode_dtype_matches_jax(monkeypatch):
    monkeypatch.delenv("ACVAE_DECODE_DTYPE", raising=False)
    for v in (None, "", "float32"):
        assert resolve_decode_dtype(v) is None and j_resolve(v) is None
    assert resolve_decode_dtype("bfloat16") == torch.bfloat16
    assert j_resolve("bfloat16") == jnp.bfloat16
    monkeypatch.setenv("ACVAE_DECODE_DTYPE", "bfloat16")
    assert resolve_decode_dtype(None) == torch.bfloat16
    assert resolve_decode_dtype("float32") is None
    with pytest.raises(ValueError, match="float dtype"):
        resolve_decode_dtype("int8")


def _bf16_models(enc_dtype):
    enc = dict(SMALL["encoder_args"], **({"dtype": enc_dtype} if enc_dtype else {}))
    _, _, variables = small_jax_model()
    conf = flagship_conf(**dict(SMALL, encoder_args=enc))
    model = j_build_model(conf, V, SMALL["data_dim"])
    port = cast_floats_for_decode(port_model(conf, variables), torch.bfloat16)
    return model, j_cast(variables, jnp.bfloat16), port


@pytest.mark.parametrize("enc_dtype", [None, "bfloat16"], ids=["f32enc", "bf16enc"])
def test_bf16_decode_step_matches_jax(enc_dtype):
    """Encoder, decode context and one decode_step_api step from the same
    non-zero bf16 state, on the JAX side and the port's."""
    model, jv, port = _bf16_models(enc_dtype)
    feats, lens = mels(3)
    rng = np.random.default_rng(4)
    state = [rng.normal(size=(3, E)).astype(np.float32) for _ in range(4)]
    words = np.array([1, 7, 12], np.int32)
    eps_t = rng.normal(size=(3, E)).astype(np.float32)

    def jstate(a):
        return jnp.asarray(a).astype(jnp.bfloat16)
    enc = model.apply(jv, feats, lens, train=False, method=model.encode)
    ctx = model.apply(jv, enc, method=model.decode_ctx)
    js = (jstate(state[0]), (jstate(state[1]), jstate(state[2])), jstate(state[3]))
    ref, _ = model.apply(jv, ctx, js, jnp.asarray(words), jstate(eps_t),
                         method=model.decode_step_api)
    assert ref.dtype == jnp.bfloat16

    def tstate(a):
        return torch.tensor(a).to(torch.bfloat16)
    with torch.inference_mode():
        tctx = port.decode_ctx(port.encode(torch.tensor(feats), torch.tensor(lens)))
        ts = (tstate(state[0]), (tstate(state[1]), tstate(state[2])),
              tstate(state[3]))
        out, new = port.decode_step_api(tctx, ts, torch.tensor(words).long(),
                                        tstate(eps_t))
    assert out.dtype == torch.bfloat16 and new[0].dtype == torch.bfloat16
    assert tctx[0].dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref32).max()
    assert err <= 3e-2 * np.abs(ref32).max(), err


def test_bf16_beam_decode_runs_in_bf16():
    """A whole bf16 beam decode: the state stays bf16, the scores are
    float32 and finite."""
    model, jv, port = _bf16_models(None)
    feats, lens = (torch.tensor(a) for a in mels(2))
    eps = torch.randn((T, 6, E), generator=torch.Generator().manual_seed(2))
    out = port.inference_forward(feats, lens, decode_method="beam", beam_size=3,
                                 max_length=T, eps=eps)
    assert out["scores"].dtype == torch.float32
    assert torch.isfinite(out["scores"]).all()
    assert ((out["seqs"] >= 0) & (out["seqs"] < V)).all()
    state = port.init_decode_state(6)
    assert all(s.dtype == torch.bfloat16 for s in (state[0], *state[1], state[2]))
