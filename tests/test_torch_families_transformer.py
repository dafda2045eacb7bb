"""Port parity: the transformer pieces and families of ``acvae_tpu_torch``
(``MultiheadAttention``, ``TransformerDecoder``, ``VAETransformerDecoder``,
``TransVAEModel``, ``TransformerModel``) against ``acvae_tpu``.

The families run at the sizes and under the noise protocol of
``tests/test_torch_families_rnn.py`` (2 layers, 2 heads, FFN 32, decoder
embed 16, or 12 behind the ``ln`` adapter).  Tolerances: module outputs
atol 1e-5; train-forward arrays, loss and KL rtol 1e-4 (atol 1e-5); decode
tokens identical; ``forced_decode`` log-probs atol 1e-5; parameters after
one ``Trainer.step`` atol 1e-5.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.quant as jquant
import acvae_tpu_torch.models.quant as tquant
import acvae_tpu_torch.models.trans_vae as ttrans
from acvae_tpu.models.decoders import TransformerDecoder as JTransformerDecoder
from acvae_tpu.models.decoders import VAETransformerDecoder as JVAETransformerDecoder
from acvae_tpu.models.decoders import sinusoidal_pe as j_sinusoidal_pe
from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.decoding.ensemble import ensemble_decode
from acvae_tpu_torch.models.decoders import (MultiheadAttention,
                                             TransformerDecoder,
                                             VAETransformerDecoder,
                                             sinusoidal_pe)
from acvae_tpu_torch.ops.amp import cast_floats_for_decode
from tests.test_torch_families_rnn import (  # noqa: F401
    E, E_LN, N, T, V, check_dbs, check_decodes, check_train_forward,
    check_train_step, fixed_eps, get_pair, mels, no_jax_dropout,
    one_torch_thread, pairs)

FAMILIES = ("trans_vae", "xe_baseline")


def test_multihead_attention_matches_flax():
    """The joined in_proj_weight gives flax's MultiHeadDotProductAttention
    output (per-head layout pinned); a row with no valid key gives the
    uniform weights flax gives, not NaN."""
    rng = np.random.default_rng(0)
    D, H, Tq, S = 8, 2, 5, 6
    q = rng.normal(size=(2, Tq, D)).astype(np.float32)
    kv = rng.normal(size=(2, S, D)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, Tq, S)) < 0.6
    mask[0, 0, 2] = False                       # no valid key in this row
    att = fnn.MultiHeadDotProductAttention(num_heads=H, qkv_features=D)
    variables = jax.tree_util.tree_map(
        np.asarray, att.init(jax.random.key(0), q, kv, mask=mask))
    ref = np.asarray(att.apply(variables, q, kv, mask=mask))
    port = MultiheadAttention(D, H)
    # from_flax reads an attention by its layer's name ("self_attn", ...)
    sd = from_flax({"params": {"self_attn": variables["params"]}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        out = port(torch.tensor(q), torch.tensor(kv), torch.tensor(mask[:, 0]))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # head h reads rows h·D/H..(h+1)·D/H of each of q, k, v
    k0 = variables["params"]["query"]["kernel"][:, 0]
    np.testing.assert_array_equal(port.in_proj_weight[:D // H].detach().numpy(),
                                  k0.T)


def test_sinusoidal_pe_matches_jax():
    np.testing.assert_allclose(sinusoidal_pe(30, 16).numpy(),
                               np.asarray(j_sinusoidal_pe(30, 16)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "vae"])
def test_transformer_decoders_match_jax(kind):
    """Both decoders on a padded batch at every position (relu and tanh-GELU,
    LayerNorm eps 1e-6); the VAE one with latents appended to the memory."""
    rng = np.random.default_rng(1)
    D, Tw, S = 12, 6, 5
    words = rng.integers(0, V, size=(3, Tw)).astype(np.int32)
    mem = rng.normal(size=(3, S, D)).astype(np.float32)
    mem_lens = np.array([5, 3, 1], np.int32)
    pad = np.arange(Tw)[None] >= np.array([[6], [4], [2]])
    z = rng.normal(size=(3, Tw, D)).astype(np.float32)
    kw = dict(vocab_size=V, enc_mem_size=D, embed_size=D, nhead=2, nlayers=2,
              hidden_size=20, dropout=0.0)
    if kind == "vae":
        jdec, args = JVAETransformerDecoder(**kw), (words, mem, mem_lens, pad, z)
        port = VAETransformerDecoder(device="cpu", **kw)
        jkw, pkw = {"last_only": False}, {"at": None}
    else:
        jdec, args = JTransformerDecoder(**kw), (words, mem, mem_lens, pad)
        port = TransformerDecoder(device="cpu", **kw)
        jkw, pkw = {}, {}
    variables = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.key(0), *args, **jkw))
    ref = jdec.apply(variables, *args, **jkw)
    port.load_state_dict(from_flax(variables), strict=True)
    with torch.no_grad():
        out = port(*(torch.tensor(a) for a in args), **pkw)
    for k in ("output", "logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dec_embed,ss_ratio,dis_ratio",
                         [(E, 1.0, 0.0), (E_LN, 0.0, 1.0)],
                         ids=["teacher", "feedback-ln"])
@pytest.mark.parametrize("recipe", FAMILIES)
def test_train_forward_matches_jax(pairs, recipe, dec_embed, ss_ratio, dis_ratio):
    check_train_forward(pairs, recipe, dec_embed, ss_ratio, dis_ratio)


@pytest.mark.parametrize("recipe", FAMILIES)
def test_train_step_matches_jax(pairs, recipe):
    metrics = check_train_step(pairs, recipe)
    assert ("kl" in metrics) == (recipe == "trans_vae")


@pytest.mark.parametrize("recipe", FAMILIES)
def test_decodes_match_jax(pairs, fixed_eps, recipe):
    check_decodes(get_pair(pairs, recipe, E_LN))


@pytest.mark.parametrize("recipe", FAMILIES)
def test_dbs_matches_jax(pairs, recipe):
    check_dbs(get_pair(pairs, recipe, E_LN))


def test_trans_vae_dbs_positions_and_noise(pairs, monkeypatch):
    """Group g writes its buffers at the local positions 0..T-1 (global
    step t - g) and reads the prior noise of the global step: noise moved
    only where no group is active leaves the decode as it was; noise moved
    at eps[1, 1], group 1's first step, changes group 1 alone."""
    port = get_pair(pairs, "trans_vae", E_LN).port
    feats, lens = (torch.tensor(a) for a in mels(2))
    case = dict(beam_size=4, group_size=2, diversity_lambda=0.5)
    eps = torch.randn((2, T + 1, 4, E_LN),
                      generator=torch.Generator().manual_seed(1))
    written = []
    real_write = ttrans.TransVAECaptionModel._write
    monkeypatch.setattr(ttrans.TransVAECaptionModel, "_write", staticmethod(
        lambda wb, zb, pos, w, z: written.append(pos) or real_write(wb, zb, pos,
                                                                    w, z)))

    def run(e):
        return port.inference_forward(feats, lens, decode_method="dbs",
                                      max_length=T, eps=e, **case)["seqs"]
    base = run(eps)
    # the engine steps group 0 then group 1 at each global step t
    assert written == [t - g for t in range(T + 1) for g in (0, 1)
                       if 0 <= t - g < T]
    idle = eps.clone()
    idle[1, 0] += 5.0        # group 1 is not active at global step 0
    idle[0, T] += 5.0        # group 0 has ended at global step T
    assert torch.equal(run(idle), base)
    moved = eps.clone()
    moved[1, 1] += 5.0
    other = run(moved)
    assert torch.equal(other[:, :2], base[:, :2])
    assert not torch.equal(other[:, 2:], base[:, 2:])


@pytest.mark.parametrize("recipe", FAMILIES)
def test_ensemble_and_int8_refuse_what_jax_refuses(pairs, recipe):
    """Neither family has the step-decode API nor inference_from_encoded:
    the ensemble and the int8 encoder raise with JAX's meaning."""
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


@pytest.mark.parametrize("recipe", FAMILIES)
def test_bf16_decode_runs(pairs, recipe):
    """As JAX's tests/test_amp.py for these families: beam and greedy in
    bf16, the decode's dtype bf16."""
    m = cast_floats_for_decode(get_pair(pairs, recipe, E_LN).port,
                               torch.bfloat16)
    assert m.decoder.state_dtype() == torch.bfloat16
    feats, lens = (torch.tensor(x) for x in mels())
    for method in ("beam", "greedy"):
        seqs = m.inference_forward(feats, lens, decode_method=method,
                                   max_length=6)["seqs"]
        assert ((seqs >= 0) & (seqs < V)).all()
