"""Port parity: sequence parallelism for the encoders beyond the PANN family
and the double-conv trunks (``models/encoders.py``), against the JAX
encoders, and the widened halo exchange (``parallel/collectives.py``).

Each encoder at ``tests/test_encoders.py``'s widths (narrow where the class
takes widths, two layers for the transformers) runs its train-mode forward
and a backward on the 2 data x 2 model gloo ranks of a pool of its own,
time split over the model ranks, against the JAX encoder's forward and
``jax.vjp`` on the same weights (``tests/test_torch_parallel.py::
check_split_matches_jax``): outputs at rtol 1e-5 / atol 1e-4, BatchNorm's
running statistics at 1e-5, the summed gradients per tensor within
``SPLIT_GRAD_REL`` of JAX's in norm.  ResNetEncoder at T = 80 (not a
multiple of its 32 x 2 frames) and RNNEncoder run whole clips.  Two planted
faults fall outside the gradient check: ResNetEncoder's halo backward
dropped, and TransformerEncoder's keys and values gathered with
``gather_replicated`` (each frame's gradient from its own rank's queries
only).
"""
import jax
import numpy as np
import pytest
import torch

from acvae_tpu_torch.convert import from_flax
from acvae_tpu_torch.parallel.parity import halo_case
from tests.test_torch_encoders import _init as _jax_encoder_init
from tests.test_torch_parallel import (check_split_matches_jax,  # noqa: F401
                                       no_jax_dropout, pool)

SUB = {"embed_size": 16, "channels": (4, 8, 8, 16)}
ATTN = {"embed_size": 16, "nhead": 2, "nlayers": 2, "dim_feedforward": 32}
# (encoder, args, T, split, planted faults); RNNEncoder's pooled vector is
# a train-mode BatchNorm's output, on 4 clips (over 2 its rows normalize to
# +-1 whatever their input, which leaves its input only eps's gradient), and
# the bias of the Dense before it has no gradient in exact arithmetic
CASES = {
    "CNN10Encoder": ("CNN10Encoder", {"embed_size": 512}, 64, True, ()),
    "CRNNEncoder": ("CRNNEncoder", {"embed_size": 256}, 64, True, ()),
    "E2EASREncoder": ("E2EASREncoder", {"embed_size": 24, "hidden_size": 16,
                                        "nlayers": 1}, 64, True, ()),
    "CNNEncoder": ("CNNEncoder", {"embed_size": 16}, 64, True, ()),
    "ResNetEncoder": ("ResNetEncoder", SUB, 64, True, ("halo_dropped",)),
    "TransformerEncoder": ("TransformerEncoder", dict(ATTN, dropout=0.0), 64,
                           True, ("kv_replicated",)),
    "M2TransformerEncoder": ("M2TransformerEncoder",
                             dict(ATTN, memory_slots=5), 64, True, ()),
    "PreTrainedCNN": ("PreTrainedCNN", {"trunk": dict(SUB, name="CNN10QEncoder"),
                                        "embed_size": 8, "freeze": False},
                      64, True, ()),
    "CNN10CRNNEncoder": ("CNN10CRNNEncoder",
                         {"crnn": dict(SUB, name="CRNN8_Sub4"),
                          "cnn": dict(SUB, name="CNN10QEncoder")}, 64, True, ()),
    "ResNetEncoder_whole_clips": ("ResNetEncoder", SUB, 80, False, ()),
    "RNNEncoder_whole_clips": ("RNNEncoder", {"embed_size": 12,
                                              "hidden_size": 8}, 64, False, ()),
}


@pytest.fixture(scope="module")
def split_encoders(tmp_path_factory):
    """Per encoder: the JAX module and variables (initialised once, every
    norm's scale and bias drawn away from (1, 0)), the port's weights
    written to a file for the ranks.  A BatchNorm whose output reaches the
    next one through convs, relus and LP pools alone sees its scale
    normalized away with a zero bias, so its scale's gradient is all
    rounding (JAX's own float32 gradient there reads 1% off its float64
    one); a drawn bias gives it a gradient to hold."""
    out, cache = tmp_path_factory.mktemp("split_enc"), {}

    def get(name, args):
        if name not in cache:
            enc, v = _jax_encoder_init(name, args)
            rng = np.random.default_rng(11)

            def draw(tree):
                for k, sub in tree.items():
                    if isinstance(sub, dict) and "scale" in sub:
                        sub["scale"][...] = rng.uniform(0.5, 2.0, sub["scale"].shape)
                        sub["bias"][...] = rng.normal(0, 0.3, sub["bias"].shape)
                    elif isinstance(sub, dict):
                        draw(sub)
            v = jax.tree_util.tree_map(np.array, v)
            draw(v["params"])
            path = str(out / f"{name}.pt")
            torch.save(from_flax(v), path)
            cache[name] = enc, v, path
        return cache[name]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_split_encoder_matches_jax(pool, split_encoders, case):
    """The split train forward and backward against JAX's; the planted
    faults fail the gradient check."""
    name, args, T, split, faults = CASES[case]
    rnn = name == "RNNEncoder"
    check_split_matches_jax(pool, split_encoders, name, args, T, split,
                            faults, rows=4 if rnn else 2,
                            zero_grads=("outputlayer.bias",) if rnn else ())


@pytest.mark.parametrize("model,prev,nxt", [(2, 2, 2), (2, 3, 2), (4, 2, 2),
                                            (4, 3, 2), (4, 1, 0)])
def test_halo_matches_slicing(pool, model, prev, nxt):
    """Halos of ``prev`` frames before and ``nxt`` after each shard of 4
    frames: the neighbours' frames (the fill at the outer edges), and the
    backward of every halo back on the frames they came from."""
    rng = np.random.default_rng(prev * 10 + nxt)
    N, C, T, F = 2, 3, 4 * model, 5
    x = rng.normal(size=(N, C, T, F)).astype(np.float32)
    pp = rng.normal(size=(model, N, C, prev, F)).astype(np.float32)
    pn = rng.normal(size=(model, N, C, nxt, F)).astype(np.float32)
    ranks = pool.run(halo_case, x, prev, nxt, pp, pn, model_parallel=model)
    t = T // model
    # the whole clip padded by the fill: a shard's halos are its slices
    padded = np.pad(x, ((0, 0), (0, 0), (prev, nxt), (0, 0)),
                    constant_values=-1.0)
    grad = np.zeros((N, C, T + prev + nxt, F), np.float32)
    for m in range(model):
        lo = m * t + prev   # the shard's first frame in ``padded``
        grad[:, :, lo - prev:lo] += pp[m]
        grad[:, :, lo + t:lo + t + nxt] += pn[m]
    grad = grad[:, :, prev:prev + T]
    for r in ranks:
        m, lo = r["m"], r["m"] * t + prev
        np.testing.assert_array_equal(r["before"].numpy(),
                                      padded[:, :, lo - prev:lo])
        np.testing.assert_array_equal(r["after"].numpy(),
                                      padded[:, :, lo + t:lo + t + nxt])
        np.testing.assert_allclose(r["grad"].numpy(),
                                   grad[:, :, m * t:(m + 1) * t], rtol=1e-6,
                                   atol=1e-6)
