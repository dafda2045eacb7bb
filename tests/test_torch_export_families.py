"""Port parity: ``export.py`` over the model families and decode methods
that the Hybrid AC-VAE's artifacts (``tests/test_torch_export.py``) do not
reach: SimpleVAE's one global z a caption (beam, dbs), a plain captioner
that draws nothing (greedy), the Gumbel input of ``sample`` and
``gumbel`` (VAE, GMM VAE, the XE transformer) and TransVAE's beam.

Each model is its recipe in ``configs/`` at the size of
``tests/test_torch_families_rnn.py``, seeded weights, a 2-step decode.
Its artifact is saved, loaded with ``load_exported`` and run at batch 3
(the trace used 2, so the batch stayed symbolic) on noise drawn from the
meta's shapes; the tokens and scores must equal the eager
``inference_forward``'s on the same noise.
"""
import numpy as np
import pytest
import torch

from acvae_tpu_torch import export as texport
from acvae_tpu_torch.models.build import build_model
from tests.test_torch_decode import one_torch_thread  # noqa: F401
from tests.test_torch_families_rnn import FDIM, TMEL, V, small_conf

MAXLEN = 2
CASES = {
    "simple_vae_beam": ("simple_vae", dict(decode_method="beam", beam_size=3)),
    "simple_vae_dbs": ("simple_vae", dict(decode_method="dbs", beam_size=4,
                                          group_size=2)),
    "attn_rnn_xe_greedy": ("attn_rnn_xe", dict(decode_method="greedy")),
    "vae_sample": ("vae", dict(decode_method="sample")),
    "gmm_vae_gumbel": ("gmm_vae", dict(decode_method="gumbel")),
    "trans_vae_beam": ("trans_vae", dict(decode_method="beam", beam_size=3)),
    "xe_baseline_sample": ("xe_baseline", dict(decode_method="sample")),
}
# the noise inputs each case's decode takes (names, in the program's order)
NOISE = {"attn_rnn_xe_greedy": [], "xe_baseline_sample": ["gumbel"],
         "vae_sample": ["eps", "gumbel"], "gmm_vae_gumbel": ["eps", "gumbel"]}


@pytest.mark.parametrize("case", list(CASES))
def test_family_export_round_trip(case, tmp_path):
    recipe, kw = CASES[case]
    kw = dict(kw, max_length=MAXLEN)
    torch.manual_seed(0)
    model = build_model(small_conf(recipe, port=True), V, FDIM,
                        device="cpu").eval()
    fn = texport.build_decode_fn(model, **kw)
    ep, batch = texport.export_decode(fn, TMEL, FDIM)
    assert batch == "symbolic"
    texport.save_exported(ep, str(tmp_path), {"batch": batch, "noise": fn.noise,
                                              "t_mel": TMEL, "n_mels": FDIM})
    decode, meta = texport.load_exported(str(tmp_path), "cpu")
    assert [e["name"] for e in meta["noise"]] == NOISE.get(case, ["eps"])
    rng = np.random.default_rng(1)
    feats = torch.tensor(rng.normal(size=(3, TMEL, FDIM)).astype(np.float32))
    lens = torch.tensor([TMEL, 40, 33], dtype=torch.int32)
    noise = decode.noise(3, seed=5)
    for entry, t in zip(meta["noise"], noise):
        want = list(entry["shape"])
        want[entry["batch_axis"]] *= 3
        assert list(t.shape) == want, entry
    got = decode.program(feats, lens, *noise)
    with torch.inference_mode():
        eager = model.inference_forward(
            feats, lens, **kw, **{e["name"]: t for e, t in zip(meta["noise"],
                                                                noise)})
    assert set(got) == {"seqs", "scores"} & set(eager)
    for k in got:
        assert torch.equal(got[k], eager[k]), k
