"""The serving driver (``drivers/serve_offline.py``) at test widths on the
CPU: its model hooks give what the flagship's reference gives when called
directly, and the clips it judges are drawn from the seed alone, whatever
the window's length."""
from __future__ import annotations

import types

import pytest
import torch

from conftest import REPO, TINY_SEED, tiny_conf, tiny_mix
from portbench import common
from portbench.reference import int8 as ref_int8
from portbench.reference import model as ref_model
from portbench.reference.params import make_weights

CONF = tiny_conf(common.load_json(REPO / "portbench/configs/acvae_cnn10.json"))


def _cell(traffic):
    mix = tiny_mix(common.load_json(REPO / f"portbench/mixes/{traffic}.json"))
    mod = common.load_module(REPO / "portbench/drivers/serve_offline.py")
    return mod, mod.Cell(CONF, mix, TINY_SEED, "cpu")


@pytest.mark.parametrize("traffic", ["serve_int8_b512", "serve_bf16_b512"])
def test_the_flagships_hooks_are_the_reference_called_directly(traffic):
    _, cell = _cell(traffic)
    arch, mix = CONF["encodermodel"], cell.mix
    sd = make_weights(CONF, common.seed_of(TINY_SEED, 1), "cpu")
    got = cell.weights()
    assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    cell.sd = got
    g = torch.Generator().manual_seed(7)
    lens = torch.tensor([64, 40, 33])
    s = {"feats": common.log_mels(g, 3, 64, CONF["data_dim"], lens, "cpu"), "lens": lens}
    for control in (False, True):
        enc, enc_lens = cell.ref_encode(s, control=control)
        if cell.int8:
            baked = (ref_int8.calibrate(sd, arch, q=7) if control
                     else ref_int8.calibrate(sd, arch))
            want = ref_int8.encode(baked, sd, s["feats"], lens, block=64)
        else:
            want = ref_model.pann_encoder(sd, s["feats"], lens, arch, conv_fp8=control)
        assert torch.equal(enc, want["audio_embeds"].float())
        assert torch.equal(enc_lens, want["audio_embeds_lens"])
        eps = torch.randn((mix["max_length"], 3 * mix["beam_size"], CONF["decoder_args"]
                           ["embed_size"]), generator=g)
        beams = cell.ref_beam_search(enc, enc_lens, eps, control=control)
        want = ref_model.beam_search(sd, enc, enc_lens, eps, mix["beam_size"],
                                     mix["max_length"], "tf32" if control else "f32")
        assert torch.equal(beams["seqs"], want["seqs"])
        assert torch.equal(beams["scores"], want["scores"])


def _after_window(units):
    """A cell whose window served ``units`` batches: its window runs on a
    clock that reads one second later at each look."""
    mod, cell = _cell("serve_int8_b512")
    ticks = iter(range(10**6))
    mod.time = types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))
    cell.setup()
    res = cell.window(2.0 * units)          # each batch is two looks at the clock
    assert res["units"] == units
    return cell, cell.judged(), cell.collect()


def test_the_judged_clips_are_drawn_from_the_seed_alone():
    short, (pools2, batch2), s2 = _after_window(2)
    _, (pools6, batch6), s6 = _after_window(6)
    P, N = short.mix["pool_batches"], short.mix["batch"]
    assert len(pools2) == N and torch.equal(torch.as_tensor(pools2), torch.as_tensor(pools6))
    for batch, units in ((batch2, 2), (batch6, 6)):
        assert ((batch % P) == pools2).all() and (batch < units).all()
    assert (batch6 >= P).any()      # the longer window's later repeats are judged
    for k in ("feats", "lens", "eps", "enc"):
        assert torch.equal(s2[k], s6[k]), k
    assert s2["feats"].shape[0] == N          # one clip for every row of the batch
