"""The plain reference against the port at test widths on the CPU (the
port's kernels run their plain versions there): the int8 encoder through
the port's operators, the bf16 encoders (Cnn14 with its adapter too), one
decode step's logits, the beam search, and three train steps."""
from __future__ import annotations

import copy

import torch

from conftest import REPO, TINY_SEED, tiny_conf, tiny_mix
from portbench import common
from portbench.reference import int8 as ref_int8
from portbench.reference import model as ref
from portbench.reference.params import make_weights

CONF = tiny_conf(common.load_json(REPO / "portbench/configs/acvae_cnn10.json"))


def _inputs(n=3, t=64, f=16, seed=5):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([t, t - 16, t // 2 + 3][:n])
    return common.log_mels(g, n, t, f, lens, "cpu"), lens


def _rel(a, b):
    return float(((a.float() - b.float()).flatten(1).norm(dim=1)
                  / b.float().flatten(1).norm(dim=1)).max())


def _model(conf=CONF, seed=TINY_SEED):
    sd = make_weights(conf, seed, "cpu")
    return sd, common.build_port_model(conf, sd, "cpu")


def test_int8_encoder_matches_the_ports_operators():
    from acvae_tpu_torch.models.quant import quant_encoder_for, scheme_kwargs
    sd, model = _model()
    feats, lens = _inputs()
    quant = quant_encoder_for(common.port_conf(CONF), model, **scheme_kwargs("v2sym"))
    with torch.inference_mode():
        port = quant(feats, lens)["audio_embeds"]
    mine = ref_int8.encode(ref_int8.calibrate(sd, "Cnn10"), sd, feats, lens)["audio_embeds"]
    assert port.shape == mine.shape
    assert _rel(port, mine) <= 1e-6
    low = ref_int8.encode(ref_int8.calibrate(sd, "Cnn10", q=7), sd, feats, lens)
    assert _rel(low["audio_embeds"], mine) > 1e-2     # int4 is another encoder


def test_bf16_encoders_match_the_port():
    sd, model = _model()
    feats, lens = _inputs()
    with torch.inference_mode():
        port = model.encode(feats, lens)
    mine = ref.pann_encoder(sd, feats, lens, "Cnn10")
    assert torch.equal(port["audio_embeds_lens"], mine["audio_embeds_lens"])
    assert _rel(port["audio_embeds"], mine["audio_embeds"]) <= 1e-3
    conf = copy.deepcopy(CONF)
    conf.update(encodermodel="Cnn14", data_dim=64)
    conf["encoder_args"] = {"embed_size": 2048, "dtype": "bfloat16"}
    sd, model = _model(conf)
    feats, lens = _inputs(n=2, f=64)
    with torch.inference_mode():
        port = model.encode(feats, lens)
    mine = ref.pann_encoder(sd, feats, lens, "Cnn14")
    assert port["audio_embeds"].shape == mine["audio_embeds"].shape == (2, 2, 16)
    assert _rel(port["audio_embeds"], mine["audio_embeds"]) <= 1e-3


def test_one_decode_step_matches_the_port():
    sd, model = _model()
    feats, lens = _inputs()
    with torch.inference_mode():
        enc = model.encode(feats, lens)
        ctx = model.decode_ctx(enc)
        state = model.init_decode_state(3, "cpu")
        words = torch.tensor([1, 7, 29])
        eps = torch.randn((2, 3, 16), generator=torch.Generator().manual_seed(3))
        mine_ctx = ref.Ctx(sd, enc["audio_embeds"], enc["audio_embeds_lens"])
        mine_state = ref.init_state(sd, 3, "cpu")
        for t in range(2):
            lp, state = model.decode_step_api(ctx, state, words, eps[t])
            lr, mine_state = ref.step(sd, mine_ctx, words, mine_state, eps[t])
            a, b = torch.log_softmax(lp, -1), torch.log_softmax(lr, -1)
            assert float((a - b).abs().max()) <= 1e-5
            words = torch.argmax(b, -1)


def test_the_beam_search_matches_the_port():
    sd, model = _model()
    feats, lens = _inputs()
    eps = torch.randn((5, 9, 16), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        enc = model.encode(feats, lens)
        port = model.inference_from_encoded(enc, decode_method="beam", beam_size=3,
                                            max_length=5, eps=eps)
    mine = ref.beam_search(sd, enc["audio_embeds"], enc["audio_embeds_lens"], eps, 3, 5)
    assert torch.equal(port["seqs"], mine["seqs"])
    torch.testing.assert_close(port["scores"], mine["scores"], rtol=1e-5, atol=0)
    low = ref.beam_search(sd, enc["audio_embeds"], enc["audio_embeds_lens"], eps, 3, 5,
                          "tf32")
    assert not torch.equal(low["scores"], mine["scores"])


def test_three_train_steps_match_the_port():
    mix = tiny_mix(common.load_json(REPO / "portbench/mixes/train_b128.json"))
    drv = common.load_module(REPO / "portbench/drivers/train.py")
    cell = drv.Cell(CONF, mix, TINY_SEED, "cpu")
    cell.setup()
    cell.window(0.0)                        # runs on to the checked window step
    got = cell.judge(cell.collect())
    for pre in ("", "win_"):
        assert got[pre + "loss_err"] <= 1e-6, got
        assert got[pre + "grad_err"] <= 1e-5, got
        assert got[pre + "update_err"] <= 1e-5, got
