"""Port parity: the deployment surface of ``acvae_tpu_torch``
(``export.py``, ``cli export_model``, the int8 kernels as operators): the
f32 beam, greedy and dbs artifacts against the eager decode.
``tests/test_torch_export_serve.py`` covers the bf16 and int8 artifacts and
``cli serve --exported``, ``tests/test_torch_export_jax.py`` the tokens
against JAX's.

Each artifact is exported once per module through the port's CLI on the
CPU, from a tiny Hybrid AC-VAE experiment, with a 3-step decode (the
export traces every step).  An exported program takes its noise as
tensors, so the eager decode and the program are fed the same draws and
must give the same tokens.
"""
import os

import numpy as np
import pytest
import torch

from acvae_tpu_torch import export as texport
from acvae_tpu_torch.cli.main import main
from acvae_tpu_torch.data.vocab import Vocabulary as PortVocabulary
from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                          scheme_kwargs)
from acvae_tpu_torch.ops.amp import cast_floats_for_decode
from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (avgpool2x2_i8,
                                                     avgpool2x2_i8_op,
                                                     conv3x3_i8, conv3x3_i8_op,
                                                     pack_conv3x3_weight,
                                                     stem_conv3x3_i8,
                                                     stem_conv3x3_i8_op)
from acvae_tpu_torch.ops.int8 import avgpool2x2_i8_ref, conv3x3_i8_ref
from acvae_tpu_torch.train.checkpoints import save_experiment
from tests.test_torch_decode import (FDIM, TMEL, one_torch_thread,  # noqa: F401
                                     port_model, small_jax_model)
from tests.test_torch_int8_kernels import conv_case, stem_case, stem_plain
from tests.test_torch_serve import jax_vocab

MAXLEN = 3
# mode -> export_model flags and the eager decode's keyword arguments
MODES = {
    "beam": ([], dict(decode_method="beam", beam_size=3)),
    "greedy": (["--decode_method=greedy"], dict(decode_method="greedy")),
    "dbs": (["--decode_method=dbs", "--beam_size=4", "--group_size=2"],
            dict(decode_method="dbs", beam_size=4, group_size=2)),
    "beam_bf16": (["--decode_dtype=bfloat16"],
                  dict(decode_method="beam", beam_size=3)),
    "beam_int8": (["--encoder_int8"], dict(decode_method="beam", beam_size=3)),
}
F32_MODES = ("beam", "greedy", "dbs")


def export_tiny(tmp_path_factory, modes):
    """(conf, port model, experiment dir, {mode: artifact dir}): a tiny
    Hybrid AC-VAE experiment and its artifacts of ``modes``, each exported
    once through the CLI on the CPU."""
    conf, _, variables = small_jax_model(seed=4)
    model = port_model(conf, variables).eval()
    root = tmp_path_factory.mktemp("export")
    jax_vocab().save(str(root / "vocab.pkl"))
    exp = str(root / "exp")
    save_experiment(exp, model, conf, PortVocabulary.load(str(root / "vocab.pkl")))
    arts = {}
    for mode in modes:
        arts[mode] = main(["export_model", exp, "--device=cpu",
                           f"--max_length={MAXLEN}", f"--t_mel={TMEL}",
                           f"--output_dir={root / mode}", *MODES[mode][0]])
    return conf, model, exp, arts


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return export_tiny(tmp_path_factory, F32_MODES)


def _batch(n, seed=9):
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(size=(n, TMEL, FDIM)).astype(np.float32))
    return feats, torch.tensor([TMEL, 40, 33][:n], dtype=torch.int32)


def check_round_trip(tiny, mode):
    """The artifact's files and meta; at batches 2 and 3 the loaded
    program's tokens (and scores) equal the eager decode's on the same
    noise; one seed, one caption (two loads: the service test)."""
    conf, model, _, arts = tiny
    out = arts[mode]
    assert sorted(os.listdir(out)) == ["decode.pt2", "meta.json", "vocab.pkl"]
    decode, meta = texport.load_exported(out, "cpu")
    assert meta["batch"] == "symbolic" and meta["t_mel"] == TMEL
    assert meta["n_mels"] == FDIM and meta["platforms"] == ["cpu"]
    assert meta["artifact_bytes"] == os.path.getsize(os.path.join(out,
                                                                  "decode.pt2"))
    assert meta["encoder_int8"] == (mode == "beam_int8")
    assert meta["decode_dtype"] == ("bfloat16" if mode == "beam_bf16"
                                    else "float32")
    kw = dict(MODES[mode][1], max_length=MAXLEN)
    if mode == "beam_int8":
        eager = int8_decode_fn(model, quant_encoder_for(
            conf, model, **scheme_kwargs("v2sym")), **kw)
    else:
        m = cast_floats_for_decode(model, torch.bfloat16) \
            if mode == "beam_bf16" else model
        eager = lambda f, lens, **k: m.inference_forward(f, lens, **kw, **k)  # noqa: E731
    for n in (2, 3):
        feats, lens = _batch(n)
        noise = decode.noise(n, seed=7)
        got = decode.program(feats, lens, *noise)
        want = eager(feats, lens, eps=noise[0])
        assert set(got) == ({"seqs", "scores"} if "scores" in want else {"seqs"})
        for k in got:
            assert torch.equal(got[k], want[k]), (mode, n, k)
    assert torch.equal(decode(feats, lens, 11)["seqs"],
                       decode(feats, lens, 11)["seqs"])
    # the int8 program calls the kernels' operators, Cnn10's stem (its
    # quantization fused in), 7 body convs and 3 pools a batch; the others
    # Cnn10's 8 BatchNorm epilogues (ConvBlock at inference): on a card,
    # the hand-written kernels
    targets = [str(n.target) for n in decode.module.graph.nodes
               if n.op == "call_function"]
    int8 = mode == "beam_int8"
    assert targets.count("acvae_tpu_torch.bn_relu.default") == 8 * (not int8)
    assert targets.count("acvae_tpu_torch.stem_conv3x3_i8.default") == int8
    assert targets.count("acvae_tpu_torch.conv3x3_i8.default") == 7 * int8
    assert targets.count("acvae_tpu_torch.avgpool2x2_i8.default") == 3 * int8


@pytest.mark.parametrize("mode", F32_MODES)
def test_export_round_trip(tiny, mode):
    check_round_trip(tiny, mode)


# --------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------- #
def test_int8_operators_opcheck():
    x, w, A, B = (torch.tensor(a) for a in conv_case(8, 16, False, seed=5))
    wk = pack_conv3x3_weight(w)
    for mode, pad in (("sym", 0), ("offset", -128), ("f32relu", 0), ("f32", 0)):
        torch.library.opcheck(conv3x3_i8_op, (x, wk, A, B, mode, pad))
    torch.library.opcheck(avgpool2x2_i8_op, (x,))


@pytest.mark.parametrize("mode", ["sym", "offset", "f32relu", "f32"])
@pytest.mark.parametrize("want_codes", [True, False], ids=["codes", "no_codes"])
def test_stem_operator_opcheck(mode, want_codes):
    torch.library.opcheck(stem_conv3x3_i8_op,
                          (*stem_case(2, 9, 7, 64, seed=8), mode, want_codes))


def test_fake_trace_of_the_stem_keeps_the_batch_symbolic():
    """The stem operator exported with a symbolic batch runs at other batch
    sizes, codes and all, and equals its plain version."""
    _, c1, c2, w, A, B = stem_case(2, 9, 7, 64, seed=9)

    class Stem(torch.nn.Module):
        def forward(self, feats):
            return stem_conv3x3_i8(feats, c1, c2, w, A, B, "offset", codes=True)

    b = torch.export.Dim("b", min=1, max=1024)
    ep = torch.export.export(Stem(), (stem_case(2, 9, 7, 64, seed=9)[0],),
                             dynamic_shapes=({0: b},))
    for n in (1, 3):
        feats = stem_case(n, 9, 7, 64, seed=n)[0]
        out, codes = ep.module()(feats)
        want_out, want_codes = stem_plain(feats, c1, c2, w, A, B, "offset")
        assert torch.equal(out, want_out) and torch.equal(codes, want_codes)


def test_fake_trace_keeps_the_batch_symbolic():
    """An export over both operators with a symbolic batch does not pin
    it: the program runs at other batch sizes and equals the plain
    versions."""
    _, w, A, B = (torch.tensor(a) for a in conv_case(8, 16, False, seed=6))
    wk = pack_conv3x3_weight(w)

    class Block(torch.nn.Module):
        def forward(self, x):
            return avgpool2x2_i8(conv3x3_i8(x, wk, A, B, "sym", 0))

    rng = np.random.default_rng(1)
    codes = lambda n: torch.tensor(  # noqa: E731
        rng.integers(-128, 128, size=(n, 9, 7, 8)).astype(np.int8))
    b = torch.export.Dim("b", min=1, max=1024)
    ep = torch.export.export(Block(), (codes(2),), dynamic_shapes=({0: b},))
    assert [str(s) for s in ep.range_constraints.values()] == ["VR[1, 1024]"]
    for n in (1, 5):
        x = codes(n)
        want = avgpool2x2_i8_ref(conv3x3_i8_ref(x, w, A, B, "sym", 0))
        assert torch.equal(ep.module()(x), want)


# --------------------------------------------------------------------- #
# the CLI and the service
# --------------------------------------------------------------------- #
def test_export_model_refuses_other_platforms(tiny):
    _, _, exp, _ = tiny
    with pytest.raises(ValueError, match="tpu"):
        main(["export_model", exp, "--device=cpu", "--platforms=cpu,tpu"])
    if not torch.cuda.is_available():    # a named device is loaded on
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["export_model", exp, "--device=cpu", "--max_length=1",
                  "--platforms=cpu,cuda", f"--t_mel={TMEL}",
                  f"--output_dir={os.path.dirname(exp)}/platforms"])


def test_load_exported_defaults_to_the_card(tiny):
    """``load_exported`` runs on the card unless the caller passes
    ``device="cpu"``; with no card visible the default raises."""
    import inspect

    out = tiny[3]["beam"]
    assert inspect.signature(texport.load_exported).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        decode, _ = texport.load_exported(out)
        assert decode.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card.*device='cpu'"):
            texport.load_exported(out)
