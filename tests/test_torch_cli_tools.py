"""Port parity: ``import_torch``, ``report_results``, ``split_dataset``,
``concat_json``, ``concat_csv``, ``tsne`` and ``doctor`` of
``acvae_tpu_torch.cli`` against ``acvae_tpu.cli``.

``import_torch`` reads one reference ``.pth`` a family (a seeded port model
in the reference's layout: ``{"model": state_dict}`` with DDP's ``module.``
prefix, no ``stem_pad_lanes``), written once in a module fixture, for the
flagship and the transformer baseline: decoders at width 16, Cnn10 at its
64-512 plan, which is the only one the JAX converter reads.  The port's
experiment must equal ``convert.py::experiment_from_flax`` of JAX's import
tensor for tensor (max |diff| 0), and its beam-3 ``evaluate`` must write
JAX's captions and scores on 6 clips (both packages' prior noise patched to
one slab).  The host-only commands must write JAX's files byte for byte;
``concat_csv`` is held to pandas' output case by case, and the one case
where pandas' own promotion is not followed is pinned as such.
"""
import json
import logging
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

from acvae_tpu.cli.main import Runner
from acvae_tpu.train import checkpoints as jckpt
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.convert import experiment_from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model
from tests.test_torch_decode import fixed_eps, one_torch_thread  # noqa: F401

FDIM = 64
SMALL = {
    "ac_vae": {"encoder_args": {"embed_size": 512},
               "decoder_args": {"embed_size": 16, "hidden_size": 16,
                                "dropout": 0.0},
               "model_args.posterior_args": {"hidden_size": 16},
               "model_args.prior_args": {"hidden_size": 16}},
    "xe_baseline": {"encoder_args": {"embed_size": 512},
                    "decoder_args": {"embed_size": 16, "nhead": 2,
                                     "nlayers": 2, "hidden_size": 32,
                                     "dropout": 0.0}},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """make_synthetic --rich, 6 clips of 64 frames, with an HDF5 copy of the
    mels and its manifest for the JAX side."""
    root = tmp_path_factory.mktemp("tools")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=6",
              "--mel_frames=64", "--device=cpu"])
    with np.load(root / "mels.npz") as z, h5py.File(root / "mels.h5", "w") as f:
        for aid in z.files:
            f[aid] = z[aid]
    (root / "h5.csv").write_text(
        (root / "mels.csv").read_text().replace("mels.npz", "mels.h5"))
    return root


# --------------------------------------------------------------------- #
# import_torch
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=sorted(SMALL))
def imported(request, corpus, tmp_path_factory):
    """One reference .pth of the recipe, imported by both packages."""
    recipe = request.param
    root = tmp_path_factory.mktemp(f"import_{recipe}")
    conf = load_config(f"configs/{recipe}.yaml", **SMALL[recipe])
    vocab = Vocabulary.load(str(corpus / "vocab.pkl"))
    torch.manual_seed(3)
    model = build_model(conf, len(vocab), FDIM, device="cpu")
    rng = np.random.default_rng(4)
    ref = {}
    for k, v in model.state_dict().items():
        if k.endswith("stem_pad_lanes"):
            continue           # the port's own buffer; no reference dict has it
        if k.endswith("running_var"):
            v = torch.tensor(rng.uniform(0.5, 2.0, v.shape), dtype=v.dtype)
        elif k.endswith("running_mean"):
            v = torch.tensor(rng.normal(0, 0.3, v.shape), dtype=v.dtype)
        ref["module." + k] = v.clone()
    torch.save({"model": ref}, root / "best.pth")
    (root / "config.yaml").write_text(yaml.safe_dump(json.loads(json.dumps(conf))))
    args = (str(root / "best.pth"), str(root / "config.yaml"))
    jax_counts = Runner().import_torch(*args, str(root / "jax"),
                                       str(corpus / "vocab.pkl"), data_dim=FDIM)
    port_counts = cli.main(["import_torch", *args, str(root / "port"),
                            str(corpus / "vocab.pkl"), f"--data_dim={FDIM}",
                            "--mel_bucket=32", "--device=cpu"])
    return recipe, root, ref, jax_counts, port_counts


def flax_leaves(name):
    """How many flax leaves one port tensor holds: the additive attention's
    h2attn weight is dec_proj's and enc_proj's kernels, a
    MultiheadAttention's in_proj weight and bias are query's, key's and
    value's."""
    if name.endswith("h2attn.weight"):
        return 2
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return 3
    return 1


def test_import_torch_matches_jax(imported):
    """Every tensor of the .pth loads, equal to experiment_from_flax of
    JAX's import; the counts are the port's tensors (JAX counts flax leaves:
    the same total once each joined tensor counts its leaves)."""
    recipe, root, ref, jax_counts, port_counts = imported
    tree = jckpt.load_raw_checkpoint(str(root / "jax"), "best",
                                     subset=("params", "batch_stats"))
    experiment_from_flax(tree, load_config(str(root / "jax/config.yaml")),
                         Vocabulary.load(str(root / "jax/vocab.pkl")),
                         str(root / "from_jax"))
    ours = torch.load(root / "port/best.pt", weights_only=True)["state_dict"]
    theirs = torch.load(root / "from_jax/best.pt", weights_only=True)["state_dict"]
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert torch.equal(ours[k], theirs[k]), (
            k, (ours[k] - theirs[k]).abs().max().item())
        if "module." + k in ref:
            assert torch.equal(ours[k], ref["module." + k]), k
        else:
            assert k.endswith("stem_pad_lanes") and not ours[k].any()
    assert jax_counts["params_loaded"] == jax_counts["params_total"]
    assert port_counts["params_loaded"] == port_counts["params_total"]
    params = {n for n, _ in build_model(
        json.loads((root / "port/config.json").read_text()),
        len(Vocabulary.load(str(root / "port/vocab.pkl"))), FDIM,
        device="meta").named_parameters()}
    assert port_counts["params_total"] == len(params)
    assert sum(flax_leaves(n) for n in params) == jax_counts["params_total"]
    assert ({k: port_counts[k] for k in ("stats_loaded", "stats_total")}
            == {k: jax_counts[k] for k in ("stats_loaded", "stats_total")})
    assert json.loads((root / "port/config.json").read_text())["data_dim"] == FDIM
    assert (root / "port/vocab.pkl").read_bytes() == (root / "jax/vocab.pkl").read_bytes()


def test_import_torch_decodes_as_jax(imported, corpus, fixed_eps):
    """A beam-3 evaluate of each package's import: the same captions and
    the same scores file."""
    recipe, root, *_ = imported
    Runner().evaluate(str(root / "jax"), eval_h5_csv=str(corpus / "h5.csv"),
                      eval_caption_file=str(corpus / "text.json"))
    cli.evaluate(str(root / "port"), eval_h5_csv=str(corpus / "mels.csv"),
                 eval_caption_file=str(corpus / "text.json"), device="cpu")
    for name in ("eval_output_beam_3.json", "scores_beam_3.txt"):
        assert (root / "port" / name).read_text() == (root / "jax" / name).read_text()
    preds = json.loads((root / "port/eval_output_beam_3.json").read_text())
    assert len(preds["predictions"]) == 6


def test_import_torch_reports_what_it_skips(corpus, tmp_path, capsys, caplog):
    """A bare state dict without the prefix, one tensor of the wrong shape
    and one unknown key: the tensor keeps its seeded init, the warning line
    counts it, and both are logged."""
    conf = load_config("configs/ac_vae.yaml", **SMALL["ac_vae"])
    vocab = Vocabulary.load(str(corpus / "vocab.pkl"))
    torch.manual_seed(5)
    sd = build_model(conf, len(vocab), FDIM, device="cpu").state_dict()
    sd["decoder.classifier.bias"] = torch.zeros(3)
    sd["unknown.weight"] = torch.zeros(2)
    torch.save(sd, tmp_path / "bare.pth")
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(json.loads(json.dumps(conf))))
    caplog.set_level(logging.INFO, logger="acvae_tpu_torch")
    out = cli.import_torch(str(tmp_path / "bare.pth"), str(tmp_path / "c.yaml"),
                           str(tmp_path / "exp"), str(corpus / "vocab.pkl"),
                           device="cpu")
    assert out["params_loaded"] == out["params_total"] - 1
    assert out["stats_loaded"] == out["stats_total"]
    assert "warning: 1 param tensors kept their fresh init" in capsys.readouterr().out
    assert "skip decoder.classifier.bias: shape (3,)" in caplog.text
    assert "unmapped key unknown.weight (dropped)" in caplog.text


# --------------------------------------------------------------------- #
# report_results, split_dataset, concat_json
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("score_file", ["scores_beam_3.txt",
                                        "scores_dbs_8_int8.txt"])
def test_report_results_matches_jax(score_file, tmp_path, capsys):
    """Three seeds (one without the file), a note line and an n/a score."""
    sides = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        for i, (cider, bleu) in enumerate([(0.4123, 0.61), (0.3877, 0.59),
                                           (0.4501, 0.6)]):
            d = root / f"seed_{i + 1}"
            d.mkdir(parents=True)
            if i == 1:
                continue
            (d / score_file).write_text(
                f"Bleu_1: {bleu:.3f}\nCIDEr: {cider:.3f}\nSPICE: n/a (java "
                f"scorer unavailable)\n# note: METEOR computed natively\n"
                f"Bleu_4: -0.000\n")
        sides[side] = root
    ref = Runner().report_results(str(sides["jax"]), score_file=score_file)
    ref_out = capsys.readouterr().out
    ours = cli.main(["report_results", str(sides["port"]),
                     f"--score_file={score_file}", "--device=cpu"])
    assert ours == ref and capsys.readouterr().out == ref_out
    name = ("aggregated_scores.txt" if score_file == "scores_beam_3.txt"
            else f"aggregated_{score_file}")
    assert ((sides["port"] / name).read_bytes()
            == (sides["jax"] / name).read_bytes())
    assert "CIDEr: 0.431 ± 0.019 (n=2)" in ref_out


def _ties_corpus(path):
    """Audios whose captions give equal mean cosines (ties)."""
    audios = [{"audio_id": f"a{i}", "captions": [
        {"caption": c, "cap_id": j} for j, c in enumerate(caps)]}
        for i, caps in enumerate([["a dog", "a dog"], ["rain falls", "a car"],
                                  ["a cat", "a cat"], ["wind", "birds sing"],
                                  ["one", "two", "one"]])]
    path.write_text(json.dumps({"audios": audios}))


@pytest.mark.parametrize("source", ["synthetic", "ties"])
def test_split_dataset_matches_jax(source, corpus, tmp_path):
    text = corpus / "text.json"
    if source == "ties":
        text = tmp_path / "ties.json"
        _ties_corpus(text)
    Runner().split_dataset(str(text), str(tmp_path / "jax"))
    cli.main(["split_dataset", str(text), str(tmp_path / "port"), "--device=cpu"])
    for half in ("hard", "easy"):
        ours = (tmp_path / f"port_{half}.json").read_bytes()
        assert ours == (tmp_path / f"jax_{half}.json").read_bytes()
        assert json.loads(ours)["audios"]


def test_concat_json_matches_jax(corpus, tmp_path):
    _ties_corpus(tmp_path / "ties.json")
    inputs = [str(corpus / "text.json"), str(tmp_path / "ties.json")]
    Runner().concat_json(*inputs, output=str(tmp_path / "jax.json"))
    cli.main(["concat_json", *inputs, f"--output={tmp_path / 'port.json'}",
              "--device=cpu"])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads((tmp_path / "port.json").read_text())["audios"]) == 11


# --------------------------------------------------------------------- #
# concat_csv: the port's TSV against pandas
# --------------------------------------------------------------------- #
CSV_CASES = {
    "manifests": ["audio_id\thdf5_path\nclip_a.wav\t/d/mels.npz\n"
                  "clip_b.wav\t/d/mels.npz\n",
                  "audio_id\thdf5_path\nclip_c.wav\t/e/mels.npz\n"],
    "digit_ids": ["audio_id\thdf5_path\n0001\tx.npz\n12\tx.npz\n",
                  "audio_id\thdf5_path\n007\ty.npz\n"],
    "digits_and_names": ["audio_id\thdf5_path\n0001\tx.npz\n",
                         "audio_id\thdf5_path\nclip.wav\ty.npz\n"],
    "missing_columns": ["audio_id\thdf5_path\n0001\tx.npz\n",
                        "hdf5_path\taudio_id\tsplit\ny.npz\t5\t1\n"],
    "missing_values": ["a\tb\tc\n1\t\tNA\n2\tx\tnan\n", "a\tb\tc\n3.5\ty\tNone\n"],
    "floats": ["a\tb\n1.50\t1e3\n-0.0\tinf\n 7 \t2\n", "a\tb\n1e400\t3\n"],
    "quoted": ['a\tb\n"x\ty"\t1\n"q""uote"\t2\n', "a\tb\nplain\t3\n"],
    "bools": ["a\tb\nTRUE\ttrue\nfalse\t\n", "a\tb\nTrue\tFALSE\n"],
    "strings_kept": ["a\tb\n1_0\t x \n+5\t-3\n", "a\tb\n0x1\t1.0.0\n"],
}


def _concat(tmp_path, texts):
    paths = []
    for i, t in enumerate(texts):
        paths.append(tmp_path / f"in{i}.csv")
        paths[-1].write_text(t)
    Runner().concat_csv(*map(str, paths), output=str(tmp_path / "jax.csv"))
    cli.main(["concat_csv", *map(str, paths), f"--output={tmp_path / 'port.csv'}",
              "--device=cpu"])
    return (tmp_path / "port.csv").read_text(), (tmp_path / "jax.csv").read_text()


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_concat_csv_matches_pandas(case, tmp_path):
    ours, ref = _concat(tmp_path, CSV_CASES[case])
    assert ours == ref
    if case == "digit_ids":
        assert ours.splitlines()[1:] == ["1\tx.npz", "12\tx.npz", "7\ty.npz"]


def test_concat_csv_bool_and_number_columns(tmp_path):
    """The one recorded difference (ROADMAP §C): a column that is bool in
    one input and numeric in another.  pandas 3 writes the bools as 1/0;
    the port keeps each value as its input read it."""
    ours, ref = _concat(tmp_path, ["a\tb\nTrue\tx\n", "a\tb\n2\ty\n"])
    assert ours == "a\tb\nTrue\tx\n2\ty\n"
    import pandas
    if int(pandas.__version__.split(".")[0]) >= 3:
        assert ref == "a\tb\n1\tx\n2\ty\n"


# --------------------------------------------------------------------- #
# tsne, doctor
# --------------------------------------------------------------------- #
def _trees(root):
    rng = np.random.default_rng(0)
    for tree, n_aud in (("bert", 25), ("stage1", 24)):
        for a in range(n_aud):
            d = root / tree / f"aud{a:02d}"
            d.mkdir(parents=True)
            for i in range(2):
                np.save(d / f"{i}.npy", rng.normal(size=8).astype(np.float32))
            np.save(d / "caption.npy", np.zeros(8, np.float32))
    return [str(root / "bert"), str(root / "stage1")]


def test_tsne_matches_jax(tmp_path, capsys):
    """The same sampled audios (25 ids, 20 drawn; one absent from the second
    tree), PNG names and point counts."""
    dirs = _trees(tmp_path)
    ref = Runner().tsne(*dirs, output_prefix=str(tmp_path / "jax"))
    ref_out = capsys.readouterr().out
    ours = cli.main(["tsne", *dirs, f"--output_prefix={tmp_path / 'port'}",
                     "--device=cpu"])
    out = capsys.readouterr().out
    assert [Path(p).name.replace("port", "jax") for p in ours] == [
        Path(p).name for p in ref]
    assert out.replace(str(tmp_path / "port"), "") == ref_out.replace(
        str(tmp_path / "jax"), "")
    assert all(Path(p).stat().st_size > 0 for p in ours)
    assert "(40 points, 20 audios)" in out


@pytest.mark.parametrize("hidden", ["sklearn", "matplotlib"])
def test_tsne_names_the_missing_package(hidden, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == hidden]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, hidden, None)
    with pytest.raises(ImportError, match=f"scikit-learn and matplotlib.*{hidden}"):
        cli.tsne(*_trees(tmp_path))


def test_doctor_probes_the_cpu(capsys):
    report = cli.main(["doctor", "--device=cpu", "--probe_timeout=120"])
    assert report["ok"] is True and report["torch_version"] == torch.__version__
    assert report["device"]["type"] == "cpu" and report["device"]["count"] == 1
    assert report["device"]["matmul_ms_p50"] >= 0 and report["probe_wall_s"] >= 0
    assert report["kernel_build"]["path"].endswith("acvae_tpu_torch/build")
    assert json.loads(capsys.readouterr().out) == report


def test_doctor_cuts_a_hung_probe(monkeypatch):
    def hang(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 1))
    monkeypatch.setattr(subprocess, "run", hang)
    with pytest.raises(SystemExit) as e:
        cli.doctor(probe_timeout=1, device="cpu")
    assert e.value.code == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_doctor_without_a_card_fails(capsys):
    """--device=cuda (the default) with no card: main refuses, and the probe
    itself fails rather than measuring the CPU."""
    with pytest.raises(RuntimeError, match="CUDA card.*--device=cpu"):
        cli.main(["doctor"])
    with pytest.raises(SystemExit) as e:
        cli.doctor(probe_timeout=120, device="cuda")
    assert e.value.code == 1
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is False and "needs a CUDA card" in report["error"]
