"""Port parity: the auxiliary commands of ``acvae_tpu_torch.cli``
(``train_discriminator``, ``stage1``, ``stage1_test``,
``extract_embedding``, ``global_vae`` with ``pretrained_global``,
``extract_sentence_embedding``, ``export_embeddings``) and the two recipes
that use them, ``configs/adverse.yaml`` (both stages) and
``configs/sentence.yaml``, against ``acvae_tpu.cli`` on one workspace.

The workspace is the port's ``make_synthetic --rich`` corpus of 16 clips
(the same arrays as an HDF5 manifest for the JAX runner) at small widths
(Cnn10 channels 4-8-8-16, embed/hidden 16, the discriminator 16/8/16).
The trained commands start from the JAX runner's initial weights (captured
from its ``TrainState.create``, or its stage-1 init recomputed), carried
with ``from_flax``; Cnn10's dropouts are off on both sides.

Tolerances: the logged losses within the logs' print precision (``.4g``
and ``.4f``: rtol 2e-3, atol 2e-4) after Adam steps at lr 1e-4 or SGD
steps; the stage-1 weights after training atol 1e-5; ``stage1_test``'s EER
equal; the embedding ``.npy`` files of the carried JAX embedder atol 1e-5;
the word-vector and TSV files byte-identical.
"""
import json
import re
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

import acvae_tpu.models.encoders as jenc
import acvae_tpu.train.trainer as jtrainer
from acvae_tpu.cli.main import Runner
from acvae_tpu.core.config import load_config as j_load_config
from acvae_tpu.data.aux_datasets import Stage1Dataset as JStage1Dataset
from acvae_tpu.data.vocab import Vocabulary as JVocabulary, load_caption_info
from acvae_tpu.losses.wrappers import augment_keep_mask as j_keep_mask
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.models.stage1 import Stage1Encoder as JStage1Encoder
from acvae_tpu.train.checkpoints import load_raw_checkpoint
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import discriminator_from_flax, from_flax
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.train.checkpoints import load_discriminator
from acvae_tpu_torch.train.pretrained import apply_pretrained
from acvae_tpu_torch.train.trainer import Trainer
from tests.test_torch_decode import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL_ENC = {"embed_size": 16, "channels": [4, 8, 8, 16]}
DARGS = {"word_dim": 16, "hidden_size": 8, "embed_size": 16}
DEC = {"embed_size": 16, "hidden_size": 16, "dropout": 0.0}


def _yaml(d):
    return json.dumps(d).replace('"', "")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The port's corpus (.npz) and its HDF5 copy for the JAX runner."""
    root = tmp_path_factory.mktemp("auxcli")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=16",
              "--mel_frames=128", "--device=cpu"])
    with np.load(root / "mels.npz") as z, h5py.File(root / "mels.h5", "w") as f:
        for aid in z.files:
            f[aid] = z[aid]
    (root / "h5.csv").write_text((root / "mels.csv").read_text().replace(
        "mels.npz", "mels.h5"))
    return root


def _common(ws, side, out):
    """The overrides of both recipes at test widths: (JAX kwargs, port
    argv)."""
    kw = {"h5_csv": str(ws / ("h5.csv" if side == "jax" else "mels.csv")),
          "caption_file": str(ws / "text.json"),
          "vocab_file": str(ws / "vocab.pkl"), "outputpath": str(out),
          "epochs": 1, "batch_size": 8, "train_percent": 75,
          "encoder_args": dict(SMALL_ENC), "discriminator_args": dict(DARGS),
          "optimizer_args": {"lr": 1e-4}}
    argv = [f"--{k}={_yaml(v) if isinstance(v, dict) else v}"
            for k, v in kw.items()] + ["--device=cpu"]
    return kw, argv


@pytest.fixture(scope="module")
def no_dropout():
    """Cnn10's dropouts off on both sides (torch cannot replay flax's)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jenc._DropoutMixin, "_dropout", lambda self, x, rate, train: x)
    mp.setattr(torch.nn.functional, "dropout",
               lambda x, p=0.5, training=True, inplace=False: x)
    yield
    mp.undo()


def _epoch_rows(log: str):
    """The numbers of each epoch row of a train_dscrm.log table."""
    rows = []
    for line in log.splitlines():
        nums = line.split("] - ", 1)[-1].split("\t")
        if len(nums) == 4 and nums[0].strip().isdigit():
            rows.append([float(x) for x in nums])
    return rows


@pytest.fixture(scope="module")
def discriminators(ws, tmp_path_factory, no_dropout):
    """``train_discriminator`` in both modes, 2 epochs each, on both sides;
    the port starts from the JAX runner's initial weights.  Returns {mode:
    (jax dir, port dir)}."""
    out = tmp_path_factory.mktemp("dscrm")
    runs = {}
    for mode in ("aud2cap", "cap2cap"):
        captured = {}
        real_create = jtrainer.TrainState.create.__func__

        def create(cls, variables, tx):
            captured["v"] = jax.tree_util.tree_map(np.asarray, variables)
            return real_create(cls, variables, tx)
        mp = pytest.MonkeyPatch()
        mp.setattr(jtrainer.TrainState, "create", classmethod(create))
        kw = dict(_common(ws, "jax", out / "jax")[0], epochs=2,
                  audios_per_batch=3)
        jdir = Runner().train_discriminator(str(ROOT / "configs/adverse.yaml"),
                                            mode=mode, **kw)
        mp.undo()
        real_model = cli._discriminator_model

        def model_from_jax(*a, **k):
            model = real_model(*a, **k)
            model.load_state_dict(from_flax(captured["v"]), strict=True)
            return model
        mp.setattr(cli, "_discriminator_model", model_from_jax)
        _, argv = _common(ws, "port", out / "port")
        pdir = cli.main(["train_discriminator", str(ROOT / "configs/adverse.yaml"),
                         f"--mode={mode}"] + argv
                        + ["--epochs=2", "--audios_per_batch=3"])
        mp.undo()
        runs[mode] = (Path(jdir), Path(pdir))
    return runs


@pytest.mark.parametrize("mode", ["aud2cap", "cap2cap"])
def test_train_discriminator_matches_jax(discriminators, mode, tmp_path):
    """The experiment's place and files, the recorded discriminator keys,
    and each epoch's train loss, accuracy and validation loss; an aud2cap
    experiment of either package (the JAX one through
    ``discriminator_from_flax``) loads as the frozen discriminator of
    ``adverse_loss``."""
    jdir, pdir = discriminators[mode]
    assert pdir.parts[-3:] == jdir.parts[-3:] == (
        "DiscriminatorModel", f"adverse_{mode}", "seed_1")
    jfiles, pfiles = {p.name for p in jdir.iterdir()}, {p.name for p in pdir.iterdir()}
    assert {"best", "last", "config.yaml", "vocab.pkl", "train_dscrm.log"} <= jfiles
    assert pfiles == {"best.pt", "last.pt", "config.json", "vocab.pkl",
                      "train_dscrm.log"}
    jconf = j_load_config(str(jdir / "config.yaml"))
    pconf = json.loads((pdir / "config.json").read_text())
    for k in ("discriminator_mode", "discriminator_audio_dim",
              "discriminator_args"):
        assert pconf[k] == jconf[k], k
    assert pconf["discriminator_mode"] == mode
    want = _epoch_rows((jdir / "train_dscrm.log").read_text())
    got = _epoch_rows((pdir / "train_dscrm.log").read_text())
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    sd = torch.load(pdir / "last.pt", weights_only=True)["state_dict"]
    ref = from_flax(load_raw_checkpoint(str(jdir), "last",
                                        subset=("params", "batch_stats")))
    ref.pop("encoder.stem_pad_lanes", None)
    sd.pop("encoder.stem_pad_lanes", None)
    assert set(sd) == set(ref)
    if mode == "cap2cap":
        return
    vocab = Vocabulary.load(str(jdir / "vocab.pkl"))
    tree = load_raw_checkpoint(str(jdir), "best", subset=("params", "batch_stats"))
    discriminator_from_flax(tree, dict(jconf), vocab, str(tmp_path))
    dm = load_discriminator(str(tmp_path), len(vocab), device="cpu")
    for k, v in dm.state_dict().items():
        assert torch.equal(v, from_flax(tree)[f"dscrm.{k}"]), k
    assert not any(p.requires_grad for p in
                   load_discriminator(str(pdir), len(vocab), device="cpu").parameters())


def _parse_losses(log: str, pattern: str):
    return [float(m) for m in re.findall(pattern, log)]


@pytest.fixture(scope="module")
def stage1_runs(ws, tmp_path_factory):
    """``stage1`` on both sides (the port from the JAX init), then the JAX
    embedder carried into a port stage-1 dir; ``stage1_test`` and
    ``extract_embedding`` of each."""
    out = tmp_path_factory.mktemp("stage1")
    text, vocab_file = str(ws / "text.json"), str(ws / "vocab.pkl")
    args = dict(epochs=2, audios_per_batch=4, uttnumbers=4, embed_size=16)
    Runner().stage1(text, vocab_file, output_dir=str(out / "jax"), **args)
    jvocab = JVocabulary.load(vocab_file)
    caps0, lens0 = JStage1Dataset(load_caption_info(text), jvocab,
                                  uttnumbers=4).require_batch(4, 1)
    init = JStage1Encoder(vocab_size=len(jvocab), embed_size=16).init(
        jax.random.key(1), caps0, lens0, train=False)
    mp = pytest.MonkeyPatch()
    real = cli._stage1_models

    def from_jax(*a, **k):
        enc, loss = real(*a, **k)
        enc.load_state_dict(from_flax(init), strict=True)
        return enc, loss
    mp.setattr(cli, "_stage1_models", from_jax)
    cli.main(["stage1", text, vocab_file, f"--output_dir={out / 'port'}",
              "--device=cpu"] + [f"--{k}={v}" for k, v in args.items()])
    mp.undo()
    import pickle
    with open(out / "jax" / "stage1_params.pkl", "rb") as f:
        jtree = pickle.load(f)
    (out / "carried").mkdir()
    torch.save({"state_dict": from_flax(jtree)}, out / "carried" / "stage1_params.pt")
    eers = {"jax": Runner().stage1_test(str(out / "jax"), text, vocab_file,
                                        audios_per_batch=4, embed_size=16)}
    eers["port"] = cli.main(["stage1_test", str(out / "carried"), text,
                             vocab_file, "--audios_per_batch=4",
                             "--embed_size=16", "--device=cpu"])
    Runner().extract_embedding(str(out / "jax"), text, vocab_file,
                               str(out / "jax_emb"), embed_size=16)
    cli.main(["extract_embedding", str(out / "carried"), text, vocab_file,
              str(out / "port_emb"), "--embed_size=16", "--device=cpu"])
    return out, jtree, eers


def test_stage1_matches_jax(stage1_runs):
    """The logged GE2E losses and the trained embedder (SGD with momentum,
    the two clips) from the same init."""
    out, jtree, _ = stage1_runs
    pat = r"GE2E loss ([-\d.]+)"
    want = _parse_losses((out / "jax" / "stage1.log").read_text(), pat)
    got = _parse_losses((out / "port" / "stage1.log").read_text(), pat)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    sd = torch.load(out / "port" / "stage1_params.pt", weights_only=True)
    for k, v in from_flax(jtree).items():
        np.testing.assert_allclose(sd["state_dict"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_stage1_test_and_extract_embedding_match_jax(stage1_runs):
    """The carried JAX embedder: the same EER, the same ``.npy`` tree."""
    out, _, eers = stage1_runs
    assert eers["port"] == eers["jax"]
    jfiles = sorted(p.relative_to(out / "jax_emb")
                    for p in (out / "jax_emb").rglob("*.npy"))
    pfiles = sorted(p.relative_to(out / "port_emb")
                    for p in (out / "port_emb").rglob("*.npy"))
    assert jfiles == pfiles and len(jfiles) == 16 * 6
    for rel in jfiles:
        a, b = np.load(out / "port_emb" / rel), np.load(out / "jax_emb" / rel)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (16,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(rel))
    with pytest.raises(ValueError, match="uttnumbers must be even"):
        cli.stage1_test(str(out / "carried"), "x", "y", uttnumbers=3,
                        device="cpu")


def _loaded_line(lines, key="pretrained_global[params]"):
    (m,) = [re.search(r"loaded (\d+)/(\d+) tensors", s) for s in lines
            if s.startswith(key)]
    return int(m.group(1)), int(m.group(2))


def test_global_vae_and_pretrained_global_match_jax(ws, tmp_path):
    """``global_vae`` on both sides (the port's parameters are the JAX
    tree's, by name and shape), then the ``pretrained_global`` merge into
    the flagship recipe: the port loads the tensors JAX loads (their
    names differ from the captioner's, so none) and counts its own
    parameters; a CLI train logs it."""
    text, vocab_file = str(ws / "text.json"), str(ws / "vocab.pkl")
    args = dict(epochs=1, batch_size=32, latent_size=8)
    jdir = Runner().global_vae(text, vocab_file, output_dir=str(tmp_path / "j"),
                               **args)
    pdir = cli.main(["global_vae", text, vocab_file,
                     f"--output_dir={tmp_path / 'p'}", "--device=cpu"]
                    + [f"--{k}={v}" for k, v in args.items()])
    import pickle
    with open(Path(jdir) / "global_vae_params.pkl", "rb") as f:
        jtree = pickle.load(f)
    sd = torch.load(Path(pdir) / "global_vae_params.pt",
                    weights_only=True)["state_dict"]
    ref = from_flax({"params": jtree})
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for d in (jdir, pdir):
        assert re.search(r"epoch 1: loss [\d.]+",
                         (Path(d) / "global_vae.log").read_text())
    conf = flagship_conf(encoder_args=dict(SMALL_ENC), decoder_args=dict(DEC))
    jmodel = j_build_model(conf, 300, 64)
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k, "sample": k}, np.zeros((2, 64, 64), np.float32),
        np.array([64, 32]), np.ones((2, 6), np.int32), np.array([6, 4]),
        train=False))(jax.random.key(0))
    import logging
    jlines = []
    logger = logging.getLogger("aux_cli_test")
    logger.handlers = [logging.Handler()]
    logger.handlers[0].emit = lambda r: jlines.append(r.getMessage())
    logger.setLevel(logging.INFO)
    jconf = dict(conf, pretrained_global=str(Path(jdir) / "global_vae_params.pkl"))
    Runner()._apply_pretrained(jconf, jtrainer.TrainState.create(
        variables, jtrainer.build_optimizer("Adam", 1e-3)), logger)
    plines = []
    port = build_model(conf, 300, 64, device="cpu")
    apply_pretrained(dict(conf, pretrained_global=str(
        Path(pdir) / "global_vae_params.pt")), port, plines.append)
    (jn, jm), (pn, pm) = _loaded_line(jlines), _loaded_line(plines)
    assert pn == jn == 0
    assert jm == len(jax.tree_util.tree_leaves(variables["params"]))
    assert pm == sum(1 for _ in port.parameters())
    exp = cli.main(["train", str(ROOT / "configs/ac_vae.yaml"),
                    f"--pretrained_global={pdir}/global_vae_params.pt",
                    "--augments=[timemask]", f"--decoder_args={_yaml(DEC)}",
                    "--model_args.posterior_args.hidden_size=16",
                    "--model_args.prior_args.hidden_size=16"]
                   + _common(ws, "port", tmp_path / "t")[1])
    log = (Path(exp) / "train_caption.log").read_text()
    assert f"pretrained_global[params]: loaded 0/{pm} tensors" in log


def test_word_vector_embeddings_and_export_match_jax(ws, tmp_path, monkeypatch):
    """``extract_sentence_embedding`` from a seeded ``.npy`` matrix, then
    ``export_embeddings`` of the tree: byte-identical files.  The pickled
    matrix gives the ``.npy`` route's tree; a HuggingFace directory without
    the transformers package raises ImportError naming it."""
    text, vocab_file = str(ws / "text.json"), str(ws / "vocab.pkl")
    n_vocab = len(JVocabulary.load(vocab_file))
    matrix = np.random.default_rng(3).normal(size=(n_vocab, 8)).astype(np.float32)
    np.save(tmp_path / "wv.npy", matrix)
    import pickle
    with open(tmp_path / "wv.pkl", "wb") as f:
        pickle.dump(matrix, f)
    Runner().extract_sentence_embedding(text, vocab_file, str(tmp_path / "wv.npy"),
                                        str(tmp_path / "j"))
    for src, dst in (("wv.npy", "p"), ("wv.pkl", "pkl")):
        cli.main(["extract_sentence_embedding", text, vocab_file,
                  str(tmp_path / src), str(tmp_path / dst), "--device=cpu"])
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.npy"))
    assert len(files) == 16 * 6
    for rel in files:
        want = (tmp_path / "j" / rel).read_bytes()
        assert (tmp_path / "p" / rel).read_bytes() == want, rel
        assert (tmp_path / "pkl" / rel).read_bytes() == want, rel
    Runner().export_embeddings(str(tmp_path / "j"), str(tmp_path / "jx"))
    cli.main(["export_embeddings", str(tmp_path / "p"), str(tmp_path / "px"),
              "--device=cpu"])
    for suffix in ("_vectors.tsv", "_metadata.tsv"):
        assert ((tmp_path / f"px{suffix}").read_bytes()
                == (tmp_path / f"jx{suffix}").read_bytes())
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        cli.main(["extract_sentence_embedding", text, vocab_file, str(hf),
                  str(tmp_path / "h"), "--device=cpu"])


def test_hf_sentence_embedding_matches_jax(ws, tmp_path):
    """``extract_sentence_embedding`` from a local HuggingFace directory (a
    one-layer BERT of seeded weights over the corpus's words, written here)
    writes the JAX runner's files byte for byte: the same mean-pooled last
    hidden states, computed by the port on ``--device``."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast

    text = str(ws / "text.json")
    words = sorted({w for audio in load_caption_info(text)
                    for cap in audio["captions"] for w in cap["tokens"].split()})
    mdir = tmp_path / "tinybert"
    mdir.mkdir()
    (mdir / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words))
    tok = BertTokenizerFast(vocab_file=str(mdir / "vocab.txt"))
    tok.save_pretrained(str(mdir))
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=len(tok), hidden_size=16,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=32)
              ).save_pretrained(str(mdir))
    Runner().extract_sentence_embedding(text, "unused", str(mdir),
                                        str(tmp_path / "j"))
    cli.main(["extract_sentence_embedding", text, "unused", str(mdir),
              str(tmp_path / "p"), "--device=cpu"])
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.npy"))
    assert len(files) == 16 * 6
    assert np.load(tmp_path / "j" / files[0]).shape == (16,)
    for rel in files:
        assert ((tmp_path / "p" / rel).read_bytes()
                == (tmp_path / "j" / rel).read_bytes()), rel


def test_use_aug_prob_draws_the_jax_masks(ws, tmp_path, monkeypatch):
    """``use_aug_prob: 0.5`` on a caption file whose copies are tagged
    "aug": each step's keep mask is ``augment_keep_mask`` of the batch's
    cap_ids with the JAX CLI's generator ``(seed + 9)·1000003 +
    iteration``, and tagged captions are dropped and kept."""
    info = json.loads((ws / "text.json").read_text())
    for audio in info["audios"]:
        audio["captions"] += [dict(c, cap_id=f"aug_{i}")
                              for i, c in enumerate(audio["captions"][:2])]
    (tmp_path / "text.json").write_text(json.dumps(info))
    seen = []
    real = Trainer.step

    def step(self, batch, iteration, epoch, **k):
        seen.append((iteration, batch["keep_mask"]))
        return real(self, batch, iteration, epoch, **k)
    monkeypatch.setattr(Trainer, "step", step)
    real_stage = cli._to_device
    ids = []

    def stage(batch, *a, **k):
        ids.append(batch.cap_ids)
        return real_stage(batch, *a, **k)
    monkeypatch.setattr(cli, "_to_device", stage)
    cli.main(["train", str(ROOT / "configs/ac_vae.yaml"), "--use_aug_prob=0.5",
              "--augments=[timemask]", f"--decoder_args={_yaml(DEC)}",
              "--model_args.posterior_args.hidden_size=16",
              "--model_args.prior_args.hidden_size=16"]
             + _common(ws, "port", tmp_path / "out")[1]
             + [f"--caption_file={tmp_path / 'text.json'}"])
    train_ids = ids[:len(seen)]
    assert len(seen) == 11
    kept = []
    for (it, mask), cap_ids in zip(seen, train_ids):
        want = np.asarray(j_keep_mask(cap_ids, 0.5, np.random.default_rng(
            (1 + 9) * 1_000_003 + it)), np.float32)
        np.testing.assert_array_equal(mask, want)
        kept += [m for m, c in zip(mask, cap_ids) if "aug" in str(c)]
    assert 0 < sum(kept) < len(kept)


@pytest.fixture(scope="module")
def recipes(ws, tmp_path_factory, discriminators, stage1_runs, no_dropout):
    """Stage 2 of adverse.yaml (the train_discriminator experiments as the
    discriminator) and sentence.yaml (embedding_path: the stage-1 trees,
    16-dim: seq_output_size 16, no projection) for 1 epoch on both sides;
    the port's adverse experiment evaluated with the int8 encoder."""
    out = tmp_path_factory.mktemp("recipes")
    s1 = stage1_runs[0]
    exps = {}
    for recipe, extra in (
            ("adverse", {"model_args.posterior_args.hidden_size": 16,
                         "model_args.prior_args.hidden_size": 16}),
            ("sentence", {"model_args.seq_output_size": 16})):
        for side in ("jax", "port"):
            kw, argv = _common(ws, side, out / side)
            over = dict(extra, decoder_args=dict(DEC))
            if recipe == "adverse":
                over["adverse_loss.discriminator"] = str(
                    discriminators["aud2cap"][0 if side == "jax" else 1])
            else:
                over["embedding_path"] = str(s1 / f"{side}_emb")
            cfg = str(ROOT / f"configs/{recipe}.yaml")
            if side == "jax":
                exps[recipe, side] = Path(Runner().train(cfg, **kw, **over))
            else:
                exps[recipe, side] = Path(cli.main(
                    ["train", cfg] + argv + [
                        f"--{k}={_yaml(v) if isinstance(v, dict) else v}"
                        for k, v in over.items()]))
    scores = cli.main(["evaluate", str(exps["adverse", "port"]),
                       "--encoder_int8", "--device=cpu"])
    return exps, scores


@pytest.mark.parametrize("recipe", ["adverse", "sentence"])
def test_recipes_train_as_jax(recipes, recipe):
    """The experiment's place, its epoch record's keys, a finite loss, the
    adverse log line; the int8 evaluate of the adversarial experiment."""
    exps, scores = recipes
    j, p = exps[recipe, "jax"], exps[recipe, "port"]
    assert j.parts[-3:] == p.parts[-3:]
    jm = json.loads((j / "metrics.jsonl").read_text().splitlines()[0])
    pm = json.loads((p / "metrics.jsonl").read_text().splitlines()[0])
    assert set(pm) == set(jm)
    assert np.isfinite(pm["train_loss"])
    if recipe == "adverse":
        for d in (j, p):
            assert "adverse_loss: discriminator from" in (
                d / "train_caption.log").read_text()
        assert (p / "eval_output_beam_3_int8.json").exists()
        assert np.isfinite(scores["CIDEr"])
    else:
        conf = json.loads((p / "config.json").read_text())
        assert conf["embedding_loss"] == "Cosine"
        model = build_model(conf, 300, 64, device="meta")
        assert model.seq_output_size == 16 and model.output_transform is None
