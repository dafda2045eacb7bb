"""The six family recipes through the port's user surface: ``load_config``
+ ``build_model`` at their own widths, ``experiment_from_flax`` for each,
the schedule of the recipes that leave keys to the CLI's defaults, one
small ``train`` + ``evaluate`` (+ ``predict``) of ``configs/vae.yaml`` and
``configs/xe_baseline.yaml`` through ``acvae_tpu_torch.cli``, and the
guards that refuse what the JAX package refuses (int8, the ensemble, the
bf16 decode).  On the CPU, at Cnn10 channels 4-8-8-16 and embed 16, on a
``make_synthetic --rich`` corpus of 12 clips.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from acvae_tpu.cli.main import DEFAULTS as J_DEFAULTS
from acvae_tpu.train.trainer import (dis_ratio_for_epoch, kl_weight_schedule,
                                     ss_ratio_at)
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.convert import experiment_from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.models.build import build_model
from acvae_tpu_torch.serve import CaptionService
from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment
from acvae_tpu_torch.train.trainer import Trainer
from tests.test_torch_families_rnn import (  # noqa: F401
    FDIM, Pair, V, one_torch_thread)

RECIPES = {"vae": "VAECaptionModel", "gmm_vae": "VAECaptionModel",
           "simple_vae": "SimpleVAECaptionModel",
           "trans_vae": "TransVAECaptionModel",
           "attn_rnn_xe": "AttnCaptionModel",
           "xe_baseline": "TransformerCaptionModel"}
TINY = {"vae": ["--decoder_args={embed_size: 16, hidden_size: 16, dropout: 0.0}",
                "--model_args.posterior_args.hidden_size=8",
                "--model_args.prior_args.hidden_size=16",
                "--augments=[timewarp,timemask,freqmask]"],
        "xe_baseline": ["--decoder_args={embed_size: 16, nhead: 2, nlayers: 2, "
                        "hidden_size: 32, dropout: 0.2}"]}


def test_every_recipe_builds_in_the_port():
    """Each recipe builds its family at its own widths (no ``ln``: encoder
    and decoder are 512 wide); the CLI's defaults are JAX's.  sentence.yaml
    builds the Seq2SeqAttnModel with its CaptionSentenceModel head, whose
    512 equals the decoder's hidden size: no projection."""
    assert cli.DEFAULTS == J_DEFAULTS
    for recipe, kind in dict(RECIPES, ac_vae="VAECaptionModel",
                             adverse="VAECaptionModel",
                             sentence="AttnCaptionModel").items():
        model = build_model(load_config(f"configs/{recipe}.yaml"), 4981, 64,
                            device="meta")
        assert type(model).__name__ == kind
        assert model.ln is None
    model = build_model(load_config("configs/sentence.yaml"), V, FDIM, device="cpu")
    assert model.seq_output_size == 512 and model.output_transform is None


@pytest.mark.parametrize("recipe", ["xe_baseline", "attn_rnn_xe", "simple_vae"])
def test_ratios_of_recipes_without_the_schedule_keys(recipe):
    """xe_baseline has no ss_args, beta or dis_ration; the others lack some:
    Trainer.ratios takes the JAX CLI's defaults for them."""
    conf = load_config(f"configs/{recipe}.yaml")
    conf.update(encoder_args={"embed_size": 16, "channels": [4, 8, 8, 16]},
                decoder_args=dict(conf["decoder_args"], embed_size=16,
                                  hidden_size=16, nhead=2)
                if "nhead" in conf["decoder_args"] else
                dict(conf["decoder_args"], embed_size=16, hidden_size=16))
    trainer = Trainer(conf, V, FDIM, device="cpu", total_iters=250)
    d = dict(J_DEFAULTS, **conf)
    for it, epoch in ((1, 1), (120, 11), (250, 25)):
        r = trainer.ratios(it, epoch)
        assert r["ss_ratio"] == pytest.approx(ss_ratio_at(
            it, d["ss_args"]["ss_ratio"], d["ss_args"]["ss_mode"], 250,
            d["ss_args"]["final_ss_ratio"]))
        assert r["dis_ratio"] == dis_ratio_for_epoch(
            epoch, 25, d["dis_ration"]["freeze_epoch"],
            d["dis_ration"]["final_ratio"])
        assert r["kl_weight"] == kl_weight_schedule(epoch, 25, d["beta"])


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_experiment_from_flax(recipe, tmp_path):
    """A JAX experiment's weights of every family become a port experiment
    that loads strict and holds the same tensors."""
    from acvae_tpu_torch.convert import from_flax
    pair = Pair(recipe)
    vocab = Vocabulary()
    for i in range(4, V):
        vocab.add_word(f"w{i}")
    experiment_from_flax(pair.variables, pair.port_conf, vocab, str(tmp_path))
    conf, vocab2, model = load_experiment(str(tmp_path), device="cpu")
    assert type(model).__name__ == RECIPES[recipe] and len(vocab2) == V
    ref = from_flax(pair.variables)
    for k, v in model.state_dict().items():
        if k in ref:
            assert torch.equal(v, ref[k]), k


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=12",
              "--mel_frames=128", "--device=cpu"])
    return root


def _train(ws, recipe):
    return Path(cli.main(
        ["train", f"configs/{recipe}.yaml", "--device=cpu",
         f"--h5_csv={ws}/mels.csv", f"--caption_file={ws}/text.json",
         f"--vocab_file={ws}/vocab.pkl", f"--outputpath={ws}/out",
         "--epochs=1", "--batch_size=4", "--train_percent=75",
         "--encoder_args={embed_size: 16, channels: [4, 8, 8, 16]}"]
        + TINY[recipe]))


@pytest.mark.parametrize("recipe", sorted(TINY))
def test_cli_train_evaluate_predict(ws, recipe):
    """One epoch of train, then evaluate at beam 3 and dbs (and with the
    int8 encoder for vae.yaml; xe_baseline refuses it with JAX's message),
    predict, and the experiment served: every score finite, one row a
    clip, a caption a request."""
    exp = _train(ws, recipe)
    assert exp.parent.parent.name == load_config(
        f"configs/{recipe}.yaml")["model"]
    metrics = [json.loads(x) for x in (exp / "metrics.jsonl").read_text()
               .splitlines()]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["train_loss"])
    assert ("kl" in metrics[0]) == (recipe == "vae")
    text = f"--eval_caption_file={ws}/text.json"
    runs = [([], "beam_3"), (["--decode_method=dbs", "--beam_size=4",
                              "--group_size=2"], "dbs_4")]
    if recipe == "vae":
        runs.append((["--encoder_int8"], "beam_3_int8"))
    else:
        with pytest.raises(ValueError, match="inference_from_encoded"):
            cli.main(["evaluate", str(exp), text, "--device=cpu",
                      "--encoder_int8"])
    for extra, name in runs:
        scores = cli.main(["evaluate", str(exp), text, "--device=cpu"] + extra)
        assert (exp / f"scores_{name}.txt").exists()
        assert all(np.isfinite(scores[k]) for k in ("Bleu_4", "CIDEr", "SPIDEr"))
    out = cli.main(["predict", str(exp), f"{ws}/mels.csv", "--device=cpu",
                    f"--output={exp}/pred.csv"])
    assert len(Path(out).read_text().splitlines()) == 13
    svc = CaptionService(str(exp), device="cpu", batch_size=2, mel_bucket=128,
                         max_length=6)
    mel = np.random.default_rng(0).normal(size=(100, 64)).astype(np.float32)
    caps = svc.caption([mel, mel[:50]])
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)


@pytest.mark.parametrize("recipe", ["simple_vae", "gmm_vae", "trans_vae"])
def test_cli_guards_follow_the_family(ws, tmp_path, recipe):
    """The ensemble needs the step-decode API (the GMM VAE has it), the int8
    encoder inference_from_encoded (the GMM VAE has it), the bf16 decode a
    family JAX's bf16 tests cover (TransVAE only of these three)."""
    conf = load_config(f"configs/{recipe}.yaml")
    conf.update(encoder_args={"embed_size": 16, "channels": [4, 8, 8, 16]},
                decoder_args=dict(conf["decoder_args"], embed_size=16,
                                  hidden_size=32, nhead=2, nlayers=1)
                if "nhead" in conf["decoder_args"] else
                dict(conf["decoder_args"], embed_size=16, hidden_size=16),
                data_dim=64, h5_csv=f"{ws}/mels.csv",
                caption_file=f"{ws}/text.json", batch_size=6)
    vocab = Vocabulary.load(str(ws / "vocab.pkl"))
    save_experiment(str(tmp_path), build_model(conf, len(vocab), 64, "cpu"),
                    conf, vocab)
    exp, text = str(tmp_path), f"--eval_caption_file={ws}/text.json"
    api, int8, bf16 = {"simple_vae": (False, False, False),
                       "gmm_vae": (True, True, False),
                       "trans_vae": (False, False, True)}[recipe]
    for ok, argv, match in (
            (api, ["ensemble", exp, exp], "step-decode API"),
            (int8, ["evaluate", exp, text, "--encoder_int8"],
             "inference_from_encoded"),
            (bf16, ["evaluate", exp, text, "--decode_dtype=bfloat16"],
             "decode_dtype")):
        if ok:
            scores = cli.main(argv + ["--device=cpu", "--max_length=6"])
            assert np.isfinite(scores["CIDEr"])
        else:
            with pytest.raises(ValueError, match=match):
                cli.main(argv + ["--device=cpu"])
