"""Port parity: the experiment CLI of ``acvae_tpu_torch`` (``train``,
``evaluate``, ``predict``, ``diversity``, ``ensemble``, ``human_eval``,
``make_synthetic``, ``build_vocab``, ``tokenize_caption``, the checkpoints
and ``experiment_from_flax``) against ``acvae_tpu.cli``.

Small widths (Cnn10 channels 4-8-8-16, embed/hidden 16) on a rich synthetic
corpus of 16 clips, on the CPU.  The beam comparisons patch both packages'
prior noise to one numpy slab (``tests/test_torch_decode.py``); the dbs and
ensemble ones hand the port the JAX runner's own draws (its key split once
a batch; see ``tests/test_torch_dbs.py`` and ``test_torch_ensemble.py``).
Identical caption strings and identical scores files are required, for the
f32 encoder and the int8 v2sym one (the JAX side compiled, as it serves).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import acvae_tpu.models.quant as jquant
from acvae_tpu.cli.main import Runner
from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu.models.build import build_model as j_build_model
from acvae_tpu.train import checkpoints as jckpt
from acvae_tpu.train.schedules import exponential_decay_schedule
from acvae_tpu.train.trainer import (TrainState, dis_ratio_for_epoch,
                                     kl_weight_schedule, ss_ratio_at)
import acvae_tpu_torch.models.vae as tvae
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.convert import experiment_from_flax, quant_from_flax
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.train import checkpoints as tckpt
from acvae_tpu_torch.train.trainer import Trainer
from tests.test_torch_dbs import jax_dbs_eps
from tests.test_torch_decode import SMALL, fixed_eps  # noqa: F401
from tests.test_torch_ensemble import member_eps
from tests.test_torch_families_rnn import one_torch_thread  # noqa: F401
from tests.test_torch_quant import _flipped_codes, jax_baked

ROOT = Path(__file__).resolve().parents[1]
TINY = """\
model: Hybrid_VAEModel
alpha: 0.5
beta: 1.5
encodermodel: Cnn10
encoder_args: {{embed_size: 16, channels: [4, 8, 8, 16]}}
decoder: VAERNNBahdanauAttnDecoder
decoder_args: {{embed_size: 16, hidden_size: 16}}
model_args:
  posterior_model: PosteriorRNN_hybrid
  posterior_args: {{hidden_size: 16}}
  prior_model: PriorRNN
  prior_args: {{hidden_size: 16}}
h5_csv: {manifest}
caption_file: {root}/text.json
vocab_file: {root}/vocab.pkl
outputpath: {out}
epochs: 2
batch_size: 16
train_percent: 75
dis_ration: {{freeze_epoch: 1, final_ratio: 0.3}}
scheduler_args: {{final_lr: 1.0e-05, warmup_iters: 3000}}
augments: [timemask, freqmask]
"""
EPOCH_KEYS = {"epoch", "train_loss", "val_cider", "ss_ratio", "kl_weight",
              "dis_ratio", "kl", "active_units", "kl_dim_max", "qp_mse",
              "grad_norm", "epoch_wall_s"}


def _exp(out, beta=1.5, alpha=0.5):
    return Path(out) / "Hybrid_VAEModel" / f"tpu_{beta}_{alpha}" / "seed_1"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The port's make_synthetic corpus (.npz) and the same arrays as the
    JAX package's HDF5 manifest; the tiny recipe for each."""
    root = tmp_path_factory.mktemp("cli")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=16",
              "--mel_frames=128", "--device=cpu"])
    with np.load(root / "mels.npz") as z, h5py.File(root / "mels.h5", "w") as f:
        for aid in z.files:
            f[aid] = z[aid]
    manifest = (root / "mels.csv").read_text()
    (root / "h5.csv").write_text(manifest.replace("mels.npz", "mels.h5"))
    for name, man in (("port", "mels.csv"), ("jax", "h5.csv")):
        (root / f"{name}.yaml").write_text(TINY.format(
            manifest=root / man, root=root, out=root / f"{name}_out"))
    return root


# --------------------------------------------------------------------- #
# corpus and vocabulary commands
# --------------------------------------------------------------------- #
def test_make_synthetic_matches_jax(ws, tmp_path):
    Runner().make_synthetic(str(tmp_path), num_audios=16, mel_frames=128,
                            rich=True)
    assert (ws / "text.json").read_bytes() == (tmp_path / "text.json").read_bytes()
    assert (ws / "vocab.pkl").read_bytes() == (tmp_path / "vocab.pkl").read_bytes()
    with np.load(ws / "mels.npz") as z, h5py.File(tmp_path / "mels.h5") as f:
        assert sorted(z.files) == sorted(f)
        for aid in f:
            assert np.array_equal(z[aid], f[aid][()])
    lines = (ws / "mels.csv").read_text().splitlines()
    assert lines[0] == "audio_id\thdf5_path" and len(lines) == 17


def test_build_vocab_and_tokenize_commands_match_jax(ws, tmp_path):
    raw = {"audios": [{"audio_id": "a", "captions": [
        {"caption": "A Dog, barking!", "cap_id": 1},
        {"caption": "rare (words) here", "cap_id": 2}]}]}
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        for name in ("t.json", "v.json"):
            (tmp_path / side / name).write_text(json.dumps(raw))
    cli.build_vocab(str(tmp_path / "port/v.json"), str(tmp_path / "port/v.pkl"),
                    pad_to_multiple=4)
    Runner().build_vocab(str(tmp_path / "jax/v.json"), str(tmp_path / "jax/v.pkl"),
                         pad_to_multiple=4)
    cli.tokenize_caption(str(tmp_path / "port/t.json"))
    Runner().tokenize_caption(str(tmp_path / "jax/t.json"))
    for name in ("v.json", "v.pkl", "t.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


# --------------------------------------------------------------------- #
# train
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def trained(ws):
    """Both CLIs train the tiny recipe for 2 epochs on the same corpus; the
    port's per-iteration (iteration, epoch, lr, ss_ratio) are recorded."""
    seen = []
    real = Trainer.step

    def step(self, batch, iteration, epoch, **kw):
        m = real(self, batch, iteration, epoch, **kw)
        seen.append((iteration, epoch, float(m["lr"]),
                     self.ratios(iteration, epoch)["ss_ratio"], self.total_iters))
        return m
    Trainer.step = step
    try:
        port_dir = cli.main(["train", str(ws / "port.yaml"), "--device=cpu"])
    finally:
        Trainer.step = real
    jax_dir = Runner().train(str(ws / "jax.yaml"))
    return Path(port_dir), Path(jax_dir), seen


def _metrics(exp):
    return [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]


def test_train_writes_the_experiment(trained, ws):
    port_dir, _, seen = trained
    assert port_dir == _exp(ws / "port_out")
    names = set(os.listdir(port_dir))
    assert {"train_caption.log", "config.json", "metrics.jsonl", "last.pt",
            "ckpt_steps.json", "vocab.pkl"} <= names
    log = (port_dir / "train_caption.log").read_text()
    assert "Epoch" in log and "Train loss" in log and "Val score" in log
    conf = json.loads((port_dir / "config.json").read_text())
    assert conf["data_dim"] == 64 and conf["total_iters"] == len(seen) == 8
    steps = json.loads((port_dir / "ckpt_steps.json").read_text())
    assert steps["last"] == 8 and "best_score" in steps
    ckpt = torch.load(port_dir / "last.pt", weights_only=True)
    assert ckpt["step"] == 8 and {"state_dict", "optimizer", "rng"} <= set(ckpt)
    if steps["best_score"] > 0:
        assert "best.pt" in names
    # load_experiment reads the training checkpoint (best falls back to last)
    conf2, vocab, model = tckpt.load_experiment(str(port_dir), device="cpu")
    assert conf2 == conf and len(vocab) == len(Vocabulary.load(str(ws / "vocab.pkl")))


def test_metrics_have_jax_keys_and_ratios(trained):
    port_dir, jax_dir, _ = trained
    ours, ref = _metrics(port_dir), _metrics(jax_dir)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == EPOCH_KEYS
        for k in ("epoch", "ss_ratio", "kl_weight", "dis_ratio"):
            assert a[k] == b[k], k
        assert all(np.isfinite(v) for v in a.values())
    assert [m["dis_ratio"] for m in ours] == [0.0, 0.3]
    assert [m["kl_weight"] for m in ours] == [0.75, 1.5]


def test_per_iteration_schedule_matches_jax(trained):
    """lr against JAX's (float32) ExponentialDecay schedule within rtol
    3e-7, ss_ratio exactly, at the CLI's total_iters (the recipe's warmup of
    3000 shrunk to a tenth of the run); kl_weight and dis_ratio per epoch
    exactly as JAX's functions give them."""
    port_dir, _, seen = trained
    total = seen[0][4]
    sched = exponential_decay_schedule(5e-4, total, 1e-5, 3000)
    assert [i for i, *_ in seen] == list(range(1, total + 1))
    for it, epoch, lr, ss, _ in seen:
        np.testing.assert_allclose(lr, float(sched(jnp.asarray(it - 1))),
                                   rtol=3e-7)
        assert ss == ss_ratio_at(it, 1.0, "exponential", total, 0.7)
    for m in _metrics(port_dir):
        assert m["kl_weight"] == kl_weight_schedule(m["epoch"], 2, 1.5)
        assert m["dis_ratio"] == dis_ratio_for_epoch(m["epoch"], 2, 1, 0.3)


def test_resume_is_bit_identical(ws, tmp_path, monkeypatch):
    """Stopped after epoch 1's checkpoint, then ``--resume=true``: the
    weights, Adam's state and the next epoch's metrics equal those of 2
    epochs straight, with the time warp and the dropouts drawing."""
    args = [str(ws / "port.yaml"), "--device=cpu",
            "--augments=[timewarp,timemask,freqmask]"]
    real = cli.write_ckpt_step

    def stop_after_epoch_1(exp, name, step, **kw):
        real(exp, name, step, **kw)
        raise KeyboardInterrupt
    monkeypatch.setattr(cli, "write_ckpt_step", stop_after_epoch_1)
    with pytest.raises(KeyboardInterrupt):
        cli.main(["train"] + args + [f"--outputpath={tmp_path / 'a'}"])
    monkeypatch.setattr(cli, "write_ckpt_step", real)
    assert len(_metrics(_exp(tmp_path / "a"))) == 1
    resumed = Path(cli.main(["train"] + args + [f"--outputpath={tmp_path / 'a'}",
                                                "--resume=true"]))
    straight = Path(cli.main(["train"] + args + [f"--outputpath={tmp_path / 'b'}"]))
    a, b = (torch.load(d / "last.pt", weights_only=True) for d in (resumed, straight))
    assert a["step"] == b["step"] == 8
    for k, v in b["state_dict"].items():
        assert torch.equal(a["state_dict"][k], v), k
    oa, ob = a["optimizer"]["state"], b["optimizer"]["state"]
    assert oa.keys() == ob.keys() and len(ob) > 0
    for i in ob:
        for k in ob[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    ma, mb = _metrics(resumed), _metrics(straight)
    assert len(ma) == len(mb) == 2
    for x, y in zip(ma, mb):
        x.pop("epoch_wall_s"), y.pop("epoch_wall_s")
        assert x == y
    assert "resumed from" in (resumed / "train_caption.log").read_text()


# the train keys the port runs now, run together once: a first epoch stopped
# by fault_abort_step at step 3, then resumed; each case of the old refusal
# list reads its own part
RUNS = "runs"
LATER = [("distributed", "true", RUNS), ("model_parallel", "2", RUNS),
         ("kl_anneal", "{mode: cyclical, cycles: 1, floor: 0.2}", RUNS),
         # the discriminator dir is read as the JAX CLI reads its config
         ("adverse_loss", "{discriminator: d}", (FileNotFoundError, "config")),
         ("use_aug_prob", "0.5", RUNS),
         # a missing file raises as the JAX CLI's torch.load does
         ("pretrained_encoder", "x.pth", (FileNotFoundError, "x.pth")),
         ("checkpoint_every_steps", "2", RUNS),
         ("fault_abort_step", "3", RUNS),
         # the first train batch reads its captions' embeddings
         ("embedding_path", "e", (FileNotFoundError, r"e/.*\.npy")),
         ("profile_dir", "p", RUNS),
         # no train of the JAX package reads decode_dtype: accepted, ignored
         ("decode_dtype", "bfloat16", None),
         ("upload_dtype", "float16",
          (ValueError, "upload_dtype must be float32 or bfloat16, got 'float16'")),
         ("scheduler", "ReduceLROnPlateau", RUNS)]


@pytest.fixture(scope="module")
def later_run(ws, tmp_path_factory):
    """One epoch with every RUNS key of LATER: stopped at step 3 (after the
    step-2 snapshot), then ``--resume=true``.  Returns the experiment dir
    and what the stopped run left: its SystemExit message, ckpt_steps.json,
    files and traces."""
    out = tmp_path_factory.mktemp("later")
    keys = {k: v for k, v, item in LATER if item == RUNS}
    args = (["train", str(ws / "port.yaml"), "--device=cpu", "--epochs=1",
             f"--outputpath={out}", f"--profile_dir={out}/prof"]
            + [f"--{k}={v}" for k, v in keys.items()
               if k not in ("fault_abort_step", "profile_dir")])
    with pytest.raises(SystemExit) as e:
        cli.main(args + [f"--fault_abort_step={keys['fault_abort_step']}"])
    exp = _exp(out)
    stopped = {"msg": str(e.value), "steps": tckpt.read_ckpt_steps(str(exp)),
               "files": set(os.listdir(exp)),
               "traces": list((out / "prof").glob("*.json"))}
    cli.main(args + ["--resume=true"])
    return exp, stopped


def _check_later_run(key, exp, stopped):
    """What the run shows of ``key``, against the JAX package's functions."""
    meta = json.loads((exp / "ckpt_steps.json").read_text())
    (metrics,) = _metrics(exp)
    if key in ("distributed", "model_parallel"):
        # one device: JAX's single-device line, no mesh, whatever the split
        log = (exp / "train_caption.log").read_text()
        assert log.count("distributed=true with a single device: running "
                         "unsharded") == 2 and "mesh" not in log
        assert json.loads((exp / "config.json").read_text())[key] in (True, 2)
    elif key == "kl_anneal":
        assert metrics["kl_weight"] == kl_weight_schedule(
            1, 1, 1.5, mode="cyclical", cycles=1, floor=0.2) == 0.2
    elif key == "checkpoint_every_steps":
        assert stopped["steps"]["step_1"] == 2 and "step_1.pt" in stopped["files"]
        assert not any(n.startswith("step") for n in os.listdir(exp))
        assert not any(k.startswith("step") for k in meta)
    elif key == "fault_abort_step":
        assert stopped["msg"] == "fault_abort_step: injected failure at step 3"
        log = (exp / "train_caption.log").read_text()
        assert "at step 2 → epoch 1 (skipping 2 consumed batches)" in log
        assert meta["last"] == 4
    elif key == "profile_dir":
        # the stopped run's trace (closed on the way out), then the resumed one's
        assert len(stopped["traces"]) == 1
        traces = list((exp.parents[2] / "prof").glob("*.json"))
        assert len(traces) == 2
        assert "traceEvents" in json.loads(traces[0].read_text())
    elif key == "use_aug_prob":
        # no caption of this corpus is tagged "aug": every one kept, so the
        # loss is the label-smoothed CE over every token, and finite
        conf = json.loads((exp / "config.json").read_text())
        assert conf["use_aug_prob"] == 0.5 and math.isfinite(metrics["train_loss"])
    elif key == "scheduler":
        # the first epoch always improves on no score at all
        assert meta["plateau_scale"] == 1.0 and meta["plateau_num_bad"] == 0
        assert meta["plateau_best"] == metrics["val_cider"]


@pytest.mark.parametrize("key,value,item", LATER, ids=[k for k, _, _ in LATER])
def test_train_refuses_later_items(ws, key, value, item, tmp_path, request):
    """The keys of the former refusal list: each fails as the JAX CLI fails
    or runs (``later_run``) as it runs; ``distributed`` and
    ``model_parallel`` on one device run unsharded."""
    if item is None:
        conf = load_config(str(ws / "port.yaml"), **{key: value})
        cli.check_free_bits(conf)
        assert cli._upload_dtype(conf) is None
        return
    if item == RUNS:
        _check_later_run(key, *request.getfixturevalue("later_run"))
        return
    exc, match = (NotImplementedError, item) if isinstance(item, str) else item
    with pytest.raises(exc, match=match):
        cli.main(["train", str(ws / "port.yaml"), "--device=cpu",
                  f"--{key}={value}", f"--outputpath={tmp_path / 'out'}"])
    if exc is NotImplementedError:
        assert not (tmp_path / "out").exists()


def test_train_uploads_bf16_rounded_mels(ws, tmp_path, monkeypatch):
    """``upload_dtype: bfloat16``: every train batch reaches the step as the
    mels rounded to bf16 (cast on the host), float32 on the device."""
    seen = []
    real_stage, real_step = cli._to_device, Trainer.step

    def stage(batch, *a, **k):
        out = real_stage(batch, *a, **k)
        seen.append((batch.feats, k.get("feats_dtype"), out.feats))
        return out
    fed = []

    def step(self, batch, *a, **k):
        fed.append(batch["feats"])
        return real_step(self, batch, *a, **k)
    monkeypatch.setattr(cli, "_to_device", stage)
    monkeypatch.setattr(Trainer, "step", step)
    cli.main(["train", str(ws / "port.yaml"), "--device=cpu", "--epochs=1",
              "--upload_dtype=bfloat16", f"--outputpath={tmp_path}"])
    train = [(raw, out) for raw, dt, out in seen if dt == torch.bfloat16]
    assert len(train) == len(fed) == 4
    for (raw, out), got in zip(train, fed):
        want = torch.from_numpy(raw).to(torch.bfloat16).float()
        assert out.dtype == torch.float32 and torch.equal(out, want)
        assert got is out
    assert any(not torch.equal(out, torch.from_numpy(raw)) for raw, out in train)


@pytest.mark.parametrize("kwargs,item", [
    ({"decode_method": "dbs", "beam_size": 2, "group_size": 4},
     (ValueError, "beam_size >= group_size")),
    ({"method": "dbs", "beam_size": 2, "group_size": 4},
     (ValueError, "beam_size >= group_size")),
    ({"decode_dtype": "bfloat16"}, None),
    ({"distributed": True}, "unsharded")],
    ids=["dbs", "dbs_alias", "decode_dtype", "distributed"])
def test_evaluate_refuses_later_items(ws, experiments, kwargs, item):
    """What JAX refuses, the port refuses with the same error; a bf16
    decode runs and names its files as JAX names them."""
    jax_exp, port_exp = experiments
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"), **kwargs)
    if item is None:
        before = {p: set(os.listdir(p)) for p in (jax_exp, port_exp)}
        Runner().evaluate(str(jax_exp), **kw)
        scores = cli.evaluate(str(port_exp), device="cpu", **kw)
        new = {p: set(os.listdir(p)) - before[p] for p in before}
        assert new[port_exp] == new[jax_exp] == {
            "eval_output_beam_3_bfloat16.json", "scores_beam_3_bfloat16.txt"}
        assert math.isfinite(scores["CIDEr"])
        return
    if item == "unsharded":
        # one device: the plain decode's files, byte for byte
        out = {}
        kw.pop("distributed")
        for dist in (False, True):
            cli.evaluate(str(port_exp), device="cpu", distributed=dist, **kw)
            out[dist] = [(port_exp / f).read_bytes() for f in (
                "eval_output_beam_3.json", "scores_beam_3.txt")]
        assert out[True] == out[False]
        return
    for run in (lambda: Runner().evaluate(str(jax_exp), **kw),
                lambda: cli.evaluate(str(port_exp), device="cpu", **kw)):
        with pytest.raises(item[0], match=item[1]):
            run()


def test_method_alias_and_no_card(ws):
    assert cli._method_alias(None, None) == "beam"
    assert cli._method_alias("greedy", None) == "greedy"
    with pytest.raises(ValueError, match="conflicting"):
        cli._method_alias("greedy", "beam")
    with pytest.raises(SystemExit):
        cli.main(["nope"])
    if not torch.cuda.is_available():
        for argv in (["train", str(ws / "port.yaml")],
                     ["make_synthetic", "/nonexistent/x"]):
            with pytest.raises(RuntimeError, match="CUDA card.*--device=cpu"):
                cli.main(argv)
    # a config setting the TPU-only max_inflight_steps is accepted
    conf = load_config(str(ws / "port.yaml"), max_inflight_steps="64")
    cli.check_free_bits(conf)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def test_criterion_improver_matches_jax():
    seq = [0.3, 0.1, 0.5, 0.5, 0.7, -1.0]
    for mode in ("loss", "acc", "score"):
        for initial in (None, 0.4):
            a = tckpt.criterion_improver(mode, initial)
            b = jckpt.criterion_improver(mode, initial)
            assert a.best == b.best
            for x in seq:
                assert a(x) == b(x) and a.best == b.best
    with pytest.raises(ValueError):
        tckpt.criterion_improver("bleu")


def test_ckpt_steps_and_fallbacks(tmp_path, caplog):
    exp = str(tmp_path)
    assert tckpt.read_ckpt_steps(exp) == {}
    tckpt.write_ckpt_step(exp, "last", 12, best_score=0.25)
    tckpt.write_ckpt_step(exp, "best", 9)
    assert tckpt.read_ckpt_steps(exp) == {"last": 12, "best_score": 0.25, "best": 9}
    assert not list(tmp_path.glob("*.tmp"))
    (tmp_path / "best.pt").write_bytes(b"x")
    tckpt.remove_checkpoint(exp, "best")
    assert not (tmp_path / "best.pt").exists()
    assert tckpt.read_ckpt_steps(exp) == {"last": 12, "best_score": 0.25}
    (tmp_path / "ckpt_steps.json").write_text('{"last": 1')     # torn
    assert tckpt.read_ckpt_steps(exp) == {}
    assert tckpt.resume_newest(exp, None) == (None, None)
    (tmp_path / "last.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="could not be read"):
        tckpt.resume_newest(exp, None)
    assert tckpt._resolve_checkpoint_path(exp, "best").name == "last.pt"
    assert tckpt._resolve_checkpoint_path(exp, "other").name == "other.pt"


# --------------------------------------------------------------------- #
# evaluate: the JAX experiment, converted, captions identically
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def experiments(ws, tmp_path_factory):
    """A tiny flagship in JAX over the corpus's vocabulary, BatchNorm
    statistics made non-trivial, written with ``save_checkpoint``; the port
    experiment made from it by ``load_raw_checkpoint`` +
    ``experiment_from_flax``."""
    root = tmp_path_factory.mktemp("eval")
    jvocab = JVocabulary.load(str(ws / "vocab.pkl"))
    V, F = len(jvocab), 64
    conf = flagship_conf(**dict(SMALL, data_dim=F), h5_csv=str(ws / "h5.csv"),
                         caption_file=str(ws / "text.json"))
    model = j_build_model(conf, V, F)
    rng = np.random.default_rng(6)
    variables = jax.jit(lambda k1, k2: model.init(
        {"params": k1, "sample": k2}, np.zeros((2, 64, F), np.float32),
        np.array([64, 40]), np.ones((2, 6), np.int32), np.array([6, 4]),
        train=False))(jax.random.key(2), jax.random.key(3))
    variables = jax.tree_util.tree_map(np.array, variables)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        name = jax.tree_util.keystr(path)
        leaf[...] = (rng.uniform(0.5, 2.0, leaf.shape) if "var" in name
                     else rng.normal(-3.0, 0.3, leaf.shape))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adam(1e-3))
    jckpt.save_checkpoint(str(root / "jax"), "best", state, jvocab, dict(conf))
    tree = jckpt.load_raw_checkpoint(str(root / "jax"), "best",
                                     subset=("params", "batch_stats"))
    path = experiment_from_flax(tree, load_config(str(root / "jax/config.yaml")),
                                Vocabulary.load(str(root / "jax/vocab.pkl")),
                                str(root / "port"))
    assert path == root / "port" / "best.pt"
    return root / "jax", root / "port"


def _eval_files(exp, suffix=""):
    out = json.loads((exp / f"eval_output_beam_3{suffix}.json").read_text())
    return out["predictions"], (exp / f"scores_beam_3{suffix}.txt").read_text()


def test_evaluate_matches_jax(ws, experiments, fixed_eps):
    jax_exp, port_exp = experiments
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"))
    ref = Runner().evaluate(str(jax_exp), **kw)
    ours = cli.evaluate(str(port_exp), device="cpu", **kw)
    assert ours == ref
    preds, scores = _eval_files(port_exp)
    assert (preds, scores) == _eval_files(jax_exp)
    assert len(preds) == 16 and any(p["caption"] for p in preds)
    assert scores.splitlines()[0].startswith("Bleu_1: ")
    # the .npz manifest of the same arrays gives the same captions
    cli.evaluate(str(port_exp), device="cpu", tag="npz",
                 eval_h5_csv=str(ws / "mels.csv"),
                 eval_caption_file=str(ws / "text.json"))
    assert _eval_files(port_exp, "_npz")[0] == preds


def test_evaluate_int8_matches_jax(ws, experiments, fixed_eps, monkeypatch):
    """Each side calibrates v2sym on the first eval batch; if the two
    calibrations disagree on any code, the count is reported and the port
    runs again with the JAX encoder carried across."""
    import warnings

    jax_exp, port_exp = experiments
    baked = {}
    make_j, make_p = jquant.quant_encoder_for, cli.quant_encoder_for

    def port_make(*a, **k):
        baked["pq"] = make_p(*a, **k)
        baked["calib"] = tuple(t.cpu().numpy() for t in k["calib"])
        return baked["pq"]
    monkeypatch.setattr(jquant, "quant_encoder_for", lambda *a, **k:
                        baked.setdefault("jq", make_j(*a, **k)))
    monkeypatch.setattr(cli, "quant_encoder_for", port_make)
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"), encoder_int8=True)
    ref = Runner().evaluate(str(jax_exp), **kw)
    ours = cli.evaluate(str(port_exp), device="cpu", **kw)
    flipped = _flipped_codes(baked["pq"], baked["jq"], *baked["calib"])
    if flipped:
        warnings.warn(f"int8 v2sym: the two calibrations differ in {flipped} "
                      f"codes; captions compared with the JAX scales carried "
                      f"across")
        monkeypatch.setattr(cli, "quant_encoder_for", lambda *a, **k:
                            quant_from_flax(jax_baked(baked["jq"]), device="cpu"))
        ours = cli.evaluate(str(port_exp), device="cpu", **kw)
    assert ours == ref
    assert _eval_files(port_exp, "_int8") == _eval_files(jax_exp, "_int8")


# --------------------------------------------------------------------- #
# diverse captioning: evaluate --decode_method=dbs, diversity, predict,
# ensemble, human_eval
# --------------------------------------------------------------------- #
DBS_KW = dict(decode_method="dbs", beam_size=8, group_size=4)


def _jax_model(jax_exp):
    """The JAX flagship of an experiment dir and its variables."""
    conf = load_config(str(jax_exp / "config.yaml"))
    V = len(JVocabulary.load(str(jax_exp / "vocab.pkl")))
    tree = jckpt.load_raw_checkpoint(str(jax_exp), "best",
                                     subset=("params", "batch_stats"))
    return j_build_model(conf, V, 64), tree


def _feed_jax_dbs_noise(monkeypatch, jax_exp, batch_sizes, seed=1, T=20):
    """The port's dbs draws replaced by the JAX runner's: its key split once
    a batch, each group's slab drawn as the JAX model draws it."""
    model, tree = _jax_model(jax_exp)
    G, bdash = DBS_KW["group_size"], DBS_KW["beam_size"] // DBS_KW["group_size"]
    key, slabs = jax.random.key(seed), []
    for n in batch_sizes:
        key, sub = jax.random.split(key)
        slabs += list(jax_dbs_eps(model, tree, sub, G, T + G - 1, n * bdash))
    assert not np.array_equal(slabs[0], slabs[1])

    def eps_stack(steps, rows, dim, generator=None, device=None, dtype=None):
        e = slabs.pop(0)
        assert e.shape == (steps, rows, dim)
        return torch.tensor(e, device=device)
    monkeypatch.setattr(tvae, "eps_stack", eps_stack)
    return slabs


def _carry_jax_bake(monkeypatch):
    """JAX's int8 encoder records itself; the port's is JAX's, carried
    across (the two calibrations' conv sums are ordered differently)."""
    baked = {}
    make_j = jquant.quant_encoder_for
    monkeypatch.setattr(jquant, "quant_encoder_for", lambda *a, **k:
                        baked.setdefault("jq", make_j(*a, **k)))
    monkeypatch.setattr(cli, "quant_encoder_for", lambda *a, **k:
                        quant_from_flax(jax_baked(baked["jq"]), device="cpu"))


def _dbs_files(exp, suffix=""):
    out = json.loads((exp / f"eval_output_dbs_8{suffix}.json").read_text())
    return out["predictions"], (exp / f"scores_dbs_8{suffix}.txt").read_text()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_evaluate_dbs_matches_jax(ws, experiments, monkeypatch, int8):
    """Every output beam a candidate (8 a clip), identical files; the first
    candidate scored.  ``--num_candidates`` is ignored for dbs."""
    jax_exp, port_exp = experiments
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"), encoder_int8=int8,
              num_candidates=3, **DBS_KW)
    if int8:
        _carry_jax_bake(monkeypatch)
    ref = Runner().evaluate(str(jax_exp), **kw)
    left = _feed_jax_dbs_noise(monkeypatch, jax_exp, [16])
    ours = cli.evaluate(str(port_exp), device="cpu", **kw)
    assert left == []
    assert ours == ref
    suffix = "_int8" if int8 else ""
    preds, scores = _dbs_files(port_exp, suffix)
    assert (preds, scores) == _dbs_files(jax_exp, suffix)
    assert len(preds) == 16 and all(len(p["captions"]) == 8 for p in preds)


def test_diversity_matches_jax(ws, experiments, tmp_path, monkeypatch):
    """On the dbs eval output (several candidates a clip) with the train
    corpus, and on a beam output (one a clip): identical results and
    files."""
    jax_exp, port_exp = experiments
    dbs = port_exp / "eval_output_dbs_8.json"
    if not dbs.exists():
        kw = dict(eval_h5_csv=str(ws / "mels.csv"),
                  eval_caption_file=str(ws / "text.json"), **DBS_KW)
        cli.evaluate(str(port_exp), device="cpu", **kw)
    beam = tmp_path / "beam.json"
    beam.write_text(json.dumps({"predictions": [
        {"filename": f"a{i}", "caption": c, "tokens": c}
        for i, c in enumerate(["A dog, barking!", "a dog barks", "rain"])]}))
    for src, corpus in ((dbs, str(ws / "text.json")), (beam, None)):
        ref = Runner().diversity(str(src), corpus, output=str(tmp_path / "j.txt"))
        ours = cli.diversity(str(src), corpus, output=str(tmp_path / "p.txt"))
        assert ours == ref
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert {"Div1", "Div2", "gDiv1", "mBLeu_4", "SelfBLEU", "Novelty"} <= set(
        cli.diversity(str(dbs), str(ws / "text.json")))


def test_predict_matches_jax(ws, experiments, fixed_eps, tmp_path):
    jax_exp, port_exp = experiments
    for method in ("beam", "dbs"):
        kw = dict(decode_method=method, beam_size=8 if method == "dbs" else 3)
        ref = Runner().predict(str(jax_exp), str(ws / "h5.csv"),
                               output=str(tmp_path / "j.csv"), **kw)
        ours = cli.predict(str(port_exp), str(ws / "h5.csv"), device="cpu",
                           output=str(tmp_path / "p.csv"), **kw)
        assert (Path(ours).read_bytes() == Path(ref).read_bytes()), method
    rows = (tmp_path / "p.csv").read_text().splitlines()
    assert rows[0] == "file_name,caption_predicted" and len(rows) == 17


def test_ensemble_matches_jax(ws, experiments, monkeypatch):
    """``ensemble <exp> <exp> --checkpoint=best``: the JAX runner's draws
    (key split once a batch, member m's from fold_in(key, m)); the scores
    file lands in the first member's dir."""
    jax_exp, port_exp = experiments
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"), checkpoint="best")
    ref = Runner().ensemble(str(jax_exp), str(jax_exp), **kw)
    key = {"k": jax.random.key(1)}
    real = cli.ensemble_decode

    def fed(members, feats, lens, generator=None, **k):
        key["k"], sub = jax.random.split(key["k"])
        eps = member_eps(sub, len(members), k["max_length"],
                         feats.shape[0] * k["beam_size"])
        return real(members, feats, lens, eps=[torch.tensor(e) for e in eps], **k)
    monkeypatch.setattr(cli, "ensemble_decode", fed)
    ours = cli.main(["ensemble", str(port_exp), str(port_exp), "--device=cpu",
                     f"--eval_h5_csv={ws / 'h5.csv'}",
                     f"--eval_caption_file={ws / 'text.json'}",
                     "--checkpoint=best"])
    assert ours == ref
    assert ((port_exp / "ensemble_scores.txt").read_text()
            == (jax_exp / "ensemble_scores.txt").read_text())


def test_human_eval_matches_jax(ws, tmp_path):
    ref = Runner().human_eval(str(ws / "text.json"), output=str(tmp_path / "j.txt"))
    ours = cli.human_eval(str(ws / "text.json"), output=str(tmp_path / "p.txt"))
    assert ours == ref and set(ours) >= {"Bleu_4", "CIDEr", "Div1", "mBLeu_4"}
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


# --------------------------------------------------------------------- #
# the card's installation: no PyYAML, h5py, pandas or nltk
# --------------------------------------------------------------------- #
BLOCKED_RUN = """
import sys
for m in ("yaml", "h5py", "pandas", "nltk"):
    sys.modules[m] = None
from acvae_tpu_torch.cli.main import main
d = sys.argv[1]
main(["make_synthetic", d, "--rich", "--num_audios=8", "--mel_frames=96",
      "--device=cpu"])
open(d + "/c.yaml", "w").write(open(sys.argv[2]).read().replace(
    sys.argv[3], d))
exp = main(["train", d + "/c.yaml", "--device=cpu", "--epochs=1"])
main(["evaluate", exp, "--device=cpu", "--checkpoint=last"])
main(["evaluate", exp, "--device=cpu", "--checkpoint=last", "--encoder_int8"])
main(["evaluate", exp, "--device=cpu", "--checkpoint=last",
      "--decode_method=dbs", "--beam_size=4", "--group_size=2"])
main(["diversity", exp + "/eval_output_dbs_4.json", d + "/text.json",
      "--device=cpu", "--output=" + d + "/div.txt"])
main(["predict", exp, d + "/mels.csv", "--device=cpu", "--checkpoint=last",
      "--output=" + d + "/pred.csv"])
bad = [m for m in ("yaml", "h5py", "pandas", "nltk", "jax", "acvae_tpu")
       if sys.modules.get(m) is not None]
assert not bad, bad
print("BLOCKED_OK")
"""


def test_cli_runs_without_yaml_h5py_pandas_nltk(ws, tmp_path):
    # one intra-op thread, as the module's own tests run (one_torch_thread)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(tmp_path),
                        str(ws / "port.yaml"), str(ws)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0 and "BLOCKED_OK" in r.stdout, r.stderr[-3000:]
    exp = _exp(tmp_path / "port_out")
    assert (exp / "scores_beam_3.txt").exists()
    assert (exp / "scores_beam_3_int8.txt").exists()
    assert "SelfBLEU: " in (tmp_path / "div.txt").read_text()
    assert len((tmp_path / "pred.csv").read_text().splitlines()) == 9


def test_python_dash_m_runs(ws, tmp_path):
    (tmp_path / "t.json").write_text((ws / "text.json").read_text())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "acvae_tpu_torch.cli", "build_vocab",
                        str(tmp_path / "t.json"), str(tmp_path / "v.pkl"),
                        "--device=cpu"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "vocabulary size" in r.stdout
    assert (Vocabulary.load(str(tmp_path / "v.pkl")).word2idx
            == Vocabulary.load(str(ws / "vocab.pkl")).word2idx)
