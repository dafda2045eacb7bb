"""Port parity: ``cli sweep`` and its advisors (``train/sweep_advisor.py``)
against ``acvae_tpu``.

The advisors must suggest the same overrides in the same order for the same
space, seed and history, and the assessor must make the same stop decisions
(exact equality; the cases of ``tests/test_utils_cli.py`` run on both
packages).  The sweep loop runs with both packages' ``train`` stubbed, as
``tests/test_utils_cli.py`` stubs ``Runner.train``: the calls, the results
and the printed summary must be JAX's.  Then two real sweeps with
``--device=cpu`` on a tiny workspace (Cnn10 channels 4-8-8-16, embed 16, 12
clips of 64 frames): an ``--isolate_trials`` one whose children are checked
to run with ``--device=cpu``, and an in-process one in which the median
assessor stops a trial after its saves.
"""
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest

import acvae_tpu.train.sweep_advisor as jadv
from acvae_tpu.cli.main import Runner
import acvae_tpu_torch.train.sweep_advisor as tadv
from acvae_tpu_torch.cli import main as cli
from tests.test_torch_decode import one_torch_thread  # noqa: F401

SPACE = {"beta": [0.1, 0.3, 0.5, 0.7, 0.9], "smoothing": [0.05, 0.1, 0.3],
         "optimizer_args.lr": [1e-4, 5e-4]}


def objective(o):
    """The stub's score: a peak at beta 0.5, smoothing 0.1."""
    return (1.0 - abs(o.get("beta", 0) - 0.5)
            - abs(o.get("smoothing", 0) - 0.1))


def run_advisor(mod, kind, seed, steps=14):
    adv = (mod.TPEAdvisor(SPACE, seed=seed) if kind == "tpe"
           else mod.AnnealAdvisor(SPACE, seed=seed, n_trials=steps))
    hist = []
    for _ in range(steps):
        s = adv.suggest(hist)
        hist.append((s, objective(s)))
    return [h[0] for h in hist]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["tpe", "anneal"])
def test_advisor_suggestions_match_jax(kind, seed):
    """14 suggestions, 9 of them past TPE's 5 random start-up trials."""
    ours, ref = run_advisor(tadv, kind, seed), run_advisor(jadv, kind, seed)
    assert ours == ref
    assert len({json.dumps(o, sort_keys=True) for o in ours}) > 1


def test_tpe_densities_match_jax():
    hist = [({"x": 0}, 1.0), ({"x": 0}, 0.5), ({"x": 1}, 0.2), ({"x": 2}, 0.9)]
    for gamma in (0.25, 0.5):
        ours = tadv.TPEAdvisor({"x": [0, 1, 2]}, gamma=gamma)._densities(hist, "x")
        ref = jadv.TPEAdvisor({"x": [0, 1, 2]}, gamma=gamma)._densities(hist, "x")
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
            assert (a > 0).all() and abs(a.sum() - 1) < 1e-12


def _assessor_script(mod, min_trials, min_epochs, trials):
    """Each trial's per-epoch scores fed in turn (a trial ends at its first
    stop); returns every assess() answer, last_stop and stopped_trials."""
    a = mod.MedianStopAssessor(min_trials=min_trials, min_epochs=min_epochs)
    out = []
    for scores in trials:
        a.trial_begin()
        for s in scores:
            out.append(a.assess(s))
            if out[-1]:
                break
        out.append(("last_stop", a.last_stop))
        a.trial_end()
    return out + [("stopped", a.stopped_trials), ("completed", len(a.histories))]


ASSESSOR_CASES = {
    # (min_trials, min_epochs, trials) — tests/test_utils_cli.py's three
    # cases, and a stopped trial that must not count as completed
    "min_trials": (3, 2, [[0.5, 0.6], [0.4, 0.5], [0.0, 0.0]]),
    "bad_stopped_good_survives": (3, 2, [[0.5, 0.6, 0.7], [0.4, 0.5, 0.6],
                                         [0.45, 0.55, 0.65], [0.1, 0.1],
                                         [0.6, 0.7, 0.8]]),
    "min_epochs": (1, 3, [[0.9, 0.9, 0.9], [0.0, 0.0, 0.0]]),
    "stopped_not_counted": (2, 1, [[0.5, 0.5], [0.0, 0.0], [0.1, 0.1],
                                   [0.6, 0.6], [0.2, 0.2]]),
}


@pytest.mark.parametrize("case", sorted(ASSESSOR_CASES))
def test_median_assessor_decisions_match_jax(case):
    ours = _assessor_script(tadv, *ASSESSOR_CASES[case])
    assert ours == _assessor_script(jadv, *ASSESSOR_CASES[case])
    # every case but the first stops a trial
    assert (True in ours) == (case != "min_trials")


# --------------------------------------------------------------------- #
# the sweep loop, with both packages' train stubbed
# --------------------------------------------------------------------- #
def _stubs(tmp_path, monkeypatch, epochs=1, score_of=objective):
    """Both trains stubbed: each writes metrics.jsonl under <side>/<remark>
    with the score ``score_of`` gives its overrides, asking the package's assessor after each
    epoch as the real loop does.  Returns the calls of each side."""
    calls = {"jax": [], "port": []}

    def fake(side, assessor_of, config, **kw):
        calls[side].append({k: v for k, v in kw.items()
                            if k not in ("remark", "device")})
        d = tmp_path / side / kw["remark"]
        d.mkdir(parents=True, exist_ok=True)
        score, lines = score_of(kw), []
        for e in range(1, epochs + 1):
            lines.append(json.dumps({"epoch": e, "val_cider": score}))
            stopper = assessor_of()
            if stopper is not None and stopper.assess(score):
                break
        (d / "metrics.jsonl").write_text("\n".join(lines) + "\n")
        return str(d)

    monkeypatch.setattr(Runner, "train", lambda self, config, **kw: fake(
        "jax", lambda: getattr(self, "_trial_assessor", None), config, **kw))
    monkeypatch.setattr(cli, "train", lambda config, **kw: fake(
        "port", lambda: cli._TRIAL_ASSESSOR, config, **kw))
    return calls


def _both(tmp_path, monkeypatch, capsys, epochs=1, score_of=objective, **kw):
    calls = _stubs(tmp_path, monkeypatch, epochs, score_of)
    ref = Runner().sweep("cfg.yaml", **kw)
    ref_out = capsys.readouterr()
    ours = cli.sweep("cfg.yaml", device="cpu", **kw)
    out = capsys.readouterr()
    for r in list(ref.values()) + list(ours.values()):
        r["exp_dir"] = Path(r["exp_dir"]).name
    assert ours == ref
    assert calls["port"] == calls["jax"]
    assert (out.out.replace(str(tmp_path / "port"), "")
            == ref_out.out.replace(str(tmp_path / "jax"), ""))
    return ours, calls["port"]


SWEEPS = {
    "param_values": dict(param="beta", values="0.3,0.5,1e-3"),
    "grid": dict(space="{beta: [0.3, 0.5], smoothing: [0.1, 0.2]}"),
    "grid_truncated": dict(space="{beta: [0.3, 0.5], smoothing: [0.1, 0.2]}",
                           n_trials=3),
    "random": dict(space="{beta: [0.1, 0.5, 0.9], smoothing: [0.1]}",
                   mode="random", n_trials=5, seed=3),
    "tpe": dict(space="{beta: [0.1, 0.3, 0.5, 0.7, 0.9], "
                      "smoothing: [0.05, 0.1, 0.3]}",
                mode="tpe", n_trials=14, seed=1),
    "anneal": dict(space="{beta: [0.1, 0.3, 0.5, 0.7, 0.9], "
                         "smoothing: [0.05, 0.1, 0.3]}",
                   mode="anneal", n_trials=12, seed=2),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_loop_matches_jax(case, tmp_path, monkeypatch, capsys):
    results, calls = _both(tmp_path, monkeypatch, capsys, **SWEEPS[case])
    want = {"param_values": 3, "grid": 4, "grid_truncated": 3, "random": 5,
            "tpe": 14, "anneal": 12}[case]
    assert len(calls) == len(results) == want


def test_sweep_space_file_and_dict(tmp_path, monkeypatch, capsys):
    """--space as a YAML file, and as the mapping cli.main has already read
    from the flag: the same trials as JAX's file."""
    space = tmp_path / "space.yaml"
    space.write_text("beta: [0.3, 0.5]\nsmoothing: [1e-1, 0.2]\n")
    results, _ = _both(tmp_path, monkeypatch, capsys, space=str(space))
    assert [r["params"] for r in results.values()][0] == {"beta": 0.3,
                                                           "smoothing": 0.1}
    calls = _stubs(tmp_path / "main", monkeypatch)
    cli.main(["sweep", "cfg.yaml", "--space={beta: [0.3, 0.5], "
              "smoothing: [1e-1, 0.2]}", "--device=cpu"])
    assert [c for c in calls["port"]] == [r["params"] for r in results.values()]


def test_sweep_median_assessor_matches_jax(tmp_path, monkeypatch, capsys):
    """tests/test_utils_cli.py's wiring case on both packages: the 0.05
    trial stops at epoch 2 and is marked stopped_early (the score is the
    trial's beta, constant over its epochs)."""
    results, _ = _both(tmp_path, monkeypatch, capsys, epochs=5,
                       score_of=lambda kw: kw["beta"], param="beta",
                       values="0.6,0.62,0.61,0.05,0.63", assessor="median",
                       assessor_min_trials=3, assessor_min_epochs=2)
    lines = {tag: len((tmp_path / "port" / f"sweep_{tag}" / "metrics.jsonl")
                      .read_text().splitlines()) for tag in results}
    assert list(lines.values()) == [5, 5, 5, 2, 5]
    stopped = [t for t, r in results.items() if r.get("stopped_early")]
    assert len(stopped) == 1 and "0.05" in stopped[0]


REJECTIONS = {
    "bad_space": (dict(space="{beta: 0.5}"), ValueError, "search space"),
    "no_param_values": (dict(), ValueError, "--param/--values"),
    "unknown_assessor": (dict(param="beta", values="0.5", assessor="curve"),
                         ValueError, "unknown --assessor"),
    "tpe_without_space": (dict(param="beta", values="0.5", mode="tpe"),
                          ValueError, "needs a --space"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_sweep_rejections_match_jax(case, tmp_path, monkeypatch):
    kw, exc, match = REJECTIONS[case]
    calls = _stubs(tmp_path, monkeypatch)
    with pytest.raises(exc, match=match):
        Runner().sweep("cfg.yaml", **kw)
    with pytest.raises(exc, match=match):
        cli.sweep("cfg.yaml", device="cpu", **kw)
    assert calls == {"jax": [], "port": []}


def test_sweep_warnings_match_jax(tmp_path, monkeypatch, capsys):
    """A swept key the merged config lacks, and trials with different
    overrides but byte-identical trajectories: the same two warnings."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("beta: 1.0\noptimizer_args: {lr: 0.001}\n")
    _stubs(tmp_path, monkeypatch)
    warnings = []
    for run in (lambda: Runner().sweep(str(cfg), param="lr", values="0.1,0.2"),
                lambda: cli.sweep(str(cfg), param="lr", values="0.1,0.2",
                                  device="cpu")):
        run()
        warnings.append([line for line in capsys.readouterr().err.splitlines()
                         if line.startswith("# WARNING")])
    assert warnings[0] == warnings[1] and len(warnings[0]) == 2
    assert "'lr' is not present" in warnings[0][0]
    assert "byte-identical" in warnings[0][1]


# --------------------------------------------------------------------- #
# real sweeps on the CPU
# --------------------------------------------------------------------- #
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
h5_csv: {root}/mels.csv
caption_file: {root}/text.json
vocab_file: {root}/vocab.pkl
outputpath: {root}/out
epochs: 1
batch_size: 8
train_percent: 75
scheduler_args: {{final_lr: 1.0e-05, warmup_iters: 3000}}
augments: [timemask, freqmask]
"""


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=12",
              "--mel_frames=64", "--device=cpu"])
    (root / "tiny.yaml").write_text(TINY.format(root=root))
    return root


def test_isolated_sweep_children_run_on_the_cpu(ws, monkeypatch):
    """--isolate_trials: each trial is `python -m acvae_tpu_torch.cli train`
    in the repo root with --device=cpu and no card visible; the parent finds
    each trial's experiment dir where train wrote it."""
    started = []
    real = subprocess.Popen

    def popen(argv, **kw):
        started.append((argv, kw))
        return real(argv, **kw)
    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(cli, "TRIAL_POLL_S", 0.5)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = cli.main(["sweep", str(ws / "tiny.yaml"), "--param=beta",
                    "--values=0.5,0.4", "--isolate_trials=true", "--device=cpu"])
    assert len(res) == len(started) == 2
    root = Path(cli.__file__).resolve().parents[2]
    for (argv, kw), (tag, r) in zip(started, res.items()):
        assert argv[1:5] == ["-m", "acvae_tpu_torch.cli", "train",
                             str(ws / "tiny.yaml")]
        assert argv[-1] == "--device=cpu" and f"--remark=sweep_{tag}" in argv
        assert kw["cwd"] == str(root) and kw["env"]["CUDA_VISIBLE_DEVICES"] == ""
        exp = Path(r["exp_dir"])
        assert exp == ws / "out" / "Hybrid_VAEModel" / f"sweep_{tag}_{r['params']['beta']}_0.5" / "seed_1"
        assert (exp / "last.pt").exists() and isinstance(r["best"], float)
        assert len((exp / "metrics.jsonl").read_text().splitlines()) == 1
        assert json.loads((exp / "config.json").read_text())["beta"] == r["params"]["beta"]


def test_in_process_sweep_assessor_stops_after_the_saves(ws, monkeypatch):
    """The median rule stops the second trial (its validation score is its
    beta, so 0.1 < 0.9) after epoch 1's saves: best.pt and last.pt of epoch
    1, one metrics line, the log line, stopped_early; the first trial ran
    both epochs."""
    betas, real = [], cli.Trainer

    def trainer(conf, *a, **k):
        betas.append(conf["beta"])
        return real(conf, *a, **k)
    monkeypatch.setattr(cli, "Trainer", trainer)
    monkeypatch.setattr(cli, "_validate", lambda *a, **k: betas[-1])
    res = cli.sweep(str(ws / "tiny.yaml"), param="beta", values="0.9,0.1",
                    epochs=2, assessor="median", assessor_min_trials=1,
                    assessor_min_epochs=1, device="cpu")
    (_, r0), (_, r1) = res.items()
    assert "stopped_early" not in r0 and r1["stopped_early"] is True
    assert (r0["best"], r1["best"]) == (0.9, 0.1)
    steps = []
    for r, epochs in ((r0, 2), (r1, 1)):
        exp = Path(r["exp_dir"])
        assert len((exp / "metrics.jsonl").read_text().splitlines()) == epochs
        assert (exp / "last.pt").exists() and (exp / "best.pt").exists()
        steps.append(json.loads((exp / "ckpt_steps.json").read_text())["last"])
    assert steps[0] == 2 * steps[1] > 0
    log = (Path(r1["exp_dir"]) / "train_caption.log").read_text()
    assert "assessor: trial stopped early at epoch 1" in log
    assert cli._TRIAL_ASSESSOR is None
