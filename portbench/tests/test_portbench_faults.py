"""A run with the timed path broken underneath must come out not correct.

Each test drives ``run.py`` on the CPU at test widths (the harness's look
for a card answered by a stand-in) with one fault planted in the port:
a step that returns its state unchanged, half of the batch left out (the
mean taken over the rest), or a token altered where it is produced.  The
cells run on one card, so no exchange between cards can be left out.
The same runs without a fault come out correct, and the control (the
reference one precision lower in the program's place) fails the limits.
"""
from __future__ import annotations

import pytest

from conftest import BENCH, REPO, TINY_SEED, tiny_conf, tiny_mix
from portbench import common
from portbench.faults import FAULTS

SERVE = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("serve")]
TRAIN = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("train")]


CASES = ([(c, f) for c in SERVE for f in FAULTS["serve"]]
         + [(c, f) for c in TRAIN for f in FAULTS["train"]])


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(run_cell, cell):
    code, res, _ = run_cell(cell)
    assert code == 0 and res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(run_cell, monkeypatch, cell, fault):
    FAULTS["train" if cell in TRAIN else "serve"][fault](monkeypatch.setattr)
    code, res, err = run_cell(cell)
    assert code == 0 and res["correct"] is False, res["checks"]
    assert "limit" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_the_control_fails_the_limits(cell):
    """The reference one precision lower (int4 or float8 encoder and a TF32
    decode; bf16 on the train step's decode side) in the program's place."""
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    conf_file = {c["name"]: c["file"] for c in BENCH["configs"]}[w["config"]]
    conf = tiny_conf(common.load_json(REPO / conf_file))
    mix = tiny_mix(common.load_json(REPO / f"portbench/mixes/{w['traffic']}.json"))
    limits = common.load_json(REPO / f"portbench/limits/{cell}.json")
    cell_ = common.load_module(REPO / f"portbench/drivers/{mix['driver']}.py").Cell(
        conf, mix, TINY_SEED, "cpu")
    cell_.setup()
    cell_.window(0.2)
    got = cell_.judge(cell_.collect(), control=True)
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cuda_card):
    """Cell 1's control at its own size on the card (a short window)."""
    w = BENCH["workloads"][0]
    conf = common.load_json(REPO / "portbench/configs/acvae_cnn10.json")
    mix = common.load_json(REPO / f"portbench/mixes/{w['traffic']}.json")
    limits = common.load_json(REPO / f"portbench/limits/{w['name']}.json")
    cell = common.load_module(REPO / "portbench/drivers/serve_offline.py").Cell(
        conf, mix, TINY_SEED, "cuda")
    cell.setup()
    cell.window(1.0)
    s = cell.collect()
    assert all(v <= limits[k] for k, v in cell.judge(s).items())
    assert any(v > limits[k] for k, v in cell.judge(s, control=True).items())


@pytest.mark.parametrize("fault", list(FAULTS["train"]))
def test_a_path_switched_after_set_up_is_not_correct(monkeypatch, fault):
    """The checked first steps run sound; the fault takes over from the
    window on, as a path switched after warm-up would: the window's checked
    step must catch it."""
    cell = TRAIN[0]
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    conf_file = {c["name"]: c["file"] for c in BENCH["configs"]}[w["config"]]
    conf = tiny_conf(common.load_json(REPO / conf_file))
    mix = tiny_mix(common.load_json(REPO / f"portbench/mixes/{w['traffic']}.json"))
    limits = common.load_json(REPO / f"portbench/limits/{cell}.json")
    cell_ = common.load_module(REPO / f"portbench/drivers/{mix['driver']}.py").Cell(
        conf, mix, TINY_SEED, "cpu")
    cell_.setup()
    FAULTS["train"][fault](monkeypatch.setattr)
    cell_.window(0.0)
    got = cell_.judge(cell_.collect())
    first = ("loss_err", "grad_err", "update_err")
    assert all(got[k] <= limits[k] for k in first), got
    assert any(got[k] > limits[k] for k in limits if k not in first), got
