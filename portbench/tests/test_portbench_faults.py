"""A run with the timed path broken underneath must come out not correct.

Each test drives ``run.py`` on the CPU at test widths (the harness's look
for a card answered by a stand-in) with one fault planted in the port:
a step that returns its state unchanged, half of the batch left out (the
mean taken over the rest), or a token altered where it is produced; in
the data-parallel cell (2 ranks over gloo here, the fault planted on
every rank) also the exchange between the ranks left out on one rank, and
the losses divided by a rank's own count.  The same runs without a fault
come out correct and count the cell's cards, and the control (the
reference one precision lower in the program's place) fails the limits.
A rank that raises, is killed or hangs ends the run with no result line
within the ranks' timeout."""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import pytest

from conftest import (BENCH, REPO, TESTED, TINY_RANKS, TINY_SEED, fault_cases, tiny_conf,
                      tiny_mix)
from portbench import common, faults
from portbench.faults import FAULTS

SERVE = [w["name"] for w in TESTED["workloads"] if w["traffic"].startswith("serve")]
TRAIN = [w["name"] for w in TESTED["workloads"] if w["traffic"].startswith("train")]
CELLS = {w["name"]: w for w in TESTED["workloads"]}


def _files(cell):
    w = CELLS[cell]
    conf_file = {c["name"]: c["file"] for c in BENCH["configs"]}[w["config"]]
    conf = tiny_conf(common.load_json(REPO / conf_file))
    mix = tiny_mix(common.load_json(REPO / f"portbench/mixes/{w['traffic']}.json"))
    return conf, mix, common.load_json(REPO / f"portbench/limits/{cell}.json")


def _driver(cell):
    return REPO / "portbench" / "drivers" / f"{_files(cell)[1]['driver']}.py"


CASES = fault_cases(TESTED)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(run_cell, cell):
    code, res, _ = run_cell(cell)
    assert code == 0 and res["correct"] is True, res["checks"]
    assert res["device"]["count"] == min(CELLS[cell]["chips"], TINY_RANKS)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(run_cell, monkeypatch, cell, fault):
    faults.plant(_driver(cell), fault, monkeypatch.setattr)
    if CELLS[cell]["chips"] > 1:        # the other ranks too
        monkeypatch.setattr(common, "Ranks", functools.partial(common.Ranks, plant=fault))
    code, res, err = run_cell(cell)
    assert code == 0 and res["correct"] is False, res["checks"]
    assert "limit" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_the_control_fails_the_limits(cell):
    """The reference one precision lower (int4 or float8 encoder and a TF32
    decode; bf16 on the train step's decode side) in the program's place."""
    conf, mix, limits = _files(cell)
    driver = _driver(cell)
    ranks, kw = None, {}
    if CELLS[cell]["chips"] > 1:
        ranks = kw["ranks"] = common.Ranks(TINY_RANKS, driver, conf, mix, "cpu")
    cell_ = common.load_module(driver).Cell(conf, mix, TINY_SEED, "cpu", **kw)
    cell_.setup()
    cell_.window(0.2)
    s = cell_.collect()
    if ranks is not None:
        ranks.close()
    got = cell_.judge(s, control=True)
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
    conf, mix, limits = _files(cell)
    cell_ = common.load_module(REPO / f"portbench/drivers/{mix['driver']}.py").Cell(
        conf, mix, TINY_SEED, "cpu")
    cell_.setup()
    FAULTS["train"][fault](monkeypatch.setattr)
    cell_.window(0.0)
    got = cell_.judge(cell_.collect())
    first = ("loss_err", "grad_err", "update_err")
    assert all(got[k] <= limits[k] for k in first), got
    assert any(got[k] > limits[k] for k in limits if k not in first), got


# run.py in a process of its own, for a run that rank 0 ends with os._exit
RUN_WITH_A_FAILING_RANK = """
import functools, sys, torch
sys.path.insert(0, {root!r})
for name, value in (("is_available", lambda: True), ("device_count", lambda: {ranks}),
                    ("get_device_name", lambda *a: "stand-in"),
                    ("max_memory_allocated", lambda *a: 0)):
    setattr(torch.cuda, name, value)
from portbench import common
common.Ranks = functools.partial(common.Ranks, plant={fault!r}, timeout_s={timeout})
from portbench import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", "{seed}", "--seconds", "0.3",
                   "--trace", "0"], device="cpu"))
"""


@pytest.mark.parametrize("fault", list(FAULTS["ranks"]))
def test_a_failing_rank_ends_the_run_with_no_result(checkout, fault):
    """The last rank raises, is killed, or hangs in its second window step:
    rank 0 ends the run with a non-zero exit and no result line, within
    the ranks' timeout of that step."""
    cell = next(c for c in TRAIN if CELLS[c]["chips"] > 1)
    timeout = 6.0
    code = RUN_WITH_A_FAILING_RANK.format(root=str(checkout), ranks=TINY_RANKS,
                                          fault=fault, timeout=timeout, cell=cell,
                                          seed=TINY_SEED)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=120)
    took = time.perf_counter() - t0
    assert proc.returncode not in (0, None), proc.stderr[-2000:]
    for line in proc.stdout.strip().splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    assert "rank" in proc.stderr
    assert took < 60, took         # process start, set-up, a step and the timeout
