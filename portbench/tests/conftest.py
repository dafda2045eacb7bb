"""Fixtures of the benchmark's CPU tests: tiny copies of the cells (the
same files, widths shrunk so that the port's plain CPU paths run them in
seconds; a cell on several cards runs 2 ranks over gloo), a checkout
holding them, and a run of ``run.py`` on the CPU with the harness's look
for a card answered by a stand-in.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import common  # noqa: E402

BENCH = common.load_json(REPO / "BENCHMARK.json")

# Cells whose files portbench/ holds but which BENCHMARK.json does not
# measure yet (PERF.md, Open questions), with the end-to-end metrics they
# would report: the tests drive them all the same.
PENDING = [({"name": "cnn10.train_dp4_b128", "config": "acvae_cnn10",
             "traffic": "train_dp4_b128", "chips": 4,
             "why": "Trainer.distribute over 4 cards (NCCL), 128 rows a rank"},
            ["train_samples_per_s"])]


def with_pending(bench):
    """``bench`` with the pending cells that it does not hold yet."""
    bench = copy.deepcopy(bench)
    held = {w["name"] for w in bench["workloads"]}
    for cell, e2e in PENDING:
        if cell["name"] not in held:
            bench["workloads"].append(dict(cell))
            for m in bench["end_to_end"]:
                if m["name"] in e2e:
                    m["workloads"].append(cell["name"])
    return bench


TESTED = with_pending(BENCH)       # the cells the tests drive
TINY_SEED = 4_294_967_311          # above 2**32, as the driver's seeds can be
TINY_RANKS = 2                     # the ranks of a cell on several cards here


def tiny_conf(conf):
    """A configuration at test widths: Cnn10 8-16, embed 16, vocab 30."""
    conf = copy.deepcopy(conf)
    conf.update(vocab_size=30, data_dim=16, encodermodel="Cnn10")
    conf["encoder_args"] = {"embed_size": 16, "dtype": "bfloat16",
                            "channels": [8, 16, 16, 16]}
    conf["decoder_args"] = {"embed_size": 16, "hidden_size": 16, "dropout": 0.0}
    conf["model_args"]["posterior_args"] = {"hidden_size": 16}
    conf["model_args"]["prior_args"] = {"hidden_size": 16}
    return conf


def tiny_mix(mix):
    mix = dict(mix)
    if mix["driver"].startswith("train"):
        mix.update(batch=6, t_mel=64, len_min=32, len_max=64, cap_len=9, cap_min=4)
    else:
        mix.update(batch=6, t_mel=64, len_min=32, len_max=64, pool_batches=2,
                   max_length=5)
    return mix


@pytest.fixture
def checkout(tmp_path):
    """A checkout of the benchmark whose configurations and mixes are the
    tiny ones; the port is linked in."""
    root = tmp_path / "co"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "acvae_tpu_torch").symlink_to(REPO / "acvae_tpu_torch")
    bench = copy.deepcopy(TESTED)
    for w in bench["workloads"]:
        w["chips"] = min(w["chips"], TINY_RANKS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in BENCH["configs"]:
        p = root / c["file"]
        p.write_text(json.dumps(tiny_conf(common.load_json(p))))
    for p in (root / "portbench" / "mixes").glob("*.json"):
        p.write_text(json.dumps(tiny_mix(common.load_json(p))))
    return root


class FakeCard:
    """torch.cuda as the harness asks it, answering for ``TINY_RANKS``
    cards."""

    def __init__(self, monkeypatch, present=True):
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: present)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: TINY_RANKS * present)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def fault_cases(bench, root=REPO):
    """(cell, fault) for each cell of ``bench`` and each fault that the
    driver of its mix declares (``faults.table``), from the files of the
    checkout ``root``."""
    from portbench import faults
    out = []
    for w in bench["workloads"]:
        mix = common.load_json(root / "portbench" / "mixes" / f"{w['traffic']}.json")
        drv = root / "portbench" / "drivers" / f"{mix['driver']}.py"
        out += [(w["name"], f) for f in faults.table(drv)]
    return out


@pytest.fixture
def run_at(monkeypatch, capsys):
    """``run_at(root, cell, present=True)`` runs the ``run.py`` of the
    checkout ``root`` on the CPU; returns (exit code, the last stdout line
    parsed or None, stderr)."""
    def go(root, cell, seconds=0.3, present=True, seed=TINY_SEED):
        FakeCard(monkeypatch, present)
        env, path = dict(os.environ), list(sys.path)
        spec = importlib.util.spec_from_file_location(
            "portbench_run_under_test", root / "portbench" / "run.py")
        run = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(run)
            try:
                code = run.main(["--workload", cell, "--seed", str(seed),
                                 "--seconds", str(seconds), "--trace", "0"],
                                device="cpu")
            except SystemExit as e:
                code = e.code
        finally:
            os.environ.clear()
            os.environ.update(env)
            sys.path[:] = path
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        return code, (json.loads(lines[-1]) if lines else None), out.err
    return go


@pytest.fixture
def run_cell(checkout, run_at):
    """``run_cell(cell, present=True)``: :func:`run_at` in the tiny checkout."""
    return lambda cell, **kw: run_at(checkout, cell, **kw)


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is visible (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
