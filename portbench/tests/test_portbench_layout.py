"""The benchmark's files: every cell finds its configuration, mix, driver,
limits and metric readers by name; BENCHMARK.json keeps the contract's
rules (a cell takes 1 or 4 cards, and at most a quarter of the cells, one
at least, take 4); a new mix or metric, and a new model's serving cell
with its own faults, need only new files and entries; a run's last line
has the contract's keys; a run with no card, or one that loaded JAX or
the JAX package, prints no result."""
from __future__ import annotations

import importlib.util
import json
import re
import shutil
import sys
import types

import pytest
import torch

from conftest import BENCH, REPO, TESTED, TINY_SEED, fault_cases, tiny_conf, tiny_mix
from portbench import common, faults

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def chips_keep_the_rule(workloads) -> bool:
    """Each cell takes 1 or 4 cards; at most a quarter of the cells,
    rounded down, take 4, and one always may."""
    chips = [w["chips"] for w in workloads]
    return (all(c in (1, 4) for c in chips)
            and chips.count(4) <= max(1, len(chips) // 4))


def _load_run(root):
    spec = importlib.util.spec_from_file_location("portbench_run_layout",
                                                  root / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.mark.parametrize("cell", [w["name"] for w in TESTED["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    run = _load_run(REPO)
    f = run.cell_files(TESTED, cell)
    assert f["driver"].exists()
    assert hasattr(common.load_module(f["driver"]), "Cell")
    assert set(f["limits"]) and all(v > 0 for v in f["limits"].values())
    for m in run.metrics_for(TESTED, "per_layer", cell):
        reader = common.load_module(REPO / "portbench" / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_benchmark_json_keeps_the_rules():
    b = BENCH
    assert set(b) == TOP
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = ([c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"]: w for w in b["workloads"]}
    assert chips_keep_the_rule(cells.values())
    assert {(w["config"], w["traffic"]) for w in cells.values()}.__len__() == len(cells)
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in cells.values())
        assert (REPO / c["file"]).exists() and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]      # reported in every cell, later ones too
    where = {m["name"]: m.get("workloads", list(cells)) for m in metrics}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "workloads" not in m or (isinstance(m["workloads"], list) and m["workloads"])
        assert set(where[m["name"]]) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in where[m["name"]]:     # the metric it moves is reported there
            assert cell in where[m["moves"]]
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in where[m["name"]]]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in where[m["name"]] for m in b["per_layer"])
    for w in cells.values():
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"


@pytest.mark.parametrize("chips,ok", [
    ([1], True), ([4], True), ([1, 1, 1, 1, 4], True), ([1, 1, 1, 4, 4], False),
    ([1] * 6 + [4, 4], True), ([1] * 6 + [4] * 3, False), ([1, 2], False),
    ([1, 8], False)])
def test_the_four_card_rule(chips, ok):
    assert chips_keep_the_rule([{"chips": c} for c in chips]) is ok


def test_a_new_mix_and_metric_need_only_new_files(tmp_path):
    """A throwaway mix, cell and per-layer metric, made as new files and
    new entries in a copy: the harness finds and reads them, unchanged."""
    root = tmp_path / "co"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mix = common.load_json(root / "portbench" / "mixes" / "serve_int8_b512.json")
    mix["batch"] = 64
    (root / "portbench" / "mixes" / "serve_int8_b64.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "cnn10.serve_int8_b64.json").write_text(
        json.dumps({"enc_err": 1e-3, "beam_mismatch": 1e-2, "score_err": 1e-5}))
    (root / "portbench" / "metrics" / "clips_traced.serve.py").write_text(
        "def read(ctx):\n    return ctx.units * ctx.mix['batch']\n")
    bench["workloads"].append({"name": "cnn10.serve_int8_b64", "config": "acvae_cnn10",
                               "traffic": "serve_int8_b64", "chips": 1, "why": "small batches"})
    bench["per_layer"].append({"name": "clips_traced.serve", "unit": "clips", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "clips_per_s", "workloads": ["cnn10.serve_int8_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    run = _load_run(root)
    f = run.cell_files(bench, "cnn10.serve_int8_b64")
    assert f["mix"]["batch"] == 64 and f["driver"].name == "serve_offline.py"
    got = run.metrics_for(bench, "per_layer", "cnn10.serve_int8_b64")
    assert [m["name"] for m in got] == ["clips_traced.serve"]
    reader = common.load_module(root / "portbench" / "metrics" / "clips_traced.serve.py")
    ctx = types.SimpleNamespace(units=3, mix=f["mix"])
    assert reader.read(ctx) == 192


PROBE_DRIVER = '''"""A probe model: the flagship served under weights drawn with another
salt, with faults of its own."""
from pathlib import Path

from portbench import common, faults
from portbench.reference.params import make_weights

serve = common.load_module(Path(__file__).resolve().parent / "serve_offline.py")


def _encoding_scaled(setattr):
    from acvae_tpu_torch.models import common as mc
    real = mc.CaptionModel.apply_ln

    def apply_ln(self, encoded):
        out = real(self, encoded)
        return dict(out, audio_embeds=out["audio_embeds"] * 1.5)
    setattr(mc.CaptionModel, "apply_ln", apply_ln)


FAULTS = dict(faults.SERVING, encoding_scaled=_encoding_scaled)


class Cell(serve.Cell):
    def weights(self):
        return make_weights(self.conf, common.seed_of(self.seed, 101), self.device)
'''


def _tree(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_model_needs_only_new_files(tmp_path, run_at):
    """A probe model's serving cell, made as new files (a driver that
    subclasses ``serve_offline.Cell`` and overrides its weights, with a
    fault table of its own; a configuration, a mix and a limits file) and
    new entries in a copy of BENCHMARK.json: its sound run is correct, each
    of its faults fails it, its fault cases are its own table's, and no
    file that was there before changed."""
    root = tmp_path / "co"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "acvae_tpu_torch").symlink_to(REPO / "acvae_tpu_torch")
    pb = root / "portbench"
    conf = tiny_conf(common.load_json(pb / "configs" / "acvae_cnn10.json"))
    mix = dict(tiny_mix(common.load_json(pb / "mixes" / "serve_int8_b512.json")),
               driver="probe")
    new = {"configs/probe_cnn10.json": json.dumps(conf),
           "mixes/probe_int8.json": json.dumps(mix),
           "limits/probe.serve_int8.json":
               (pb / "limits" / "cnn10.serve_int8_b512.json").read_text(),
           "drivers/probe.py": PROBE_DRIVER}
    for rel, text in new.items():
        (pb / rel).write_text(text)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = "probe.serve_int8"
    bench["configs"].append({"name": "probe_cnn10", "source": "a test's probe",
                             "file": "portbench/configs/probe_cnn10.json",
                             "reduced": [], "why": "another model's weights"})
    bench["workloads"].append({"name": cell, "config": "probe_cnn10",
                               "traffic": "probe_int8", "chips": 1,
                               "why": "a probe model's serving cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cnn10.serve_int8_b512" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    probe = common.load_module(pb / "drivers" / "probe.py")
    own = list(probe.FAULTS)
    assert [f for c, f in fault_cases(bench, root) if c == cell] == own
    assert "state_unchanged" not in own and "encoding_scaled" in own
    base = common.load_module(pb / "drivers" / "serve_offline.py")
    w_probe = probe.Cell(conf, mix, TINY_SEED, "cpu").weights()
    w_base = base.Cell(conf, mix, TINY_SEED, "cpu").weights()
    assert not torch.equal(w_probe["decoder.classifier.weight"],
                           w_base["decoder.classifier.weight"])

    code, res, _ = run_at(root, cell)
    assert code == 0 and res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"clips_per_s", "batch_p95_ms", "setup_s"}
    for fault in own:
        with pytest.MonkeyPatch.context() as mp:
            faults.plant(pb / "drivers" / "probe.py", fault, mp.setattr)
            code, res, _ = run_at(root, cell)
        assert code == 0 and res["correct"] is False, (fault, res["checks"])

    after = _tree(pb)
    before = {p: b for p, b in _tree(REPO / "portbench").items() if p.parts[0] != "tests"}
    assert {str(p) for p in set(after) - set(before)} == set(new)
    assert all(after[p] == b for p, b in before.items())
    for group in ("configs", "workloads"):
        bench[group].pop()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].remove(cell)
    assert bench == json.loads((REPO / "BENCHMARK.json").read_text())


def test_the_last_line_has_the_contracts_keys(run_cell):
    code, res, err = run_cell("cnn10.serve_int8_b512")
    assert code == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"clips_per_s", "batch_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])


def test_no_card_no_result(run_cell):
    code, res, err = run_cell("cnn10.serve_int8_b512", present=False)
    assert code not in (0, None) and res is None and "CUDA" in err


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "acvae_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("acvae_tpu_torch_x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = common.forbidden_modules()
    assert {"jax", "jaxlib.xla_client", "flax.linen", "acvae_tpu.models"} <= set(found)
    assert not {"acvae_tpu_torch", "acvae_tpu_torch_x", "jaxtyping", "flaxen"} & set(found)


def test_a_run_that_loaded_jax_prints_no_result(run_cell, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, res, err = run_cell("cnn10.serve_int8_b512")
    assert code not in (0, None) and res is None and "jax" in err
