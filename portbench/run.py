#!/usr/bin/env python3
"""Run one cell of the benchmark of ``acvae_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell; the cell
names its configuration (``portbench/configs/<config>.json``) and its
traffic mix (``portbench/mixes/<traffic>.json``), and the mix names its
driver (``portbench/drivers/<driver>.py``).  Each per-layer metric is read
by ``portbench/metrics/<metric>.py``; the limits of the cell's correctness
check are ``portbench/limits/<cell>.json``.  A new cell, mix or metric is
new files and new entries: nothing here names one.  A cell on several
cards runs its other ranks in processes of their own (``common.Ranks``);
this process is rank 0, whose clock, trace and checks make the result,
with the busy seconds averaged over the cards and the largest peak of any
rank.

The run needs a CUDA card (no CPU fallback), draws its inputs and weights
from ``--seed``, sets up and warms up (``setup_s``, from process start),
measures for ``--seconds`` on the host clock (``--trace 0``: the cell's
end-to-end metrics) or then traces a few units under torch.profiler
(``--trace 1``: its per-layer metrics, ``busy_s``, ``window_s`` and the
``breakdown``), then judges what the window produced against the plain
reference (``portbench/reference``).  It prints each compared number
beside its limit as its last lines on standard error, and one JSON object
as the last line of standard output.  It fails, printing no result, if a
module of JAX, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
sys.path.insert(0, str(CHECKOUT))


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry, configuration, mix, driver and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json", 2)
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    from portbench import common
    conf = common.load_json(CHECKOUT / conf_entry["file"])
    mix = common.load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    return {"cell": cell, "conf": conf, "mix": mix,
            "driver": HERE / "drivers" / f"{mix['driver']}.py",
            "limits": common.load_json(HERE / "limits" / f"{name}.json")}


def metrics_for(bench: dict, key: str, cell: str) -> list:
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


class Ctx:
    """What a per-layer reader gets: the trace, the cell and its counts, and
    the time of a unit (batch or step) in the run's untraced window."""

    def __init__(self, trace, cell, conf, mix, unit_s):
        self.trace, self.cell, self.conf, self.mix = trace, cell, conf, mix
        self.units = trace.units
        self.unit_s = unit_s


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import common
    bench = common.load_json(CHECKOUT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    f = cell_files(bench, args.workload)
    driver = common.load_module(f["driver"])
    ranks = None
    if chips == 1:
        cell = driver.Cell(f["conf"], f["mix"], args.seed, device)
    else:
        ranks = common.Ranks(chips, f["driver"], f["conf"], f["mix"], device)
        cell = driver.Cell(f["conf"], f["mix"], args.seed, device, ranks=ranks)
    cell.setup()
    common.sync(device)
    setup_s = time.perf_counter() - T_START

    res = cell.window(args.seconds)
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    breakdown = None
    if args.trace:
        tr = cell.trace(f["mix"]["trace_units"],
                        Path(tempfile.gettempdir()) / "portbench")
        ctx = Ctx(tr, cell, f["conf"], f["mix"], res["window_s"] / res["units"])
        metrics = {}
        for m in metrics_for(bench, "per_layer", args.workload):
            v = common.load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = tr.busy_s()
        if ranks is not None:   # the cards' mean busy share, over rank 0's window
            share = [busy / tr.window_s] + [a["busy_s"] / a["window_s"]
                                            for a in ranks.results()]
            busy = tr.window_s * sum(share) / chips
        card.update(busy_s=busy, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {}
        for m in metrics_for(bench, "end_to_end", args.workload):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in res["metrics"]:
                v, unit = res["metrics"][m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    card["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    s = cell.collect()
    if ranks is not None:
        peaks = [card["memory_peak_bytes"]] + [a["memory_peak_bytes"]
                                               for a in ranks.close()]
        print(f"portbench: memory_peak_bytes by rank {peaks}", file=sys.stderr)
        card["memory_peak_bytes"] = max(peaks)
    numbers = cell.judge(s)
    checks = {k: {"value": v, "limit": f["limits"][k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = common.forbidden_modules()
    if bad:
        fail(f"the run loaded modules of JAX or the JAX package: {bad}", 4)
    result = {"correct": correct, "attempted": res["attempted"],
              "failed": res["failed"], "metrics": metrics, "device": card}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
