#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from: for each seed,
the program's compared numbers (a short window of the cell's own load, at
its own sizes) and the control's, the reference one precision lower put
in the program's place (``Cell.judge(..., control=True)``).  One process
for all seeds, so set-up is paid once for the build.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--no-control] [--fault <a fault of portbench/faults.py>]

A cell on several cards keeps one set of ranks for all seeds; a fault is
planted on every rank.

Prints one JSON line a seed and the largest and smallest readings; for a
serving cell also the largest score errors of agreeing clips, and the
numbers of the reference's decode from its own encoding (``own``, not
compared by the runs).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run  # noqa: F401  (sets the import path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of portbench/faults.py in the program")
    args = ap.parse_args()
    import torch
    from portbench import common
    bench = common.load_json(run.CHECKOUT / "BENCHMARK.json")
    f = run.cell_files(bench, args.workload)
    driver = common.load_module(f["driver"])
    plant = args.fault
    if plant:
        from portbench import faults
        faults.plant(f["driver"], plant, setattr)
    chips = f["cell"]["chips"]
    ranks = (common.Ranks(chips, f["driver"], f["conf"], f["mix"], "cuda", plant)
             if chips > 1 else None)
    prog, ctrl = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = (driver.Cell(f["conf"], f["mix"], seed, "cuda") if ranks is None
                else driver.Cell(f["conf"], f["mix"], seed, "cuda", ranks=ranks))
        cell.setup()
        res = cell.window(args.seconds)
        s = cell.collect()
        serve = hasattr(cell, "own_encoding")
        p = cell.judge(s, detail=True) if serve else cell.judge(s)
        c = None if args.no_control else cell.judge(s, control=True)
        own = cell.own_encoding(s) if serve else None
        prog.append({k: v for k, v in p.items() if isinstance(v, float)})
        if c:
            ctrl.append(c)
        print(json.dumps({"seed": seed, "program": p, "control": c, "own": own,
                          "units": res["units"],
                          "s": round(time.perf_counter() - t0, 1)}), flush=True)
        del cell, s
        gc.collect()
        torch.cuda.empty_cache()
    if ranks is not None:
        print("memory_peak_bytes by rank", [torch.cuda.max_memory_allocated()]
              + [a["memory_peak_bytes"] for a in ranks.close()])
    for tag, rows in (("program max", prog), ("control min", ctrl)):
        if rows:
            agg = max if tag.startswith("program") else min
            print(tag, json.dumps({k: agg(r[k] for r in rows) for k in rows[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
