"""What every driver and reader of the benchmark shares: finding a cell's
files by name, the port's model built from the benchmark's weights, the
traffic's log-mels, the host clock's window, and the reduction of a
profiler trace to kernel time by range, busy time and idle gaps.

The trace reduction follows this repo's ``chip_smoke.py::profile_decode``
(:1345-1386) and ``profile_steps`` (:992-1047): kernels, copies and sets
are the device's events; a range's device time is that of the work its
host range launched (matched by the launch's correlation id, so nested
ranges each count it); the backward is all device time less the other
ranges' (autograd launches it on its own thread); the host's ranges label
the device's idle gaps.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "acvae_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name, compared whole, is
    JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def seed_of(seed: int, salt: int) -> int:
    """A sub-seed for one use of the run's seed."""
    return (int(seed) * 1_000_003 + salt) % 2**63


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_conf(conf: Dict) -> Dict:
    """The model's keys of a configuration file, without the benchmark's."""
    drop = ("name", "source", "reduced", "assumed", "vocab_size", "data_dim",
            "iters_per_epoch", "precision")
    return {k: v for k, v in conf.items() if k not in drop}


def build_port_model(conf: Dict, sd, device):
    """The port's model of ``conf`` holding the weights ``sd`` (built on
    the meta device, so no initializer runs, then loaded strictly)."""
    from acvae_tpu_torch.models.build import build_model
    model = build_model(port_conf(conf), conf["vocab_size"], conf["data_dim"],
                        device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def spread(n: int, lo: int, hi: int, rng) -> np.ndarray:
    """``n`` lengths spaced evenly over [lo, hi], in an order drawn from
    ``rng``: every seed gets the same set of sizes."""
    return rng.permutation(np.round(np.linspace(lo, hi, n)).astype(np.int64))


def log_mels(gen, n: int, t: int, f: int, lens, device):
    """[n, t, f] float32 standard-normal log-mels, zero past each length
    (the shape of ``chip_smoke.py::make_batch``, :924-937)."""
    import torch
    x = torch.randn((n, t, f), generator=gen, device=device)
    keep = torch.arange(t, device=device)[None, :] < lens[:, None]
    return x * keep[:, :, None]


def p95(values) -> float:
    """The 95th percentile (linear interpolation) of all ``values``."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


# ------------------------------------------------------------ the trace
class Trace:
    """A chrome trace of torch.profiler reduced to what the readers need.

    A kernel (or copy, or set) belongs to every host range open on the
    thread that launched it, at the time of its launch (the launch and the
    kernel share a correlation id): nested ranges each count it, and the
    kernels autograd launches on its own thread belong to no range of the
    main thread."""

    DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
    LAUNCH = ("cuda_runtime", "cuda_driver")

    def __init__(self, path: Path, window: Tuple[float, float], units: int):
        ev = load_json(path)["traceEvents"]
        dev = [e for e in ev if e.get("cat") in self.DEVICE and "dur" in e]
        self.kernels = sorted((e["ts"], e["dur"], e["name"]) for e in dev)
        self.host_ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
                            for e in ev if e.get("cat") == "user_annotation"
                            and "dur" in e]
        launch = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in ev
                  if e.get("cat") in self.LAUNCH and "correlation" in e.get("args", {})}
        self.range_s = {name: 0.0 for *_, name, _ in self.host_ranges}
        for e in dev:
            tid, ts = launch.get(e.get("args", {}).get("correlation"), (None, None))
            if ts is None:
                continue
            for a, b, name, rtid in self.host_ranges:
                if rtid == tid and a <= ts < b:
                    self.range_s[name] += e["dur"] / 1e6
        win = [r for r in self.host_ranges if r[2] == "harness.window"]
        self.w0, self.w1 = (win[0][0], win[0][1]) if win else (
            self.kernels[0][0], max(t + d for t, d, _ in self.kernels))
        self.window_s = window[1] - window[0]
        self.units = units

    def kernel_s_in(self, name: str) -> Optional[float]:
        """Seconds of device work launched from inside the host range
        ``name`` (None: no such range in the trace)."""
        return self.range_s.get(name)

    def kernel_s(self) -> float:
        return sum(k[1] for k in self.kernels) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for t, d, _ in self.kernels:
            if out and t <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t + d)
            else:
                out.append([t, t + d])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or set ran (their union)."""
        return sum(b - a for a, b in self._merged()) / 1e6

    def _label(self, t: float) -> str:
        inner = None
        for a, b, name, _ in self.host_ranges:
            if a <= t < b and name != "harness.window" and (
                    inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        return inner[2] if inner else "outside the program's ranges"

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the traced window, summed by the innermost host
        range open when each gap began; the largest ``top``."""
        gaps, prev = {}, self.w0
        for a, b in self._merged() + [(self.w1, self.w1)]:
            if a > prev:
                lab = self._label(prev)
                gaps[lab] = gaps.get(lab, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for _, d, name in self.kernels:
            tot[name] = tot.get(name, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def profile_units(run_unit, units: int, out_dir: Path) -> Trace:
    """Run ``run_unit(i)`` ``units`` times under torch.profiler (CPU and
    CUDA activities), each ending on the host, inside a host range
    ``harness.window``; returns the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace_{os.getpid()}.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("harness.window"):
            for i in range(units):
                run_unit(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        return Trace(path, (t0, t1), units)
    finally:
        path.unlink()
