"""What every driver and reader of the benchmark shares: finding a cell's
files by name, the port's model built from the benchmark's weights, the
traffic's log-mels, the host clock's window, the reduction of a profiler
trace to kernel time by range, busy time and idle gaps, and the ranks of a
cell on several cards (:class:`Ranks`).

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


def profile_units(run_unit, units: int, out_dir: Path, start=None) -> Trace:
    """Run ``run_unit(i)`` ``units`` times under torch.profiler (CPU and
    CUDA activities), each ending on the host, inside a host range
    ``harness.window``; returns the reduced trace.  ``start()``, once the
    profiler runs, holds the window back (until every rank's profiler runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace_{os.getpid()}.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if start is not None:
            start()
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


# ------------------------------------------------------------ the ranks
# The orders rank 0 gives the other ranks of a cell on several cards.
END, CELL, UNIT, TRACE, COLLECT = 0, 1, 2, 3, 4
RANK_TIMEOUT_S = 120.0


def _join_group(backend: str, world: int, rank: int, port: int, timeout_s: float):
    """Join the cell's process group through the port's
    ``parallel/mesh.py::init_process_group`` with a collective timeout of
    ``timeout_s``; returns the gloo group that carries rank 0's orders,
    which waits as long as rank 0 takes between orders."""
    from datetime import timedelta

    import torch.distributed as dist
    from acvae_tpu_torch.parallel import mesh
    mesh.GROUP_TIMEOUT = timedelta(seconds=timeout_s)
    mesh.init_process_group(backend, world, rank, f"localhost:{port}")
    return dist.new_group(backend="gloo", timeout=timedelta(days=1))


def _die_with_parent() -> None:
    """Have the kernel kill this process when the process that started it
    ends (Linux), so that no rank outlives rank 0."""
    import ctypes
    import signal
    try:
        libc = ctypes.CDLL(None, use_errno=True)
    except OSError:
        return
    PR_SET_PDEATHSIG = 1
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)


def _pin(rank: int, world: int) -> None:
    """Keep this rank's process on host cores of its own: those local to
    its card (sysfs), shared evenly among the ranks whose cards have the
    same, or else an even share of every core the process may use."""
    import torch
    allowed = os.sched_getaffinity(0)

    def local(r):
        p = torch.cuda.get_device_properties(r)
        bus = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
        text = Path(f"/sys/bus/pci/devices/{bus}/local_cpulist").read_text()
        cpus = set()
        for part in text.strip().split(","):
            a, _, b = part.partition("-")
            cpus.update(range(int(a), int(b or a) + 1))
        return frozenset(cpus & allowed)
    try:
        near = [local(r) for r in range(world)]
    except (AttributeError, OSError, ValueError):
        near = []
    if not near or not all(near):
        near = [frozenset(allowed)] * world
    peers = [r for r in range(world) if near[r] == near[rank]]
    cores = sorted(near[rank])
    k = max(1, len(cores) // len(peers))
    mine = cores[peers.index(rank) * k:][:k] or cores
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))


class Follower:
    """What a driver's ``Cell`` gets as ``ranks`` on ranks 1 … R−1."""

    def __init__(self, rank: int, world: int, orders):
        self.rank, self.world, self._orders = rank, world, orders

    def barrier(self) -> None:
        """Wait until every rank gets here (over the orders' gloo group)."""
        import torch.distributed as dist
        dist.barrier(group=self._orders)


def _follow(rank, world, backend, port, device, driver, conf, mix, plant,
            timeout_s, reports) -> None:
    """Rank ``rank`` of a cell: join the group, then do rank 0's orders
    until ``END``, answering each on ``reports`` as
    ``(rank, order number, ok, answer or traceback)``."""
    import gc
    import tempfile
    import traceback

    import torch
    import torch.distributed as dist
    _die_with_parent()
    seq = 0
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
            _pin(rank, world)
        else:   # the host's cores are rank 0's too
            torch.set_num_threads(1)
        if plant is not None:
            from portbench import faults
            faults.plant(driver, plant, setattr)
        orders = _join_group(backend, world, rank, port, timeout_s)
        Cell = load_module(Path(driver)).Cell
        me, cell = Follower(rank, world, orders), None
        while True:
            cmd = torch.zeros(2, dtype=torch.int64)
            dist.broadcast(cmd, 0, group=orders)
            op, arg = int(cmd[0]), int(cmd[1])
            seq += 1
            answer = None
            if op == CELL:
                cell = None
                gc.collect()
                if device.startswith("cuda"):
                    torch.cuda.empty_cache()
                cell = Cell(conf, mix, arg, device, ranks=me)
                cell.setup()
            elif op == UNIT:
                cell.follow_unit()
            elif op == TRACE:
                tr = cell.trace(arg, Path(tempfile.gettempdir()) / "portbench")
                answer = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            elif op == COLLECT:
                answer = cell.collect()
            elif op == END:
                answer = {"memory_peak_bytes": torch.cuda.max_memory_allocated(device)
                          if device.startswith("cuda") else 0}
            else:
                raise ValueError(f"unknown order {op}")
            bad = forbidden_modules()
            if bad:
                raise RuntimeError(f"rank {rank} loaded modules of JAX or the "
                                   f"JAX package: {bad}")
            reports.put((rank, seq, True, answer))
            if op == END:     # every rank leaves NCCL's communicators at once
                from acvae_tpu_torch.parallel import mesh
                mesh.destroy_process_group()
                return
    except BaseException:
        reports.put((rank, seq, False, traceback.format_exc()))
        raise


class Ranks:
    """Ranks 1 … R−1 of a cell on R cards, one spawned process a card (rank
    ``r`` on ``cuda:r``); the calling process is rank 0 (``cuda:0``).  All
    R join one process group (NCCL between cards, gloo on the CPU).

    Each follower builds the cell's driver ``Cell(conf, mix, seed, device,
    ranks=<its Follower>)`` and does rank 0's orders in step with it:
    ``CELL`` (build for a seed and ``setup()``), ``UNIT`` (``follow_unit()``:
    one more unit), ``TRACE`` (``trace(n, dir)``; it answers the trace's
    busy and window seconds), ``COLLECT`` (``collect()``; it answers what
    that returns) and ``END`` (it answers its peak memory and leaves the
    group).  An order is an [op, argument] pair that rank 0 broadcasts over
    a gloo group of its own, so the orders put no kernel in rank 0's trace;
    :meth:`barrier` waits on that group too.  On cards each rank's process
    keeps to host cores of its own, near its card (:func:`_pin`), so that
    the ranks, which meet in every step, do not take each other's cores.

    A failure ends the run with no result: a follower's exception (its
    traceback is printed here), a follower's death, an order that a
    follower has not done ``timeout_s`` after it was given, or a follower
    that loaded JAX, jaxlib, flax or the JAX package.  Rank 0 then kills the
    followers and exits with code 5.  A collective of the program waits
    ``timeout_s`` at most, and the followers die with rank 0."""

    rank = 0

    def __init__(self, world: int, driver: Path, conf: Dict, mix: Dict,
                 device: str = "cuda", plant: Optional[str] = None,
                 timeout_s: float = RANK_TIMEOUT_S):
        import threading

        import torch
        import torch.multiprocessing as mp
        from acvae_tpu_torch.parallel.mesh import free_port
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        cuda = str(device).startswith("cuda")
        backend, port = ("nccl" if cuda else "gloo"), free_port()
        self.reports = ctx.Queue()
        self.procs = [ctx.Process(target=_follow, daemon=True, args=(
            r, world, backend, port, f"cuda:{r}" if cuda else "cpu", str(driver),
            conf, mix, plant, timeout_s, self.reports))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        self._cv = threading.Condition()
        self._seq, self._op, self._due, self._closed = 0, None, None, False
        self._answers: Dict[int, Tuple[int, object]] = {}
        threading.Thread(target=self._watch, daemon=True).start()
        if cuda:       # after the spawns, which take every core
            torch.cuda.set_device(0)
            _pin(0, world)
        self._orders = _join_group(backend, world, 0, port, timeout_s)

    def barrier(self) -> None:
        """Wait until every rank gets here (over the orders' gloo group)."""
        import torch.distributed as dist
        dist.barrier(group=self._orders)

    def order(self, op: int, arg: int = 0) -> None:
        """Broadcast order ``op`` with its argument to every follower."""
        import torch
        import torch.distributed as dist
        with self._cv:
            self._seq += 1
            self._op, self._due = op, time.monotonic() + self.timeout_s
        dist.broadcast(torch.tensor([op, arg], dtype=torch.int64), 0, group=self._orders)

    def _done(self) -> bool:
        return all(self._answers.get(r, (0,))[0] == self._seq
                   for r in range(1, self.world))

    def results(self) -> List:
        """The followers' answers to the last order, in rank order, once
        every follower has done it."""
        with self._cv:
            self._cv.wait_for(self._done)
            return [self._answers[r][1] for r in range(1, self.world)]

    def close(self) -> List[Dict]:
        """``END``: every follower's last answer, once all have left the
        group and ended."""
        from acvae_tpu_torch.parallel import mesh
        self.order(END)
        last = self.results()
        with self._cv:
            self._closed = True
        mesh.destroy_process_group()
        for r, p in enumerate(self.procs, 1):
            p.join(timeout=self.timeout_s)
            if p.exitcode is None:
                self._fail(f"rank {r} did not end")
        return last

    def _take(self, block: bool) -> None:
        import queue
        while True:
            try:
                rank, seq, ok, answer = self.reports.get(timeout=0.5 if block else 0)
            except queue.Empty:
                return
            if not ok:
                self._fail(f"rank {rank} failed:\n{answer}")
            with self._cv:
                self._answers[rank] = (seq, answer)
                if self._done():
                    self._due = None
                self._cv.notify_all()
            block = False

    def _watch(self) -> None:
        while True:
            self._take(block=True)
            with self._cv:
                if self._closed:
                    return
                due, op = self._due, self._op
            if any(p.exitcode is not None for p in self.procs):
                self._take(block=False)      # what a rank said before it ended
                with self._cv:
                    gone = [r for r, p in enumerate(self.procs, 1)
                            if p.exitcode is not None and (
                                p.exitcode != 0 or self._answers.get(r, (0,))[0] < self._seq)]
                if gone:
                    self._fail(f"ranks {gone} died (exit codes "
                               f"{[self.procs[r - 1].exitcode for r in gone]})")
            if due is not None and time.monotonic() > due:
                late = [r for r in range(1, self.world)
                        if self._answers.get(r, (0,))[0] < self._seq]
                self._fail(f"ranks {late} did not finish order {op} within "
                           f"{self.timeout_s:g} s")

    def _fail(self, msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        os._exit(5)
