"""The ranks of a process group, one worker process each, started once and
sent work (:class:`RankPool`).

``cli train`` starts its worker a card with it; the parallel checks
(``parallel/parity.py``) send one pool every case, since starting a group
costs every process torch's import.
"""
from __future__ import annotations

import queue
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch

from acvae_tpu_torch.parallel.mesh import (destroy_process_group, free_port,
                                           init_process_group)


def _serve(rank: int, world: int, backend: str, port: int, device: str,
           inbox, outbox) -> None:
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    else:   # the host's cores are shared with the other ranks
        torch.set_num_threads(1)
    try:
        init_process_group(backend, world, rank, f"localhost:{port}")
        outbox.put((rank, True, "ready"))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            outbox.put((rank, True, fn(*args, device=device, **kwargs)))
        except BaseException:   # SystemExit too: the caller raises it
            outbox.put((rank, False, traceback.format_exc()))
    destroy_process_group()


class RankPool:
    """A worker process a device of ``devices``, rank ``r`` on
    ``devices[r]``, in one ``backend`` group.  :meth:`run` calls a
    module-level ``fn(*args, device=..., **kwargs)`` on every rank and
    returns the ranks' results in rank order; a worker's error or death
    raises here and closes the pool (a rank stuck in a collective raises
    at the group's timeout).  The workers start in the background: the
    first :meth:`run` waits for them."""

    def __init__(self, backend: str, devices: Sequence[str]):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world = len(devices)
        port = free_port()
        self.inboxes = [ctx.Queue() for _ in devices]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, self.world, backend, port, str(dev), self.inboxes[r],
            self.outbox)) for r, dev in enumerate(devices)]
        for p in self.procs:
            p.start()
        self._ready = False

    def _collect(self) -> List[Any]:
        out: Dict[int, Any] = {}
        while len(out) < self.world:
            try:
                rank, ok, value = self.outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive() and r not in out]
                if dead:
                    raise RuntimeError(f"rank pool: workers {dead} died")
                continue
            if not ok:
                raise RuntimeError(f"rank pool: rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        try:
            if not self._ready:
                self._collect()
                self._ready = True
            for box in self.inboxes:
                box.put((fn, args, kwargs))
            return self._collect()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for box, p in zip(self.inboxes, self.procs):
            if p.is_alive():
                box.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
