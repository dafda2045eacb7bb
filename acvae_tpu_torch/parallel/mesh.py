"""The rank grid and its placement helpers (counterpart of
``acvae_tpu/parallel/mesh.py``).

JAX lays its devices out in a ``Mesh`` and lets the SPMD partitioner insert
the collectives.  The port runs one process per card (``torch.distributed``:
NCCL between cards, gloo on the CPU), so a mesh becomes a :class:`Grid` of
ranks and the collectives are written out (``parallel/collectives.py``).

* ``data`` × ``model`` ranks, rank ``r`` at ``(r // model, r % model)``:
  consecutive ranks share the model axis, as JAX's device order puts ICI
  neighbours on it.  ``data_group`` joins the ranks of one model index,
  ``model_group`` those of one data index.
* A process is one JAX process with one local device under a launcher
  (``hosts == world``: its loader takes its own stride of the corpus), or
  one of the D devices of a single JAX process when the CLI starts a worker
  a card (``hosts == 1``: every worker reads the whole global batch and
  keeps its data index's share, :func:`shard_batch`).
* Vocab tensor parallelism splits the leaves that :func:`vocab_pspec` names
  over ``model``; sequence parallelism splits mel time over the same axis.

The functions keep JAX's names: :func:`make_mesh`, :func:`make_mesh_2d`,
:func:`vocab_pspec`, :func:`check_vocab_divisible`, :func:`shard_by_vocab`,
:func:`shard_batch`, :func:`replicate`, :func:`coordination_barrier` and
:func:`pad_to_multiple`; :func:`init_process_group` and
:func:`destroy_process_group` set the processes up.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Grid:
    """This process's place in a ``(data, model)`` grid of ``world`` ranks.

    ``hosts`` is the number of loaders that read their own rows (the JAX
    processes); ``local_data`` the data extent inside one of them, so a
    process's batch splits ``local_data`` ways and this rank keeps share
    ``local_index``.  ``seq`` turns sequence parallelism on."""
    world: int
    rank: int
    data: int
    model: int
    hosts: int = 1
    seq: bool = False
    world_group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    @property
    def local_data(self) -> int:
        return self.data // self.hosts if self.hosts > 1 else self.data

    @property
    def local_index(self) -> int:
        return 0 if self.hosts > 1 else self.d

    def shape(self) -> Dict[str, int]:
        """The JAX mesh's ``dict(mesh.shape)``."""
        return ({"data": self.data} if self.model == 1 else
                {"data": self.data, "model": self.model})


def _groups(world: int, model: int):
    """(data groups by model index, model groups by data index); every rank
    creates every group, as ``new_group`` requires."""
    data = world // model
    by_m = [dist.new_group([d * model + m for d in range(data)])
            for m in range(model)]
    by_d = [dist.new_group([d * model + m for m in range(model)])
            for d in range(data)]
    return by_m, by_d


def make_mesh(n_devices: Optional[int] = None) -> Grid:
    """A 1-D ``data`` grid over the process group's ranks."""
    return make_mesh_2d(1, n_devices)


def make_mesh_2d(model_parallel: int, n_devices: Optional[int] = None,
                 hosts: Optional[int] = None) -> Grid:
    """A ``(data, model)`` grid over the group's ranks (JAX's guards: the
    model axis divides the ranks and, with several hosts, each host's
    devices, one each here)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} devices")
    if n != world:
        raise ValueError(f"a grid of {n} ranks needs a process group of "
                         f"{n}; this one has {world}")
    hosts = world_hosts() if hosts is None else hosts
    if hosts > 1 and model_parallel > 1:
        # one device a process: a model axis would span hosts whose loaders
        # hold different rows
        raise ValueError(
            f"model_parallel={model_parallel} must divide the per-host "
            f"device count (1) so the model axis stays within one host's "
            f"devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = Grid(world=n, rank=rank, data=n // model_parallel,
                model=model_parallel, hosts=hosts)
    if dist.is_initialized():
        grid.world_group = dist.group.WORLD
        by_m, by_d = _groups(n, model_parallel)
        grid.data_group, grid.model_group = by_m[grid.m], by_d[grid.d]
    return grid


_HOSTS = 1


def world_hosts() -> int:
    """How many loaders read rows of their own: the world size under a
    launcher, 1 for the CLI's worker a card."""
    return _HOSTS


def vocab_pspec(leaf, vocab_size: int, axis: str = "model") -> Tuple:
    """The partition of one array under vocab tensor parallelism, as JAX's
    ``PartitionSpec`` tuple: a leading dim equal to the vocabulary splits
    over ``axis`` (embedding tables and the torch classifier's ``[V, E]``
    weight and ``[V]`` bias), else a trailing one (a flax ``[E, V]``
    kernel); anything else is replicated (``()``)."""
    shape = tuple(getattr(leaf, "shape", ()) or ())
    if len(shape) >= 1 and shape[0] == vocab_size:
        return (axis,) + (None,) * (len(shape) - 1)
    if len(shape) >= 2 and shape[-1] == vocab_size:
        return (None,) * (len(shape) - 1) + (axis,)
    return ()


def check_vocab_divisible(vocab_size: int, model_parallel: int) -> bool:
    """Whether the vocab splits evenly over the model axis; the fix when it
    does not is ``build_vocab --pad_to_multiple=M``."""
    return vocab_size % model_parallel == 0


def _vocab_dim(spec: Tuple) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def shard_by_vocab(tree: Dict[str, torch.Tensor], grid: Grid, vocab_size: int,
                   names: Optional[Sequence[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """This rank's part of a flat tree (``state_dict``-like): each leaf that
    :func:`vocab_pspec` splits (and whose name is in ``names``, when given)
    sliced to the model index's rows, the rest unchanged."""
    out = {}
    for k, v in tree.items():
        dim = _vocab_dim(vocab_pspec(v, vocab_size))
        if dim is None or (names is not None and k not in names):
            out[k] = v
            continue
        size = vocab_size // grid.model
        out[k] = v.narrow(dim, grid.m * size, size).clone()
    return out


def shard_batch(batch: Dict[str, Any], grid: Grid) -> Dict[str, Any]:
    """This rank's rows of its process's batch: the ``local_index`` share
    (the batch is one host's rows, already a multiple of ``local_data``).
    Under sequence parallelism the train step slices mel time itself, after
    the augment, which reads whole clips."""
    n = len(next(iter(batch.values())))
    if n % grid.local_data:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{grid.local_data} data ranks; pad_to_multiple first")
    per = n // grid.local_data
    lo = grid.local_index * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Make every rank hold rank 0's parameters and buffers (broadcast in
    place)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def coordination_barrier() -> None:
    """Wait until every rank gets here; a no-op without a process group
    (the group's own timeout holds)."""
    if dist.is_initialized():
        dist.barrier()


def pad_to_multiple(batch: Dict[str, Any], m: int) -> Dict[str, Any]:
    """Pad every array's leading (batch) dim to a multiple of ``m`` by
    repeating the first rows, tiling when the pad exceeds the batch (3 rows
    on 8 ranks take 5); numpy stays numpy, tensors stay tensors."""
    n = len(next(iter(batch.values())))
    pad = (-n) % m
    if pad == 0:
        return batch
    idx = np.arange(n + pad) % n

    def _pad(v):
        if isinstance(v, torch.Tensor):
            return v[torch.as_tensor(idx, device=v.device)]
        if isinstance(v, np.ndarray):
            return v[idx]
        return [v[i] for i in idx]

    return {k: _pad(v) for k, v in batch.items()}


# ------------------------------------------------------------- processes
def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# a collective that waits longer raises on its rank
GROUP_TIMEOUT = timedelta(seconds=600)


def init_process_group(backend: str, world: int, rank: int,
                       address: Optional[str] = None, hosts: int = 1) -> None:
    """Join the group of ``world`` ranks at ``address`` (``host:port``), or
    from torchrun's ``MASTER_ADDR``/``MASTER_PORT`` when None; ``hosts`` is
    the number of loaders that read rows of their own (:class:`Grid`)."""
    global _HOSTS
    init = f"tcp://{address}" if address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=GROUP_TIMEOUT)
    _HOSTS = hosts


def destroy_process_group() -> None:
    global _HOSTS
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOSTS = 1


def launcher_env() -> Dict[str, int]:
    """The rank and world size a launcher set (torchrun, Slurm, Open MPI),
    or {} when none did."""
    for rank_v, world_v in (("RANK", "WORLD_SIZE"),
                            ("SLURM_PROCID", "SLURM_NTASKS"),
                            ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")):
        world = os.environ.get(world_v)
        if world and int(world) > 1 and os.environ.get(rank_v) is not None:
            return {"rank": int(os.environ[rank_v]), "world": int(world)}
    return {}
