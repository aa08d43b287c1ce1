"""The device mesh and the data group (counterpart of
``howl_tpu/parallel/mesh.py``).

The JAX package runs scale-out as one jitted program over a
``jax.sharding.Mesh`` with axes ``("seed", "data")``. PyTorch has no such
program, so the port splits the two uses:

* ``make_mesh`` returns a ``Mesh``: a (seed, data) array of torch devices.
  The live engines split their streams over it (``shard_streams``, no
  collectives: each shard steps on its own device), and the seed sweep
  lays its seeds out on it (``parallel/seed_sweep.py``). By default it
  takes every visible card once; an explicit ``devices=`` list may repeat
  a device, which is how one host exercises a split (``["cpu"] * 4`` in
  the tests, ``[cuda:0] * 4`` on a one-card machine).
* Data parallelism runs one process a rank (``torch.distributed``).
  ``initialize_multihost`` joins such a group and returns its
  ``DataGroup``; ``shard_batch`` takes a rank's rows of a global batch and
  ``replicate`` makes every rank's weights the group's rank 0's.
  ``parallel/data_parallel.py`` launches the ranks and holds the
  collectives of the train step (global BatchNorm statistics, the gradient
  average).
* A (seed S, data D) grid runs S * D ranks, rank ``r = s * D + d`` at
  coordinate (s, d) on the mesh's device ``[s, d]``: ``seed_group`` gives
  each seed's D ranks a process group of their own, and every collective
  that takes a ``DataGroup`` runs on it unchanged. NCCL runs on distinct
  cards; where the ranks' devices repeat a card (NCCL puts no two ranks on
  one card) or lie on the CPU the group runs gloo (``mesh_backend``), over
  CUDA tensors on a card.

JAX's ``batch_sharding`` and ``replicate_sharding`` have no counterpart: the
port places a batch by rank (``shard_batch`` with a ``DataGroup``) and
weights by broadcast (``replicate``), not by a sharding object.
"""

from __future__ import annotations

import datetime
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class Mesh:
    """A (seed, data) array of torch devices, axes named as the JAX mesh's."""

    devices: np.ndarray  # object array of torch.device, shape (seed, data)
    axis_names: tuple = ("seed", "data")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """Every device of the mesh, seed-major (a device may repeat)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.device_list()]})"


def visible_cards() -> list:
    """Every CUDA device this process sees, once each."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = None, seed: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over ``devices`` (default: every visible card): (seed, data)
    axes; ``data`` fills what is left."""
    devices = [torch.device(d) for d in (visible_cards() if devices is None else devices)]
    if data is None:
        data = max(len(devices) // seed, 1)
    if data * seed > len(devices):
        platform = devices[0].type if devices else "cuda"
        raise ValueError(
            f"mesh {seed}x{data} needs {seed * data} devices but only {len(devices)} available ({platform}); "
            "pass devices= (a device may repeat, e.g. ['cpu'] * 4) for a mesh on one host, "
            "or lower --num-devices"
        )
    arr = np.empty((seed, data), dtype=object)
    for i, d in enumerate(devices[: data * seed]):
        arr[i // data, i % data] = d
    return Mesh(arr)


def mesh_backend(mesh: Mesh) -> str:
    """The ``torch.distributed`` backend of a group of ranks on ``mesh``'s
    devices, one a rank: NCCL on distinct cards, gloo on the CPU or where a
    card repeats."""
    devices = mesh.device_list()
    if devices[0].type != "cuda" or len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


class DataGroup(NamedTuple):
    """One rank of a data-parallel group: rank ``rank`` of ``size`` on
    ``device``. ``pg`` is its ``torch.distributed`` process group (None: the
    default group of every rank). In a (seed, data) grid (``seed_group``)
    the group is seed ``seed``'s ranks, one of ``seeds``, and ``root`` the
    global rank of its rank 0."""

    rank: int
    size: int
    device: torch.device
    pg: object = None
    root: int = 0
    seed: int = 0
    seeds: int = 1

    def rows(self, local: int) -> tuple:
        """(lo, hi, total): this rank's rows of a global batch of
        ``local * size`` rows."""
        return self.rank * local, (self.rank + 1) * local, local * self.size

    @property
    def world(self) -> "DataGroup":
        """Every rank of the grid (the default group), this rank in it."""
        return DataGroup(self.root + self.rank, self.size * self.seeds, self.device)


def initialize_multihost(coordinator_address: str = None, num_processes: int = None, process_id: int = None,
                         device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                         backend: Optional[str] = None) -> DataGroup:
    """Join a data-parallel group: ``torch.distributed.init_process_group``
    over ``tcp://coordinator_address`` (or, without one, the ``env://``
    variables ``torchrun`` sets), by default NCCL for a card and gloo for
    the CPU. Rank r drives ``device`` where it names a card's index, else
    ``cuda:<LOCAL_RANK or r mod cards>``. A rendezvous that does not
    complete in ``timeout_s`` raises."""
    import os

    import torch.distributed as dist

    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kwargs = {k: v for k, v in (("world_size", num_processes), ("rank", process_id)) if v is not None}
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None else 0))
            device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return DataGroup(dist.get_rank(), dist.get_world_size(), device)


def seed_group(world: DataGroup, n_seeds: int) -> DataGroup:
    """The (seed, data) grid over the ``world`` group's W ranks: rank ``s *
    D + d`` of W = ``n_seeds`` * D is rank d of seed s's group, a process
    group of its own (every rank creates every seed's, as
    ``torch.distributed.new_group`` asks). Raises where W does not divide
    by ``n_seeds``."""
    import torch.distributed as dist

    if n_seeds < 1 or world.size % n_seeds:
        raise ValueError(f"a grid of {n_seeds} seeds does not divide {world.size} ranks")
    if n_seeds == 1:
        return world
    d = world.size // n_seeds
    groups = [dist.new_group(list(range(s * d, (s + 1) * d))) for s in range(n_seeds)]
    s = world.rank // d
    return DataGroup(world.rank % d, d, world.device, groups[s], s * d, s, n_seeds)


def shard_batch(batch_arrays, group: DataGroup) -> tuple:
    """A rank's rows ``[r * B / N, (r + 1) * B / N)`` of each global (B,
    ...) host array, as tensors on the rank's device. An array whose B does
    not divide by N raises ``ValueError`` before any rows are taken, as
    JAX's ``shard_batch`` refuses to place it on the mesh."""
    arrays = [np.asarray(x) for x in batch_arrays]
    for x in arrays:
        if x.ndim == 0 or x.shape[0] % group.size:
            raise ValueError(f"shard_batch: an array of shape {x.shape} does not split into {group.size} ranks "
                             f"of equal rows: its first dimension must divide by {group.size}")
    out = []
    for x in arrays:
        local = x.shape[0] // group.size
        lo, hi, _ = group.rows(local)
        out.append(torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(group.device))
    return tuple(out)


def replicate(module: torch.nn.Module, group: Optional[DataGroup] = None) -> torch.nn.Module:
    """Every rank's parameters and buffers become its group's rank 0's (the
    default group's without one), in place."""
    import torch.distributed as dist

    src, pg = (group.root, group.pg) if group is not None else (0, None)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=pg)
    return module
