"""The device mesh and the data group (counterpart of
``howl_tpu/parallel/mesh.py``).

The JAX package runs scale-out as one jitted program over a
``jax.sharding.Mesh`` with axes ``("seed", "data")``. PyTorch has no such
program, so the port splits the two uses:

* ``make_mesh`` returns a ``Mesh``: a (seed, data) array of torch devices
  that one process drives. The live engines split their streams over it
  (``shard_streams``, no collectives: each shard steps on its own device)
  and the seed sweep places seed s on device ``s mod k``. By default it
  takes every visible card once; an explicit ``devices=`` list may repeat
  a device, which is how one host exercises a split (``["cpu"] * 4`` in
  the tests, ``[cuda:0, cuda:0]`` on a one-card machine).
* Data parallelism runs one process a card (``torch.distributed``; NCCL on
  cards, gloo only for the CPU). ``initialize_multihost`` joins such a
  group and returns its ``DataGroup``; ``shard_batch`` takes a rank's rows
  of a global batch and ``replicate`` makes every rank's weights rank 0's.
  ``parallel/data_parallel.py`` launches the ranks and holds the
  collectives of the train step (global BatchNorm statistics, the gradient
  average).
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


class DataGroup(NamedTuple):
    """One rank of the data-parallel process group (``torch.distributed``'s
    default group): rank ``rank`` of ``size`` on ``device``."""

    rank: int
    size: int
    device: torch.device

    def rows(self, local: int) -> tuple:
        """(lo, hi, total): this rank's rows of a global batch of
        ``local * size`` rows."""
        return self.rank * local, (self.rank + 1) * local, local * self.size


def initialize_multihost(coordinator_address: str = None, num_processes: int = None, process_id: int = None,
                         device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """Join a data-parallel group: ``torch.distributed.init_process_group``
    over ``tcp://coordinator_address`` (or, without one, the ``env://``
    variables ``torchrun`` sets), NCCL for a card and gloo for the CPU.
    Rank r drives ``cuda:<LOCAL_RANK or r mod cards>`` on a card. A
    rendezvous that does not complete in ``timeout_s`` raises."""
    import os

    import torch.distributed as dist

    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kwargs = {k: v for k, v in (("world_size", num_processes), ("rank", process_id)) if v is not None}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None else 0))
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return DataGroup(dist.get_rank(), dist.get_world_size(), device)


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


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every rank's parameters and buffers become rank 0's, in place."""
    import torch.distributed as dist

    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
