"""Data-parallel training over a group of ranks, one card each (item 12 of
the port; the JAX package gets it from GSPMD over the mesh's ``data`` axis,
``howl_tpu/training/run/train.py:390-402,462-477``).

``--num-devices N`` of an entry point launches the N ranks itself: the
calling process becomes rank 0 and spawns ranks 1..N-1 (``launch``), each
joining a ``torch.distributed`` group on a free local port (NCCL on cards,
gloo for ``--device cpu``), with the caller's settings. Under ``torchrun``
(``WORLD_SIZE`` set) the entry point joins the group it finds instead.

N ranks compute what one process computes on the global batch:

* every rank reads the same global batch and draws the step's randomness
  for the whole batch from the same generator (noise rows, offsets and
  alpha, timeshift, the noise draws, the VTLP alpha, SpecAugment, the
  dropout masks), then takes its rows ``[r * B / N, (r + 1) * B / N)``
  (``take_rows``);
* BatchNorm in training normalizes by the global batch's statistics: the
  per-channel sums of x and x^2 and the row counts are all-reduced in
  float32 through ``torch.distributed.nn.functional.all_reduce``, whose
  backward all-reduces the statistics' gradients too
  (``models/base.batch_moments``);
* each rank's loss is its rows' mean; the gradients are averaged over the
  group before AdamW (``average_gradients``: one all-reduce of the
  flattened gradients; the step updates its state in place, so it takes no
  DDP wrapper), and the logged loss is the global mean (``all_mean``).

The N-seed sweep runs the same way on a (seed S, data D) grid of S * D
ranks (``launch`` or ``run_ranks`` with a ``Mesh``; ``mesh.seed_group``):
each rank's group is its seed's D ranks, and every collective below runs on
the group it is given. Rank (s, 0) writes seed s's files.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import socket
import sys
import traceback
from typing import Optional

import torch

from howl_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    DataGroup,
    Mesh,
    initialize_multihost,
    mesh_backend,
    seed_group,
)
from howl_tpu_torch.utils.logger import Logger

_GROUP: Optional[DataGroup] = None
TIMEOUT_S = DEFAULT_TIMEOUT_S  # the rendezvous and each collective; the launcher joins its ranks within it too


def current_group() -> Optional[DataGroup]:
    """The data group this process runs in, or None."""
    return _GROUP


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def joined(rank: Optional[int], size: Optional[int], device, address: Optional[str] = None,
           timeout_s: Optional[float] = None, backend: Optional[str] = None, seeds: int = 1):
    """Join a group as ``rank`` of ``size`` (``address`` None: the
    ``env://`` variables of ``torchrun``), yield its ``DataGroup`` (with
    ``seeds`` > 1, this rank's seed's group of the grid) and leave it on
    exit."""
    import torch.distributed as dist

    global _GROUP
    group = initialize_multihost(address, size, rank, device=device, timeout_s=timeout_s or TIMEOUT_S,
                                 backend=backend)
    try:
        group = seed_group(group, seeds)
    except BaseException:
        dist.destroy_process_group()
        raise
    _GROUP = group
    try:
        yield group
    finally:
        _GROUP = None
        dist.destroy_process_group()


def under_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def data_size(num_devices: int, batch_size: int, device: torch.device) -> int:
    """How many ranks a run takes: ``num_devices``, or by default the
    largest divisor of the batch size no larger than the visible cards (1
    on the CPU), as the JAX entry point sizes its data axis. Raises before
    anything is read or written when the batch does not split or the cards
    are too few; nothing falls back to fewer ranks."""
    if under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if num_devices not in (0, world):
            raise SystemExit(f"--num-devices {num_devices} but torchrun started {world} ranks")
        num_devices = world
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if not num_devices:
        return max(d for d in range(1, max(available, 1) + 1) if batch_size % d == 0)
    if batch_size % num_devices:
        raise SystemExit(f"--num-devices {num_devices} must divide the batch size {batch_size}")
    if device.type == "cuda" and num_devices > available and not under_torchrun():
        raise RuntimeError(f"--num-devices {num_devices} needs {num_devices} cards, one a rank; {available} visible "
                           "(NCCL puts no two ranks on one card)")
    return num_devices


def _worker(module: str, argv: list, rank: int, size: int, address: str, device: str, settings: dict,
            timeout_s: float, backend: Optional[str] = None, seeds: int = 1) -> None:
    from howl_tpu_torch.settings import SETTINGS

    try:
        SETTINGS.load_dict(settings)
        with joined(rank, size, device, address, timeout_s, backend, seeds):
            importlib.import_module(module).run(argv)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def launch(module: str, argv: list, size: int, device: torch.device, timeout_s: Optional[float] = None,
           mesh: Optional[Mesh] = None, **kwargs):
    """``module.run(argv, **kwargs)`` on ``size`` ranks: this process is
    rank 0 and returns its result; ranks 1..size-1 are spawned processes,
    joined within ``timeout_s`` (default ``TIMEOUT_S``) after rank 0 is
    done. A rank that fails fails the launch. With a ``mesh`` the ranks
    are its (seed, data) grid: rank r on the mesh's r-th device (seed-major),
    its group its seed's (``mesh.seed_group``), over ``mesh.mesh_backend``'s
    backend, which a log line names where ranks share a card."""
    import multiprocessing as mp

    from howl_tpu_torch.settings import SETTINGS

    timeout_s = timeout_s or TIMEOUT_S
    devices, backend, seeds = [device.type] * size, None, 1
    if mesh is not None:
        size, seeds, backend = mesh.size, mesh.shape["seed"], mesh_backend(mesh)
        devices = [str(d) for d in mesh.device_list()]
        shared = [d for d in dict.fromkeys(devices) if devices.count(d) > 1 and d != "cpu"]
        Logger.info(f"grid of {seeds} seeds x {mesh.shape['data']} ranks on {backend}"
                    + (f": the ranks share {', '.join(shared)}, so gloo runs over CUDA tensors (NCCL puts no two "
                       "ranks on one card)" if shared else ""))
    address = f"127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    settings = SETTINGS.to_dict()
    procs = [ctx.Process(target=_worker, args=(module, list(argv), r, size, address, devices[r], settings, timeout_s,
                                               backend, seeds), daemon=True) for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        with joined(0, size, devices[0], address, timeout_s, backend, seeds):
            result = importlib.import_module(module).run(argv, **kwargs)
    finally:
        for p in procs:
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"data-parallel rank(s) {failed} of {size} failed")
    return result


def run_ranks(module: str, argv: list, size: int, device: torch.device, mesh: Optional[Mesh] = None, **kwargs):
    """Run ``module.run(argv)`` as a data group, or with a ``mesh`` as its
    (seed, data) grid: join the torchrun group this process belongs to
    (its ``WORLD_SIZE`` ranks split over the mesh's seeds), or ``launch``
    ``size`` ranks (the mesh's)."""
    if under_torchrun():
        with joined(None, None, device.type, seeds=mesh.shape["seed"] if mesh is not None else 1):
            return importlib.import_module(module).run(argv, **kwargs)
    return launch(module, argv, size, device, mesh=mesh, **kwargs)


# ---- the collectives of a step ----


def take_rows(tree, lo: int, hi: int, total: int):
    """The rows [lo, hi) of every tensor of ``tree`` (NamedTuples, tuples,
    lists, None) whose first axis holds the ``total`` rows of a global
    batch; 0-d tensors (one draw for the whole batch) stay whole."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[lo:hi] if tree.ndim and tree.shape[0] == total else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(take_rows(x, lo, hi, total) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(take_rows(x, lo, hi, total) for x in tree)
    return tree


def average_gradients(params, group: DataGroup) -> None:
    """Every parameter's ``.grad`` becomes its mean over the group: one
    all-reduce of the flattened gradients."""
    import torch.distributed as dist

    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group.pg)
    flat /= group.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def all_mean(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The group's mean of a tensor (without gradients)."""
    import torch.distributed as dist

    t = t.detach().float().clone()
    dist.all_reduce(t, group=group.pg)
    return t / group.size


def all_sum(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    import torch.distributed as dist

    t = t.detach().clone()
    dist.all_reduce(t, group=group.pg)
    return t


def gather_rows(t: torch.Tensor, group: DataGroup, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t.contiguous(), group=group.pg)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, group: DataGroup):
    """The group's rank 0's ``obj`` on every rank of the group."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=group.root, group=group.pg)
    return box[0]


def gather_objects(obj, group: DataGroup) -> list:
    """Every rank's ``obj``, in the group's rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def barrier(group: DataGroup) -> None:
    import torch.distributed as dist

    if dist.get_backend(group.pg) == "nccl":
        dist.barrier(group=group.pg, device_ids=[group.device.index])
    else:
        dist.barrier(group=group.pg)


def kernel_launches() -> dict:
    """This process's launch counts of the three kernels of the training
    and evaluation paths (each wrapper's ``launches``): K1, K2, K3."""
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    return {"k1": log_mel_spectrogram_cuda.launches, "k2": res8_stem_cuda.launches, "k3": mix_noise_bank_cuda.launches}


__all__ = ["DataGroup", "all_mean", "all_sum", "average_gradients", "barrier", "broadcast_object",
           "current_group", "data_size", "free_port", "gather_objects", "gather_rows", "joined",
           "kernel_launches", "launch", "run_ranks", "take_rows", "under_torchrun"]
