"""Parallel training (counterpart of ``howl_tpu/parallel``): the device
mesh and data parallelism over several cards (``mesh.py``,
``data_parallel.py``) and the N-seed sweep on one card or across cards
(``seed_sweep.py``)."""

from howl_tpu_torch.parallel.mesh import DataGroup, Mesh, make_mesh, replicate, shard_batch
from howl_tpu_torch.parallel.seed_sweep import (
    SeedSweepStep,
    create_seed_states,
    make_seed_sweep_step,
    seed_devices,
    shard_seed_batch,
)

__all__ = ["DataGroup", "Mesh", "SeedSweepStep", "create_seed_states", "make_mesh", "make_seed_sweep_step",
           "replicate", "seed_devices", "shard_batch", "shard_seed_batch"]
