"""Parallel training (counterpart of ``howl_tpu/parallel``): the N-seed
sweep on one card (``seed_sweep.py``). The device mesh of ``mesh.py``, data
parallelism over several cards, waits for ROADMAP Queue 1, item 12."""

from howl_tpu_torch.parallel.seed_sweep import (
    SeedSweepStep,
    create_seed_states,
    make_seed_sweep_step,
    shard_seed_batch,
)

__all__ = ["SeedSweepStep", "create_seed_states", "make_seed_sweep_step", "shard_seed_batch"]
