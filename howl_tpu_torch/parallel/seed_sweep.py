"""N-seed experiment sweep on one card or across cards (counterpart of
``howl_tpu/parallel/seed_sweep.py``).

The reference trains N seeds as N OS processes pinned to GPUs by env var,
scheduled by polling ``ps aux`` (ref: training/run/eval_wake_word_detection.py:23-63).
The JAX package stacks the seeds' train states on a leading seed axis and
vmaps one train step over it. Here the seeds' batches are stacked on the
card as (S, B, ...) tensors and one sweep step trains them all: seed s
computes exactly what the single-model step computes at key s, as under
``jax.vmap``.

* Each seed draws its step from its own ``step_generator(key_s, step_s)``,
  in the single step's order (``draw_step``, then the model's dropout
  masks).
* The noise-bank mix of all S seeds is ONE launch of the kernel of
  ``ops/augment_cuda.py`` (K3) over S x B examples against the shared
  prepared bank: K3 works example by example, so the stacked launch gives
  every seed's rows bit for bit what its own launch gives.
* Each seed's forward, backward and AdamW update then run in turn, on its
  own ``nn.Module`` and optimizer (the port's train state is updated in
  place). A stacked forward over the seeds (``torch.func.stack_module_state``
  with a vmap rule for the stem kernel's autograd path, or grouped
  convolutions) is later work (ROADMAP, "Other device work").

The sweep lays its seeds out on the JAX harness's mesh, (seed S, data
max(cards // S, 1)) (``sweep_mesh``).

* With ``data`` 1 the sweep runs in this one process, seed s on the mesh's
  device ``s mod k``: its train state, its batch (``shard_seed_batch(...,
  mesh=)``, one tensor a seed) and its generator. Each device mixes its
  seeds' noise in one K3 launch over those seeds' examples, and each seed's
  losses and weights are bit for bit its one-device numbers.
* With ``data`` D > 1 it runs on a (seed, data) grid of S * D ranks
  (``parallel/data_parallel.py``), as JAX splits each seed's batch over
  the mesh's ``data`` axis. Rank (s, d) trains seed s alone with a step
  built on its seed's data group (``mesh.seed_group``): it draws seed s's
  whole step from ``step_generator(key_s, step)``, as the data-parallel
  step does for one model, takes rows ``[d * B / D, (d + 1) * B / D)``
  (``shard_seed_batch(..., group=)``), launches K3 once a step over its
  rows, and reduces the BatchNorm moments and the gradients over seed s's
  D ranks; the logged loss is the seed's global mean.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
from howl_tpu_torch.parallel.mesh import DataGroup, Mesh, make_mesh, visible_cards
from howl_tpu_torch.training.state import TrainState, create_train_state
from howl_tpu_torch.training.step import NoiseBankTrainStep, _global_draws, step_generator


def sweep_mesh(n_seeds: int, device, cards: Optional[Sequence] = None) -> Mesh:
    """The mesh a sweep of ``n_seeds`` lays out on ``cards`` (default: the
    visible cards) for a CUDA ``device``, the CPU alone for the CPU: the
    JAX harness's ``make_mesh(seed=S, data=max(k // S, 1))`` over k
    devices. Where the seeds outnumber the devices, where JAX's mesh does
    not fit, it is (k, 1): one process, seed s on device ``s mod k``."""
    device = torch.device(device)
    cards = [torch.device(c) for c in (visible_cards() if cards is None else cards)] if device.type == "cuda" \
        else [device]
    if n_seeds > len(cards):
        return make_mesh(seed=len(cards), data=1, devices=cards)
    return make_mesh(seed=n_seeds, data=len(cards) // n_seeds, devices=cards)


def seed_devices(n_seeds: int, device="cuda", mesh=None) -> list:
    """Where each seed lives: seed s on the mesh's device ``s mod k``, or
    every seed on ``device``."""
    if mesh is None:
        return [torch.device(device)] * n_seeds
    devices = mesh.device_list()
    return [devices[s % len(devices)] for s in range(n_seeds)]


def create_seed_states(model: torch.nn.Module, seeds: Sequence[int], variables: Optional[list] = None,
                       device="cuda", mesh=None, **opt_kwargs) -> List[TrainState]:
    """One train state a seed, each on its own copy of ``model`` on its
    device (``seed_devices``): seed s's weights are initialized from
    ``torch.Generator().manual_seed(s)``, or are ``variables[s]`` (JAX-layout
    variables, as ``create_train_state`` takes them). ``opt_kwargs`` go to
    ``create_train_state``."""
    seeds = np.asarray(seeds).tolist()
    states = []
    for idx, (seed, dev) in enumerate(zip(seeds, seed_devices(len(seeds), device, mesh))):
        init = ({"variables": variables[idx]} if variables is not None
                else {"generator": torch.Generator().manual_seed(int(seed))})
        states.append(create_train_state(copy.deepcopy(model), device=dev, **init, **opt_kwargs))
    return states


class SeedSweepStep:
    """(states, audio (S, B, n), labels (S, B), *lengths (S, B) each, keys
    (S,), draws=None) -> (states, metrics with (S,) values on the first
    seed's device), ``states`` updated in place. Across devices each batch
    argument is a list of S per-seed tensors, seed s's on its state's
    device (``shard_seed_batch`` with a mesh). The lengths are the per-model step's: (lengths,) for
    the frame objective (None: whole windows), (audio_lengths,
    label_lengths) for CTC. ``draws``,
    one ``StepDraws`` a seed, replays given draws as the single step takes
    them. A per-model step built on a data group (a seed's group of a
    (seed, data) grid) makes each batch argument this rank's rows of the
    seed's global batch and ``draws`` the global batch's."""

    def __init__(self, train_step: Callable):
        self.train_step = train_step
        banked = isinstance(train_step, NoiseBankTrainStep)
        self._inner = train_step.inner if banked else train_step
        self.cfg = self._inner.cfg
        self.group: Optional[DataGroup] = self._inner.group
        self._banked = banked and self.cfg.augment is not None

    def __call__(self, states: List[TrainState], audio: torch.Tensor, labels: torch.Tensor, *rest,
                 draws: Optional[list] = None):
        *lengths, keys = rest
        s = len(audio)
        b, n = audio[0].shape
        if len(states) != s or len(keys) != s:
            raise ValueError(f"{len(states)} states and {len(keys)} keys for {s} seeds")
        devices = [audio[i].device for i in range(s)]
        gens = [step_generator(int(keys[i]), states[i].step, devices[i]) for i in range(s)]
        banks = [self.train_step.prepared_for(n, d) if self._banked else None for d in devices]
        draws = [_global_draws(gen, self.cfg, b, n, bank, None if draws is None else draws[i], self.group)[0]
                 for i, (gen, bank) in enumerate(zip(gens, banks))]
        audio, labels = [audio[i] for i in range(s)], [labels[i] for i in range(s)]
        if self._banked:
            # each device's seeds' rows in one launch; the per-seed steps then skip their own mix
            for dev in dict.fromkeys(devices):
                idx = [i for i in range(s) if devices[i] == dev]
                mixes = [draws[i].augment.mix for i in idx]
                flat = mix_noise_bank_cuda(
                    torch.cat([audio[i] for i in idx]).contiguous(), banks[idx[0]].extended,
                    torch.cat([m.rows for m in mixes]), torch.cat([m.offs for m in mixes]),
                    torch.cat([m.alpha for m in mixes]),
                )
                for j, i in enumerate(idx):
                    audio[i] = flat[j * b : (j + 1) * b]
                    if self.cfg.replace_prob > 0:  # the frame objective relabels the clips the mix replaced
                        labels[i] = torch.where(mixes[j].replaced, self.cfg.negative_label, labels[i])
            draws = [d._replace(augment=d.augment._replace(mix=None)) for d in draws]
        metrics = []
        for i in range(s):
            seed_lengths = (None if x is None else x[i] for x in lengths)
            states[i], m = self._inner(states[i], audio[i], labels[i], *seed_lengths, int(keys[i]), draws=draws[i],
                                       gen=gens[i])
            metrics.append(m)
        return states, {k: torch.stack([m[k].to(devices[0]) for m in metrics]) for k in metrics[0]}


def make_seed_sweep_step(train_step: Callable) -> SeedSweepStep:
    """The sweep over the leading seed dim of a per-model train step made by
    ``make_classification_train_step`` or ``make_ctc_train_step``."""
    return SeedSweepStep(train_step)


def shard_seed_batch(batch_arrays, device="cuda", mesh=None, group: Optional[DataGroup] = None) -> tuple:
    """Place (S, B, ...) host arrays: stacked on ``device`` (or a mesh's
    one device), or with a mesh of several devices a list of S per-seed
    tensors, seed s's on its device (``seed_devices``). With a data group
    (a seed's group of a grid) the rank's rows ``[d * B / D, (d + 1) * B /
    D)`` of each, stacked on the group's device; a B that does not divide
    by D raises ``ValueError``. The JAX package splits them over the mesh's
    (seed, data) axes."""
    if group is not None:
        from howl_tpu_torch.parallel.mesh import shard_batch

        arrays = [np.moveaxis(np.asarray(x), 1, 0) for x in batch_arrays]  # (B, S, ...): rows first
        return tuple(x.movedim(0, 1).contiguous() for x in shard_batch(arrays, group))
    if mesh is None or mesh.size == 1:
        device = mesh.device_list()[0] if mesh is not None else device
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch_arrays)
    out = []
    for x in batch_arrays:
        devices = seed_devices(len(x), mesh=mesh)
        out.append([torch.from_numpy(np.ascontiguousarray(x[i])).to(devices[i]) for i in range(len(x))])
    return tuple(out)
