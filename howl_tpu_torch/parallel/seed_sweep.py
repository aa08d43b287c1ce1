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

Across cards (a ``Mesh`` of k devices, ``parallel/mesh.py``), seed s lives
on device ``s mod k`` in this one process: its train state, its batch
(``shard_seed_batch(..., mesh=)``, one tensor a seed) and its generator.
Each device mixes its seeds' noise in one K3 launch over those seeds'
examples, and each seed's losses and weights are bit for bit its
one-device numbers. The JAX package also splits each seed's batch over the
mesh's ``data`` axis; that changes no number there, and the port does not
reproduce it.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
from howl_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_cards
from howl_tpu_torch.training.state import TrainState, create_train_state
from howl_tpu_torch.training.step import NoiseBankTrainStep, draw_step, step_generator


def sweep_mesh(n_seeds: int, device) -> Mesh:
    """The mesh a sweep of ``n_seeds`` spreads over: up to ``n_seeds``
    visible cards for a CUDA ``device`` (the JAX harness's
    ``make_mesh(seed=n_seeds, ...)``), the CPU alone for the CPU."""
    device = torch.device(device)
    devices = visible_cards()[:n_seeds] if device.type == "cuda" else [device]
    return make_mesh(data=len(devices), devices=devices)


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
    them."""

    def __init__(self, train_step: Callable):
        self.train_step = train_step
        banked = isinstance(train_step, NoiseBankTrainStep)
        self._inner = train_step.inner if banked else train_step
        self.cfg = self._inner.cfg
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
        if draws is None:
            draws = [draw_step(gen, self.cfg, b, n, bank) for gen, bank in zip(gens, banks)]
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


def shard_seed_batch(batch_arrays, device="cuda", mesh=None) -> tuple:
    """Place (S, B, ...) host arrays: stacked on ``device`` (or a mesh's
    one device), or with a mesh of several devices a list of S per-seed
    tensors, seed s's on its device (``seed_devices``). The JAX package
    splits them over the mesh's (seed, data) axes."""
    if mesh is None or mesh.size == 1:
        device = mesh.device_list()[0] if mesh is not None else device
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch_arrays)
    out = []
    for x in batch_arrays:
        devices = seed_devices(len(x), mesh=mesh)
        out.append([torch.from_numpy(np.ascontiguousarray(x[i])).to(devices[i]) for i in range(len(x))])
    return tuple(out)
