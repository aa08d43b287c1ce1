"""N-seed experiment sweep on one card (counterpart of
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
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
from howl_tpu_torch.training.state import TrainState, create_train_state
from howl_tpu_torch.training.step import NoiseBankTrainStep, draw_step, step_generator


def create_seed_states(model: torch.nn.Module, seeds: Sequence[int], variables: Optional[list] = None,
                       device="cuda", **opt_kwargs) -> List[TrainState]:
    """One train state a seed, each on its own copy of ``model``: seed s's
    weights are initialized from ``torch.Generator().manual_seed(s)``, or
    are ``variables[s]`` (JAX-layout variables, as ``create_train_state``
    takes them). ``opt_kwargs`` go to ``create_train_state``."""
    states = []
    for idx, seed in enumerate(np.asarray(seeds).tolist()):
        init = ({"variables": variables[idx]} if variables is not None
                else {"generator": torch.Generator().manual_seed(int(seed))})
        states.append(create_train_state(copy.deepcopy(model), device=device, **init, **opt_kwargs))
    return states


class SeedSweepStep:
    """(states, audio (S, B, n), labels (S, B), *lengths (S, B) each, keys
    (S,), draws=None) -> (states, metrics with (S,) values), ``states``
    updated in place. The lengths are the per-model step's: (lengths,) for
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
        s, b, n = audio.shape
        if len(states) != s or len(keys) != s:
            raise ValueError(f"{len(states)} states and {len(keys)} keys for {s} seeds")
        gens = [step_generator(int(keys[i]), states[i].step, audio.device) for i in range(s)]
        bank = self.train_step.prepared_for(n, audio.device) if self._banked else None
        if draws is None:
            draws = [draw_step(gen, self.cfg, b, n, bank) for gen in gens]
        if bank is not None:
            # every seed's rows in one launch; the per-seed steps then skip their own mix
            mixes = [d.augment.mix for d in draws]
            flat = mix_noise_bank_cuda(
                audio.reshape(s * b, n).contiguous(), bank.extended, torch.cat([m.rows for m in mixes]),
                torch.cat([m.offs for m in mixes]), torch.cat([m.alpha for m in mixes]),
            )
            audio = flat.reshape(s, b, n)
            replaced = torch.stack([m.replaced for m in mixes])
            if self.cfg.replace_prob > 0:  # the frame objective relabels the clips the mix replaced
                labels = torch.where(replaced, self.cfg.negative_label, labels)
            draws = [d._replace(augment=d.augment._replace(mix=None)) for d in draws]
        metrics = []
        for i in range(s):
            seed_lengths = (None if x is None else x[i] for x in lengths)
            states[i], m = self._inner(states[i], audio[i], labels[i], *seed_lengths, int(keys[i]), draws=draws[i],
                                       gen=gens[i])
            metrics.append(m)
        return states, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_seed_sweep_step(train_step: Callable) -> SeedSweepStep:
    """The sweep over the leading seed dim of a per-model train step made by
    ``make_classification_train_step`` or ``make_ctc_train_step``."""
    return SeedSweepStep(train_step)


def shard_seed_batch(batch_arrays, device="cuda") -> tuple:
    """Place (S, B, ...) host arrays on the card (the JAX package splits
    them over the mesh's (seed, data) axes)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch_arrays)
