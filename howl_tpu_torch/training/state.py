"""Train state: a model with its parameters and BatchNorm stats, AdamW, the
step count and the learning-rate schedule (counterpart of
``howl_tpu/training/state.py``).

AdamW is ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)`` with decoupled
weight decay on every parameter, as ``optax.adamw`` applies it
(tests/test_adamw_vs_torch.py pins that the two agree). The learning rate is
optax's staircase exponential decay, ``lr * decay ** (step //
steps_per_epoch)``, evaluated at the step count before the update.

Unlike the JAX package's immutable state, this one is updated in place by
the train step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from howl_tpu_torch.compat import variables_to_state_dict


def exponential_decay(learning_rate: float, lr_decay: float, steps_per_epoch: int) -> Callable[[int], float]:
    """optax.exponential_decay(staircase=True) as a function of the step."""
    transition = max(steps_per_epoch, 1)
    return lambda step: learning_rate * lr_decay ** (step // transition)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    @property
    def learning_rate(self) -> float:
        return self.schedule(self.step)

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at the scheduled
        learning rate, then step += 1."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate
        self.optimizer.step()
        self.step += 1


def create_train_state(
    model: torch.nn.Module,
    learning_rate: float,
    weight_decay: float = 0.0,
    lr_decay: float = 1.0,
    steps_per_epoch: int = 1,
    variables=None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> TrainState:
    """A train state for ``model`` on ``device``: the card unless the caller
    passes ``"cpu"``. A CUDA device that does not exist raises; nothing
    falls back to the CPU.

    ``variables`` are the model's variables in the JAX package's layout
    (``{"params": ..., "batch_stats": ...}`` as numpy, carried across by
    ``compat.variables_to_state_dict``; a ``ConvertedStaticModel`` takes its
    inner classifier's), so both packages can start from the same weights;
    without them the model is initialized with flax's initializers from
    ``generator``, which is then required. Parameters are float32 master
    weights whatever the model's compute dtype.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
    if variables is not None:
        target = getattr(model, "inner", model)  # ConvertedStaticModel wraps the classifier the variables are of
        target.load_state_dict(variables_to_state_dict(target.registered_name, variables), strict=True)
    elif generator is not None:
        model.init_weights(generator)
    else:
        raise ValueError("create_train_state needs JAX-layout variables or a torch.Generator to initialize from")
    model.to(device=device, dtype=torch.float32).train()
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    return TrainState(model, optimizer, exponential_decay(learning_rate, lr_decay, steps_per_epoch))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
