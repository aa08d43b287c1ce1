"""Vision pretraining of the classifiers (a weight-init experiment;
counterpart of ``howl_tpu/training/run/pretrain.py``; ref:
training/run/pretrain.py:24-127, CIFAR10/100 + FashionMNIST).

    python -m howl_tpu_torch.training.run.pretrain --model res8 --workspace WS [-i CIFAR_DIR | --synthetic]

Images (N, 3, 32, 32) are fed to the models as if they were (C, F, T)
spectrogram features, exactly the reference's trick: res8 reads channel 0.
The CIFAR-10 python-pickle batches are read from a local directory (no
download); ``--synthetic`` trains on generated data for smoke tests. The
flags, the epoch loop (one shuffled pass a epoch, full batches only) and the
returned ``test_acc`` are the JAX entry point's; ``--device`` picks the card
(default ``SETTINGS.training.device``) or the CPU.

The train step is the model's train-mode forward (res8's stem as the
differentiable conv chain), frame cross-entropy, backward and AdamW. The
eval step is the eval-mode forward: on a card res8's stem runs on the stem
kernel of ``ops/stem_cuda.py`` (K2) at 32 mel rows, the "fma" route in
float32. ``model-best.pt`` is written in the port's workspace format.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

from howl_tpu_torch.models import MODEL_REGISTRY, create_model
from howl_tpu_torch.ops.tf32 import exact_float32
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.training.objectives import frame_ce_loss
from howl_tpu_torch.training.state import TrainState, create_train_state, param_count
from howl_tpu_torch.training.step import StepDraws, _train_forward, step_generator
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.utils.platform import resolve_device
from howl_tpu_torch.utils.random_utils import set_random_seed
from howl_tpu_torch.workspace import Workspace


def load_cifar10(path: Path):
    """CIFAR-10 python pickle batches -> ((train_x, train_y), (test_x, test_y)),
    images as (N, 3, 32, 32) float32 in [0, 1]."""

    def load_batch(file):
        with file.open("rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = np.asarray(d[b"data"], np.float32).reshape(-1, 3, 32, 32) / 255.0
        y = np.asarray(d[b"labels"], np.int32)
        return x, y

    train = [load_batch(path / f"data_batch_{i}") for i in range(1, 6)]
    test_x, test_y = load_batch(path / "test_batch")
    return (
        (np.concatenate([t[0] for t in train]), np.concatenate([t[1] for t in train])),
        (test_x, test_y),
    )


def synthetic_dataset(num_classes: int = 10, n: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = rng.normal(0, 0.05, (n, 3, 32, 32)).astype(np.float32)
    for i in range(n):
        x[i, 0] += np.linspace(0, 1, 32)[None, :] * (y[i] + 1) / num_classes
    return (x[: int(0.8 * n)], y[: int(0.8 * n)]), (x[int(0.8 * n) :], y[int(0.8 * n) :])


def make_vision_steps() -> Tuple[Callable, Callable]:
    """(train_step(state, x, y, key) -> loss, eval_step(state, x) ->
    logits) on (B, 3, 32, 32) images on the state's device. A train step
    draws its dropout masks from ``step_generator(key, state.step)`` and
    updates ``state`` in place."""

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor, key: int) -> torch.Tensor:
        gen = step_generator(key, state.step, x.device)

        def forward(model):
            logits = model(x)
            return frame_ce_loss(logits, y), logits

        loss, _ = _train_forward(state, gen, StepDraws(None, None, None), forward)
        return loss.detach()

    @torch.no_grad()
    def eval_step(state: TrainState, x: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        return state.model(x)

    return train_step, eval_step


def run(args=None) -> dict:
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--model", type=str, choices=sorted(MODEL_REGISTRY), default="res8"),
        opt("--workspace", type=str, default="workspaces/pretrain"),
        opt("--dataset-path", "-i", type=str, default=None, help="CIFAR-10 python-format dir"),
        opt("--num-labels", type=int, default=10),
        opt("--synthetic", action="store_true", help="train on synthetic data (smoke test)"),
        opt("--device", type=str, default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu'; without a card only 'cpu' runs"),
    )
    args = apb.parser.parse_args(args)
    device = resolve_device(args.device)
    set_random_seed(SETTINGS.training.seed)

    if args.synthetic or args.dataset_path is None:
        Logger.info("using synthetic vision data")
        (train_x, train_y), (test_x, test_y) = synthetic_dataset(args.num_labels)
    else:
        (train_x, train_y), (test_x, test_y) = load_cifar10(Path(args.dataset_path))

    model = create_model(args.model, num_labels=args.num_labels)
    state = create_train_state(
        model,
        learning_rate=SETTINGS.training.learning_rate,
        weight_decay=SETTINGS.training.weight_decay,
        lr_decay=SETTINGS.training.lr_decay,
        steps_per_epoch=max(len(train_x) // SETTINGS.training.batch_size, 1),
        generator=torch.Generator().manual_seed(SETTINGS.training.seed),
        device=device,
    )
    Logger.info(f"{param_count(state)} parameters")
    train_step, eval_step = make_vision_steps()

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = SETTINGS.training.batch_size
    rng = np.random.default_rng(0)
    key = 1
    with exact_float32():  # TF32 off: float32 steps, as every float32 path of the port
        for epoch in range(SETTINGS.training.num_epochs):
            order = rng.permutation(len(train_x))
            losses = []
            for start in range(0, len(order) - batch + 1, batch):
                idx = order[start : start + batch]
                losses.append(float(train_step(state, put(train_x[idx]), put(train_y[idx]).long(), key)))
            Logger.info(f"epoch {epoch}: loss={np.mean(losses):.4f}")

        correct = total = 0
        for start in range(0, len(test_x) - batch + 1, batch):
            logits = eval_step(state, put(test_x[start : start + batch])).float().cpu().numpy()
            correct += int((logits.argmax(-1) == test_y[start : start + batch]).sum())
            total += batch
    acc = correct / max(total, 1)
    Logger.info(f"test accuracy: {acc:.4f}")

    workspace = Workspace(Path(args.workspace))
    workspace.save_model(state.model.state_dict(), best=True)
    return {"test_acc": acc}


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
