"""Training throughput of the res8 train step on the card (counterpart of
the root ``bench_train.py``, supplementary to ``howl_tpu_torch.bench``).

    python -m howl_tpu_torch.bench_train [--device cuda|cpu]

Times the whole train step, ``training.step.make_classification_train_step``
(on-device augmentation with the default ``AugmentConfig``, the VTLP
frontend, res8 with 4 labels, cross-entropy with negative label 3, AdamW at
learning rate 0.01 and decay 0.99), on seeded noise windows of 8,000
samples with random labels, and prints one JSON line per configuration, with
the root script's keys: ``metric``, ``value`` (steps/s), ``unit``
(``steps_per_sec_batch{B}``), ``examples_per_sec`` and ``final_loss``:

    res8_train_step_f32         float32 model, batch 128
    res8_train_step_bf16        bf16 model compute over float32 masters, batch 128
    res8_train_step_bf16_b1024  the same at batch 1024

The root script times 24 steps on the chip and 3 on the CPU, at batch 128 on
the chip and 8 on the CPU, and batch 1024 for the last line wherever it
runs; so does this. There is no noise bank, as in the root script, so the
noise-mix kernel does not run; the step's frontend is the float32 chain.
The steps are chained through the state (``bench.chained_step_ms``: CUDA
events on a card), after one warm-up chain of as many steps, as the root
script runs its scan twice.

The root script's bf16 configurations pass ``dft_precision=HIGH`` to its
step. The port's step has no such setting: its frontend runs in float32
with TF32 off for HIGHEST and HIGH alike (``training/step.py``). So the
port's bf16 lines differ from its f32 line only in the model's dtype.

It runs on the card: with ``--device cuda`` (the default) and no CUDA
device it raises. ``--device cpu`` runs the CPU sizes.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from howl_tpu_torch import bench
from howl_tpu_torch.tools._study import device_parser, pick_device

NUM_LABELS = 4
WINDOW_SAMPLES = 8000
SEED = 0


def bench_config(name: str, dtype, dev: torch.device, batch: Optional[int] = None, iters: Optional[int] = None) -> dict:
    """One configuration's record, printed as one JSON line."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.augment import AugmentConfig
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import StepConfig, make_classification_train_step

    on_card = dev.type == "cuda"
    batch = batch or (128 if on_card else 8)
    iters = iters or (24 if on_card else 3)
    cfg = StepConfig(FrontendConfig(n_mels=40), 0.0, 1.0, augment=AugmentConfig(), use_vtlp=True, negative_label=3,
                     use_deltas=False)
    model = create_model("res8", num_labels=NUM_LABELS, dtype=dtype)
    variables = bench.res8_numpy_variables(np.random.default_rng(SEED), NUM_LABELS)
    state = create_train_state(model, 0.01, lr_decay=0.99, steps_per_epoch=100, variables=variables, device=dev)
    step = make_classification_train_step(model, cfg)

    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy((rng.standard_normal((batch, WINDOW_SAMPLES)) * 0.1).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_LABELS, batch)).to(dev)
    last = []
    bench.chained_step_ms(step, state, audio, labels, iters)  # the warm-up chain
    ms = bench.chained_step_ms(step, state, audio, labels, iters, last)
    steps_per_sec = 1e3 / ms
    record = {
        "metric": f"res8_train_step_{name}",
        "value": round(steps_per_sec, 2),
        "unit": f"steps_per_sec_batch{batch}",
        "examples_per_sec": round(steps_per_sec * batch, 1),
        "final_loss": round(float(last[-1]["loss"]), 4),
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> list:
    args = device_parser(__doc__).parse_args(argv)
    dev = pick_device(args.device)
    return [
        bench_config("f32", None, dev),
        bench_config("bf16", torch.bfloat16, dev),
        bench_config("bf16_b1024", torch.bfloat16, dev, batch=1024),
    ]


if __name__ == "__main__":
    main()
