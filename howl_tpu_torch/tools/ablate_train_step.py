"""Component timing of the res8 train step at the bench's configuration, on
the card (counterpart of ``tools/ablate_train_step.py``).

    python -m howl_tpu_torch.tools.ablate_train_step [--device cuda] [--batch 1024] [--iters 64]

Times chains of ``iters`` steps of variants of the bf16 train step over
float32 masters (the bench's ``train_examples_per_sec`` step, without the
noise bank), so its cost can be attributed before optimization work:

  * full step: augmentation, VTLP frontend, res8 forward and backward, AdamW;
  * no wave/spec augmentation;
  * static frontend (no VTLP);
  * forward only: the same augmentation and features and the loss in train
    mode (BatchNorm stats move), no gradient and no optimizer;
  * model forward and backward only: features precomputed once, full
    gradient and AdamW (the rest is the frontend's and augmentation's share).

Each variant's rate is the best of four chains (CUDA events), in examples
per second, as the JAX tool gives it. It runs on the card: with ``--device
cuda`` (the default) and no CUDA device it raises. ``--device cpu`` runs
the plain versions at batch 8, 2 steps, on the host clock.
"""

from __future__ import annotations

import numpy as np
import torch

from howl_tpu_torch.tools._study import device_parser, pick_device

CHAINS = 4


def run(batch: int, iters: int, seed: int, dev: torch.device) -> dict:
    """{variant: examples per second}."""
    from howl_tpu_torch.bench import NUM_LABELS, TRAIN_WINDOW, chained_step_ms, train_setup
    from howl_tpu_torch.ops import augment as aug
    from howl_tpu_torch.training.objectives import frame_ce_loss
    from howl_tpu_torch.training.step import draw_step, featurize, make_classification_train_step, step_generator

    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((batch, TRAIN_WINDOW)) * 0.1).astype(np.float32)
    labels = rng.integers(0, NUM_LABELS, batch)
    audio, labels, _, cfg, state_for = train_setup(dev, audio, labels, None, seed)
    model, state = state_for(torch.bfloat16)

    def fwd_only(state, audio_, labels_, lengths_, key):
        b, n = audio_.shape
        draws = draw_step(step_generator(key, state.step, audio_.device), cfg, b, n)
        with torch.no_grad():
            a, replaced = aug.apply_augment_audio(audio_, draws.augment, cfg.augment)
            feats = aug.apply_spec_augment(featurize(a, cfg, draws.vtlp_alpha), draws.spec)
            state.model.train()
            loss = frame_ce_loss(state.model(feats), torch.where(replaced, cfg.negative_label, labels_))
        state.step += 1
        return state, {"loss": loss}

    with torch.no_grad():
        feats_fixed = featurize(audio, cfg)

    def model_only(state, audio_, labels_, lengths_, key):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = frame_ce_loss(state.model(feats_fixed), labels_)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    variants = {
        "full step": make_classification_train_step(model, cfg),
        "no wave/spec aug": make_classification_train_step(model, cfg._replace(augment=None)),
        "static frontend (no VTLP)": make_classification_train_step(model, cfg._replace(use_vtlp=False)),
        "forward only (no grad/opt)": fwd_only,
        "model fwd/bwd only": model_only,
    }
    print(f"batch={batch} iters={iters}", flush=True)
    rates = {}
    for name, step in variants.items():
        step(state, audio, labels, None, 0)  # warm-up
        best_ms = min(chained_step_ms(step, state, audio, labels, iters) for _ in range(CHAINS))
        rates[name] = batch / (best_ms / 1e3)
        print(f"{name:28s}: {rates[name]:10,.0f} ex/s", flush=True)
    return rates


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = args.batch or (1024 if on_card else 8)
    iters = args.iters or (64 if on_card else 2)
    return run(batch, iters, args.seed, dev)


if __name__ == "__main__":
    main()
