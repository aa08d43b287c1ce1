"""GSC keyword-classification pretraining (counterpart of
``howl_tpu/training/run/pretrain_gsc.py``; ref: training/run/pretrain_gsc.py:22-148).

    python -m howl_tpu_torch.training.run.pretrain_gsc --model res8 --workspace WS [--sharded-seeds N] [--device cuda|cpu]

after ``source envs/pretrain-gsc.env`` (``DATASET_PATH`` names the Speech
Commands tree). The flow is the JAX entry point's: the GSC loader
(``data/dataset/gsc_loader.py``; ``--silence-proportion`` adds the
``__silence__`` label at ``len(vocab) + 1``), the ZMUV fit over at most 128
batches of the shuffled train sampler, AdamW with the staircase learning-rate
decay over ``len(train) // batch`` steps an epoch, the classification train
step with augmentation and VTLP (``--no-augment`` turns both off) and no
noise bank, per-epoch ``Training/Loss`` and ``Dev/Metric/acc`` with a
checkpoint kept by dev accuracy, the final ``Test/Metric/acc``; ``--eval``
and ``--load-weights`` read ``model-best.pt``; ``--bf16`` trains the model
in bf16 over float32 masters. The samplers are seeded as JAX seeds them: the
train sampler by the epoch, the eval samplers unshuffled, with the last
partial batch padded and only its ``valid`` rows counted.

``--sharded-seeds N`` (N > 1) trains seeds 0..N-1 at once through
``parallel/seed_sweep.py`` on the JAX entry point's (seed N, data
max(cards // N, 1)) mesh: with ``data`` 1 in this process, seed s on card
s mod k of the visible cards; with ``data`` D > 1 on a grid of N * D ranks,
rank (s, d) training seed s on rows d of its batches and scoring rows d of
each eval batch (``run(..., mesh=)`` takes an explicit mesh, whose devices
may repeat a card). Seed s starts from its own weights, draws its steps at
key s (where JAX keys seed s by ``PRNGKey(s)``) and reads its own batches
(sampler seed ``1000 * (s + 1) + epoch``); each seed's dev and test
accuracy come back with their means, and each seed's weights go to
``WS/seed_<s>/`` (from rank (s, 0) on a grid).

The device is the card (``--device``, default ``SETTINGS.training.device``)
unless given ``--device cpu``; without a card the run raises. The train step
has no noise bank, as in JAX, so the noise-bank mix kernel (K3) does not
run, and the features come from the plain log-mel chain (``training/step.py``'s
``featurize``), not the frontend kernel (K1). The eval step scores res8
through the stem kernel of ``ops/stem_cuda.py`` (K2) on the card, once an
eval batch; JAX's eval step takes XLA's stem there. Float32 steps and eval
batches run with TF32 off (``ops/tf32.py``).

``--num-devices N`` trains data-parallel on N ranks, one card each, as
``training/run/train.py`` does (``parallel/data_parallel.py``: the ranks
launched by the command or found under ``torchrun``; every rank reads the
sampler's global batch and draws the whole batch's randomness, BatchNorm
takes the global statistics, the gradients are averaged); each eval batch's
rows are split over the ranks and the correct counts summed. Only rank 0
writes the workspace. With ``--sharded-seeds`` the seeds spread over the
cards instead and ``--num-devices`` is not read, as in JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from howl_tpu_torch.data.dataset.gsc_loader import GoogleSpeechCommandsDatasetLoader
from howl_tpu_torch.data.transform.batchifier import ClassificationBatchSampler
from howl_tpu_torch.models import MODEL_REGISTRY, create_model
from howl_tpu_torch.models.base import model_spec
from howl_tpu_torch.ops.augment import AugmentConfig
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.tf32 import exact_float32, is_float32
from howl_tpu_torch.ops.zmuv import ZmuvTransform
from howl_tpu_torch.parallel import data_parallel
from howl_tpu_torch.parallel.mesh import replicate, shard_batch
from howl_tpu_torch.parallel.seed_sweep import create_seed_states, make_seed_sweep_step, shard_seed_batch, sweep_mesh
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.training.run.train import LoopStats, open_workspace
from howl_tpu_torch.training.state import create_train_state, param_count
from howl_tpu_torch.training.step import StepConfig, make_classification_eval_step, make_classification_train_step
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.utils.platform import ensure_platform
from howl_tpu_torch.utils.random_utils import set_random_seed
from howl_tpu_torch.workspace import Workspace


def fit_zmuv(sampler, frontend_cfg: FrontendConfig, max_batches: int = 128, device="cpu") -> ZmuvTransform:
    """Fit global mean/std over frontend features of the sampler's batches,
    computed on ``device`` (ref pretrain_gsc.py:97-106)."""
    from howl_tpu_torch.ops.zmuv import fit_zmuv as _fit

    with exact_float32():
        zmuv = _fit((torch.from_numpy(batch.audio_data).to(device) for batch in sampler), frontend_cfg,
                    max_batches=max_batches)
    Logger.info(f"zmuv: mean={zmuv.mean:.4f} std={zmuv.std:.4f}")
    return zmuv


def load_splits(silence_proportion: float = 0.0):
    """The GSC splits of ``SETTINGS.dataset.dataset_path`` over
    ``SETTINGS.training.vocab``, with ``silence_proportion`` of synthetic
    silence labelled ``__silence__`` (``len(vocab) + 1``) when positive."""
    loader = GoogleSpeechCommandsDatasetLoader(SETTINGS.training.vocab)
    splits = loader.load_splits(Path(SETTINGS.dataset.dataset_path))
    if silence_proportion > 0:
        for ds in splits:
            ds.label_map.setdefault("__silence__", len(SETTINGS.training.vocab) + 1)
            ds.silence_proportion = silence_proportion
    return splits


def make_sampler(ds, shuffle: bool, drop_last: bool, seed: int = 0) -> ClassificationBatchSampler:
    """Batches of ``SETTINGS.training.batch_size`` windows of
    ``max_window_size_seconds``."""
    window_samples = int(SETTINGS.training.max_window_size_seconds * SETTINGS.audio.sample_rate)
    return ClassificationBatchSampler(ds, SETTINGS.training.batch_size, window_samples, shuffle=shuffle,
                                      drop_last=drop_last, seed=seed)


def step_config(model_name: str, zmuv: ZmuvTransform, use_augment: bool) -> StepConfig:
    """The train and eval steps' config: augmentation and VTLP with
    ``use_augment``, the delta channels only for models that read them."""
    return StepConfig(
        frontend=FrontendConfig.from_settings(),
        zmuv_mean=zmuv.mean,
        zmuv_std=zmuv.std,
        augment=AugmentConfig(sample_rate=SETTINGS.audio.sample_rate) if use_augment else None,
        use_vtlp=use_augment,
        use_deltas=model_spec(model_name).uses_deltas,
    )


def optimizer_settings(steps_per_epoch: int) -> dict:
    """``create_train_state``'s optimizer arguments from ``SETTINGS.training``."""
    return dict(learning_rate=SETTINGS.training.learning_rate, weight_decay=SETTINGS.training.weight_decay,
                lr_decay=SETTINGS.training.lr_decay, steps_per_epoch=steps_per_epoch)


def seed_batches(train_ds, n_seeds: int, epoch: int, device, mesh=None, group=None) -> Iterator[tuple]:
    """One epoch of the sweep's batches: (audio (S, B, n), labels (S, B),
    lengths (S, B)) on ``device`` (seed s's on its mesh device with a
    mesh), seed s's from its own shuffled sampler, seeded ``1000 * (s + 1)
    + epoch`` (ref pretrain_gsc.py:89); on a grid rank (its seed's
    ``group``) its rows of seed ``group.seed``'s batches, (1, B / D, ...)."""
    seeds = [group.seed] if group is not None else range(n_seeds)
    samplers = [iter(make_sampler(train_ds, True, True, seed=1000 * (s + 1) + epoch)) for s in seeds]
    for batches in zip(*samplers):
        arrays = (np.stack([getattr(b, k) for b in batches]) for k in ("audio_data", "labels", "lengths"))
        yield shard_seed_batch(tuple(arrays), device, mesh, group)


def evaluate_accuracy(eval_step, states, sampler, prefix: str, device, stats: Optional[LoopStats] = None,
                      exact: bool = True, group=None) -> np.ndarray:
    """Accuracy of each state in ``states`` (on its own device) on the
    sampler's batches, counting each batch's ``valid`` rows only. With a
    data group each rank scores its share of each batch's rows (the batch
    padded to a multiple of the group's size) and the correct counts are
    summed over the group. ``stats`` gains one eval batch a state a batch
    and their wall time."""
    corr = np.zeros(len(states))
    tot = 0
    t0 = time.perf_counter()
    for batch in sampler:
        valid = getattr(batch, "valid", len(batch.labels))
        audio, lengths, labels = batch.audio_data, batch.lengths, np.asarray(batch.labels)
        lo = 0
        if group is not None:
            pad = -len(labels) % group.size
            audio, lengths, labels = (np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                                      for x in (audio, lengths, labels))
            local = len(labels) // group.size
            lo = group.rank * local
            audio, lengths, labels = audio[lo : lo + local], lengths[lo : lo + local], labels[lo : lo + local]
        keep = lo + np.arange(len(labels)) < valid
        for i, state in enumerate(states):
            dev = next(state.model.parameters()).device
            with exact_float32(exact):
                logits = eval_step(state, torch.from_numpy(np.ascontiguousarray(audio)).to(dev),
                                   torch.from_numpy(np.ascontiguousarray(lengths)).to(dev))
            preds = logits.float().cpu().numpy().argmax(-1)
            corr[i] += int(((preds == labels) & keep).sum())
            if stats is not None:
                stats.eval_batches += 1
        tot += valid
    if group is not None:
        corr = data_parallel.all_sum(torch.from_numpy(corr).to(group.device), group).cpu().numpy()
    if stats is not None:
        stats.eval_s += time.perf_counter() - t0
    accs = corr / max(tot, 1)
    if len(states) == 1:
        Logger.info(f"{prefix} accuracy: {accs[0]:.4f} ({int(corr[0])}/{tot})")
    else:
        Logger.info(f"{prefix} per-seed accuracy: {np.round(accs, 4).tolist()}")
    return accs


def run_sharded_seeds(n_seeds: int, model, step_cfg, train_ds, dev_ds, test_ds, workspace, device, stats: LoopStats,
                      exact: bool, mesh=None, group=None) -> dict:
    """Train seeds 0..n_seeds-1 at once through the seed sweep on ``mesh``
    (its ``data`` axis 1), or on a grid rank (its seed's ``group``) seed
    ``group.seed`` on the rank's rows, then each seed's dev and test
    accuracy and its ``seed_<s>/`` checkpoint. On a grid ``stats`` holds
    every seed's losses and this rank's steps and evaluator batches, and
    the result also "ranks": each rank's kernel launches and evaluator
    batches."""
    steps_per_epoch = max(len(train_ds) // SETTINGS.training.batch_size, 1)
    seeds = [group.seed] if group is not None else list(range(n_seeds))
    Logger.info(f"seed sweep on {mesh or group}")
    states = create_seed_states(model, seeds, device=device, mesh=mesh, **optimizer_settings(steps_per_epoch))
    if group is not None:
        replicate(states[0].model, group)
    sweep_step = make_seed_sweep_step(make_classification_train_step(model, step_cfg, group=group))
    eval_step = make_classification_eval_step(model, step_cfg)
    keys = seeds  # seed s draws at key s, where JAX keys seed s by PRNGKey(s)
    step_losses, epoch_losses = [], []

    for epoch_idx in range(SETTINGS.training.num_epochs):
        losses = []
        t0 = time.perf_counter()
        for audio, labels, lengths in seed_batches(train_ds, n_seeds, epoch_idx, device, mesh, group):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            with exact_float32(exact):
                states, metrics = sweep_step(states, audio, labels, lengths, keys)
            losses.append(metrics["loss"].float().cpu().numpy())
            stats.prep_s += t1 - t0
            stats.step_s += time.perf_counter() - t1
            stats.steps += 1
            stats.examples += len(seeds) * SETTINGS.training.batch_size
            step_losses.append(losses[-1].tolist())
            t0 = time.perf_counter()
        mean_loss = np.mean(np.stack(losses), axis=0) if losses else np.full(len(seeds), np.nan)
        epoch_losses.append(mean_loss.tolist())
        Logger.info(f"epoch {epoch_idx}: per-seed loss={np.round(mean_loss, 4).tolist()}")

    samplers = (make_sampler(dev_ds, False, False), make_sampler(test_ds, False, False))
    dev_accs, test_accs = (evaluate_accuracy(eval_step, states, sampler, prefix, device, stats, exact, group)
                           for sampler, prefix in zip(samplers, ("Dev", "Test")))
    for s, state, dev_acc in zip(seeds, states, dev_accs):
        if group is None or group.rank == 0:
            seed_ws = Workspace(workspace.path / f"seed_{s}", delete_existing=False)
            seed_ws.increment_model(state.model.state_dict(), float(dev_acc) / 10)
    ranks = None
    if group is not None:  # every seed's numbers from its rank (s, 0), and each rank's counts
        ranks = data_parallel.gather_objects(
            ((step_losses, epoch_losses, dev_accs, test_accs),
             {**data_parallel.kernel_launches(), "eval_batches": stats.eval_batches}), group.world)
        roots = [numbers for numbers, _ in ranks[:: group.size]]
        step_losses = [sum(per_seed, []) for per_seed in zip(*(r[0] for r in roots))]
        epoch_losses = [sum(per_seed, []) for per_seed in zip(*(r[1] for r in roots))]
        dev_accs, test_accs = np.concatenate([r[2] for r in roots]), np.concatenate([r[3] for r in roots])
    stats.step_losses += step_losses
    stats.epoch_losses += epoch_losses
    out = {
        "dev_acc": float(dev_accs.mean()),
        "test_acc": float(test_accs.mean()),
        "per_seed_dev_acc": dev_accs.tolist(),
        "per_seed_test_acc": test_accs.tolist(),
    }
    if ranks is not None:
        out["ranks"] = [counts for _, counts in ranks]
    return out


def _parser() -> ArgumentParserBuilder:
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--model", type=str, choices=sorted(MODEL_REGISTRY), default="las"),
        opt("--workspace", type=str, default=str(Path("workspaces") / "default")),
        opt("--load-weights", action="store_true"),
        opt("--eval", action="store_true"),
        opt("--num-labels", type=int, default=30),
        opt(
            "--silence-proportion",
            type=float,
            default=0.0,
            help="inject this fraction of synthetic silence samples labeled "
            "'__silence__' (ref HonkSpeechCommandsDataset, dataset.py:297-320)",
        ),
        opt(
            "--num-devices",
            type=int,
            default=0,
            help="data-parallel ranks, one card each (gloo ranks with --device cpu); 0 = the largest divisor of the "
            "batch size no larger than the visible cards",
        ),
        opt("--use-augment", action="store_true", default=True),
        opt("--no-augment", dest="use_augment", action="store_false"),
        opt(
            "--bf16",
            action="store_true",
            help="mixed-precision training: a bf16 model over float32 master weights (all model families)",
        ),
        opt(
            "--sharded-seeds",
            type=int,
            default=0,
            help="train N seeds at once on the card through the seed sweep (replaces the reference's process job farm)",
        ),
        opt(
            "--device",
            type=str,
            default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu'; without a card only 'cpu' runs",
        ),
    )
    return apb


def run(args=None, stats: Optional[LoopStats] = None, mesh=None) -> dict:
    """Train (or with ``--eval`` evaluate) and return the dev and test
    accuracies, as the JAX entry point does; with ``--sharded-seeds`` also
    each seed's. A ``LoopStats`` passed as ``stats`` is filled with where the
    run spent its time and each step's loss. ``mesh`` (default
    ``sweep_mesh`` of the visible cards) lays out ``--sharded-seeds``: a
    ``data`` axis over 1 runs the (seed, data) grid."""
    argv = list(sys.argv[1:] if args is None else args)
    args = _parser().parser.parse_args(argv)
    device = ensure_platform(args.device)
    stats = stats if stats is not None else LoopStats()
    group = data_parallel.current_group()
    sharded = args.sharded_seeds > 1 and not args.eval
    if group is None and not sharded:
        n_data = data_parallel.data_size(args.num_devices, SETTINGS.training.batch_size, device)
        if n_data > 1 or data_parallel.under_torchrun():
            return data_parallel.run_ranks("howl_tpu_torch.training.run.pretrain_gsc", argv, n_data, device,
                                           stats=stats)
    elif group is None:
        mesh = mesh if mesh is not None else sweep_mesh(args.sharded_seeds, device)
        if mesh.shape["data"] > 1 or data_parallel.under_torchrun():
            return data_parallel.run_ranks("howl_tpu_torch.training.run.pretrain_gsc", argv, mesh.size, device,
                                           mesh=mesh, stats=stats)
    else:
        device = group.device
    writer = group.world if group is not None else None  # the workspace's writer: rank 0 of every rank

    workspace = open_workspace(Path(args.workspace), not args.eval, writer)
    set_random_seed(SETTINGS.training.seed)
    train_ds, dev_ds, test_ds = load_splits(args.silence_proportion)
    Logger.info(f"splits: train={len(train_ds)} dev={len(dev_ds)} test={len(test_ds)}")
    Logger.info(f"device: {device}")

    zmuv = workspace.load_zmuv() if workspace.writes else None
    if writer is not None:  # rank 0's reading, before any rank writes: every rank then fits, or not, alike
        zmuv = data_parallel.broadcast_object(zmuv, writer)
    if zmuv is None:
        zmuv = fit_zmuv(make_sampler(train_ds, True, True), FrontendConfig.from_settings(), device=device)
        workspace.save_zmuv(zmuv)
        if writer is not None:  # rank 0's fit on every rank, to the bit
            zmuv = data_parallel.broadcast_object(zmuv, writer)
    step_cfg = step_config(args.model, zmuv, args.use_augment)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    exact = is_float32(compute_dtype)  # TF32 off for float32 steps and eval batches, not for --bf16
    model = create_model(args.model, num_labels=args.num_labels, dtype=compute_dtype)

    if sharded:
        workspace.write_args(args)
        workspace.save_settings(SETTINGS)
        return run_sharded_seeds(args.sharded_seeds, model, step_cfg, train_ds, dev_ds, test_ds, workspace, device,
                                 stats, exact, mesh, group)

    steps_per_epoch = max(len(train_ds) // SETTINGS.training.batch_size, 1)
    state = create_train_state(model, generator=torch.Generator().manual_seed(SETTINGS.training.seed), device=device,
                               **optimizer_settings(steps_per_epoch))
    Logger.info(f"{param_count(state)} parameters")
    if group is not None:
        replicate(state.model)
    train_step = make_classification_train_step(model, step_cfg, group=group)
    eval_step = make_classification_eval_step(model, step_cfg)

    def accuracy(ds, prefix: str) -> float:
        return float(evaluate_accuracy(eval_step, [state], make_sampler(ds, False, False), prefix, device, stats,
                                       exact, group)[0])

    if args.load_weights or args.eval:
        state.model.load_state_dict(workspace.load_model(best=True), strict=True)
    if args.eval:
        return {"dev_acc": accuracy(dev_ds, "Dev"), "test_acc": accuracy(test_ds, "Test")}

    workspace.write_args(args)
    workspace.save_settings(SETTINGS)
    key = SETTINGS.training.seed + 1  # the step folds in its own count (training/step.py: step_generator)

    dev_acc = 0.0
    for epoch_idx in range(SETTINGS.training.num_epochs):
        losses = []
        t0 = time.perf_counter()
        for batch in make_sampler(train_ds, True, True, seed=epoch_idx):
            arrays = (batch.audio_data, batch.labels, batch.lengths)
            if group is not None:  # this rank's rows of the global batch
                audio, labels, lengths = shard_batch(arrays, group)
            else:
                audio, labels, lengths = (torch.from_numpy(x).to(device) for x in arrays)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            with exact_float32(exact):
                state, metrics = train_step(state, audio, labels, lengths, key)
            losses.append(float(metrics["loss"]))
            stats.prep_s += t1 - t0
            stats.step_s += time.perf_counter() - t1
            stats.steps += 1
            stats.examples += len(batch.labels)
            stats.step_losses.append(losses[-1])
            t0 = time.perf_counter()
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        stats.epoch_losses.append(mean_loss)
        workspace.log_scalar("Training/Loss", mean_loss, epoch_idx)
        Logger.info(f"epoch {epoch_idx}: loss={mean_loss:.4f}")
        dev_acc = accuracy(dev_ds, "Dev")
        workspace.log_scalar("Dev/Metric/acc", dev_acc, epoch_idx)
        workspace.increment_model(state.model.state_dict(), dev_acc / 10)
        workspace.save_train_state(state)

    test_acc = accuracy(test_ds, "Test")
    workspace.log_scalar("Test/Metric/acc", test_acc, SETTINGS.training.num_epochs)
    workspace.close()
    Logger.info(f"model: {args.model} dev_acc: {dev_acc:.4f} test_acc: {test_acc:.4f}")
    return {"dev_acc": dev_acc, "test_acc": test_acc}


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
