"""Wake-word experiment harness: N seeds x threshold sweep -> reports
(counterpart of ``howl_tpu/training/run/eval_wake_word_detection.py``; ref:
training/run/eval_wake_word_detection.py:23-318).

    python -m howl_tpu_torch.training.run.eval_wake_word_detection --workspace BASE -i CORPUS -n 2 [--sharded-seeds] [--device cuda|cpu]

The reference farms one training process per GPU (polling ``ps aux``) and
re-runs a full eval per threshold. Here:

  * seeds train one after another through the entry point
    (``training.run.train``), or with ``--sharded-seeds`` all at once on
    the JAX harness's (seed S, data max(cards // S, 1)) mesh
    (``parallel/seed_sweep.py``): with ``data`` 1 one sweep step trains
    every seed in this process, with one launch of the noise-bank mix
    kernel, K3, a card over its seeds' examples (seed s on card s mod k);
    with ``data`` D > 1 a grid of S * D ranks trains them, rank (s, d) on
    rows d of seed s's batch, K3 once a rank a step, and each seed's
    threshold sweep splits its rows over the seed's D ranks (K1 and K2
    once a rank an evaluator batch). ``run(..., mesh=)`` takes an explicit
    mesh, whose devices may repeat a card. Existing seed workspaces are
    kept;
  * the threshold sweep scores every clip once through the offline engine
    (``hub.load_workspace_streaming_engine``; on the card the frontend
    kernel K1 and, for res8, the stem kernel K2, once an evaluator batch)
    and re-runs only the smoothing and FSM per threshold, clean and, with a
    noise corpus, noisy;
  * per-threshold ``{t}_results.csv`` files keep the reference format; the
    aggregate clean/noisy reports are CSV with mean/std/p90/p95/p99 across
    seeds (xlsx replaced by CSV), byte for byte the JAX harness's.

The device is the card (``--device``, default ``SETTINGS.training.device``)
unless given ``--device cpu``; without a card the run raises before
anything is read. A seed workspace holds ``model-best.pt`` where the JAX
harness's holds ``model-best.flax``.
"""

from __future__ import annotations

import csv
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from howl_tpu_torch.models import MODEL_REGISTRY
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.training.run.train import LoopStats
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.utils.platform import resolve_device


def _percentiles(values: List[float]) -> dict:
    arr = np.asarray(values, float)
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
        "p90": float(np.percentile(arr, 90)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
    }


def sweep_workspace(workspace_path: Path, model_name: str, dataset_paths, thresholds, use_stitched: bool,
                    device="cuda", stats=None, group=None):
    """Evaluate one trained workspace over all eval sets at every threshold.

    Returns ({set_name: {threshold: (tp, tn, fp, fn)}}, {set_name: audio
    hours}), and writes the reference-format {threshold}_results.csv files.
    ``stats``, a ``training.run.train.LoopStats``, gains the evaluator's
    batches, seconds and audio. With a data ``group`` each batch's rows are
    split over its ranks and its rank 0 writes the files."""
    from howl_tpu_torch.data.dataset.dataset import DatasetSplit, DatasetType, WakeWordDataset
    from howl_tpu_torch.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader, WakeWordDatasetLoader
    from howl_tpu_torch.hub import load_workspace_streaming_engine
    from howl_tpu_torch.training.run.train import BatchedEvaluator, build_noise_bank
    from howl_tpu_torch.utils import hash_utils

    engine, ctx = load_workspace_streaming_engine(workspace_path, model_name, device=device)
    evaluator = BatchedEvaluator(engine, group=group)

    loader = WakeWordDatasetLoader()
    ds_kwargs = dict(sample_rate=SETTINGS.audio.sample_rate, mono=SETTINGS.audio.use_mono, frame_labeler=ctx.labeler)
    ww_dev = WakeWordDataset([], DatasetType.DEV, dataset_split=DatasetSplit.DEV, **ds_kwargs)
    ww_test = WakeWordDataset([], DatasetType.TEST, dataset_split=DatasetSplit.TEST, **ds_kwargs)
    for ds_path in dataset_paths:
        _, dev_ds, test_ds = loader.load_splits(Path(ds_path), **ds_kwargs)
        ww_dev.extend(dev_ds)
        ww_test.extend(test_ds)
        if use_stitched:
            _, dev_s, test_s = loader.load_splits(Path(ds_path), prefix="stitched-", **ds_kwargs)
            ww_dev.extend(dev_s)
            ww_test.extend(test_s)

    sets = {
        "Dev positive": (ww_dev.filter(lambda x: ctx.searcher.search(x.transcription), clone=True), True),
        "Dev negative": (ww_dev.filter(lambda x: not ctx.searcher.search(x.transcription), clone=True), False),
        "Test positive": (ww_test.filter(lambda x: ctx.searcher.search(x.transcription), clone=True), True),
        "Test negative": (ww_test.filter(lambda x: not ctx.searcher.search(x.transcription), clone=True), False),
    }

    mix_bank = None
    if SETTINGS.training.use_noise_dataset and SETTINGS.training.noise_dataset_path:
        noise_ds = RecursiveNoiseDatasetLoader().load(
            Path(SETTINGS.training.noise_dataset_path),
            sample_rate=SETTINGS.audio.sample_rate,
            mono=SETTINGS.audio.use_mono,
        )
        _, noise_rest = noise_ds.split(hash_utils.Sha256Splitter(80))
        mix_bank = build_noise_bank(noise_rest if len(noise_rest) else noise_ds, SETTINGS.audio.sample_rate * 2)

    results: Dict[str, Dict[float, tuple]] = {}
    hours: Dict[str, float] = {}
    for name, (dataset, positive) in sets.items():
        sweep, total_ms = evaluator.evaluate_sweep(dataset, positive, thresholds)
        results[name] = {t: (c.tp, c.tn, c.fp, c.fn) for t, c in sweep.items()}
        hours[name] = total_ms / 3.6e6
        if mix_bank is not None:
            sweep_n, total_ms_n = evaluator.evaluate_sweep(dataset, positive, thresholds, mixer_bank=mix_bank)
            split, kind = name.split(" ", 1)
            noisy_name = f"{split} noisy {kind}"
            results[noisy_name] = {t: (c.tp, c.tn, c.fp, c.fn) for t, c in sweep_n.items()}
            hours[noisy_name] = total_ms_n / 3.6e6
    if stats is not None:
        stats.eval_batches += evaluator.batches
        stats.eval_s += evaluator.seconds
        stats.eval_audio_ms += sum(hours.values()) * 3.6e6

    # reference-format per-threshold csvs
    for t in thresholds if group is None or group.rank == 0 else ():
        with (Path(workspace_path) / f"{round(float(t), 2)}_results.csv").open("w") as f:
            for name in results:
                tp, tn, fp, fn = results[name][float(t)]
                f.write(f"{name},{t},{tp},{tn},{fp},{fn}\n")
    return results, hours


def write_reports(report_dir: Path, per_seed: List[dict], hours: dict, thresholds, suffix: str):
    """Aggregate across seeds -> report_{suffix}.csv (+ raw json)."""
    report_dir.mkdir(parents=True, exist_ok=True)
    (report_dir / f"raw_results_{suffix}.json").write_text(json.dumps(per_seed, indent=2))
    set_names = sorted({name for seed in per_seed for name in seed})
    with (report_dir / f"report_{suffix}.csv").open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["set", "threshold", "metric", "mean", "std", "p90", "p95", "p99"])
        for name in set_names:
            if ("noisy" in name) != (suffix == "noisy"):
                continue
            for t in thresholds:
                per_metric = {"tp": [], "tn": [], "fp": [], "fn": [], "tp_rate": [], "fah": []}
                for seed_results in per_seed:
                    if name not in seed_results:
                        continue
                    tp, tn, fp, fn = seed_results[name][float(t)]
                    per_metric["tp"].append(tp)
                    per_metric["tn"].append(tn)
                    per_metric["fp"].append(fp)
                    per_metric["fn"].append(fn)
                    per_metric["tp_rate"].append(tp / max(tp + fn, 1))
                    per_metric["fah"].append(fp / max(hours.get(name, 0.0), 1e-9))
                for metric, values in per_metric.items():
                    if not values:
                        continue
                    stats = _percentiles(values)
                    writer.writerow(
                        [name, t, metric] + [round(stats[k], 4) for k in ("mean", "std", "p90", "p95", "p99")]
                    )


@dataclass
class SeedTraining:
    """What the seeds of one sweep share: the train set, the fitted ZMUV
    stats, the model (each seed trains its own copy), the per-model train
    step, the optimizer's settings and the seeds' batchers. Built by
    :func:`seed_training`."""

    seeds: list
    device: torch.device
    use_frame: bool
    ww_train: object
    zmuv: object
    model: torch.nn.Module
    train_step: Callable
    batch_size: int
    steps_per_epoch: int
    opt_kwargs: dict
    make_batchifier: Callable
    mesh: object = None  # the seeds' devices (``parallel.seed_sweep.sweep_mesh``); None: all on ``device``
    group: object = None  # a grid rank's seed group (``parallel.mesh.seed_group``): its rows of one seed's batch

    def create_states(self, seeds=None) -> list:
        """Fresh train states of ``seeds`` (default: all), seed s's from its
        seed, the i-th on the mesh's device i mod k."""
        from howl_tpu_torch.parallel.seed_sweep import create_seed_states

        return create_seed_states(self.model, self.seeds if seeds is None else seeds, device=self.device,
                                  mesh=self.mesh, **self.opt_kwargs)

    def batches(self):
        """The sweep's batches in step order, without end: (audio (S, B, n),
        labels, *lengths) on the device, seed s's drawn by its own batcher
        (seed 1000 + s) from its own sampler (seed 2000 + s); on a grid
        rank the rank's rows of its seed's batch."""
        from howl_tpu_torch.parallel.seed_sweep import shard_seed_batch

        batchifiers = [self.make_batchifier(seed=1000 + s) for s in self.seeds]
        sample_rngs = [np.random.default_rng(2000 + s) for s in self.seeds]
        n = len(self.ww_train)
        while True:
            batches = [bf([self.ww_train[int(i)] for i in r.integers(0, n, self.batch_size)])
                       for bf, r in zip(batchifiers, sample_rngs)]
            fields = ("audio_data", "labels", "lengths") if self.use_frame else (
                "audio_data", "labels", "audio_lengths", "label_lengths")
            yield shard_seed_batch([np.stack([getattr(b, f) for b in batches]) for f in fields], self.device,
                                   self.mesh, self.group)


def seed_training(args, seeds, device, mesh=None, group=None) -> SeedTraining:
    """The shared setup of :func:`train_seeds_sharded` on ``device`` (the
    seeds spread over ``mesh`` when given; a grid rank's ``group`` trains
    its one seed on its rows, with the grid's rank 0's ZMUV fit): the
    train splits of ``args.dataset_paths``, the noise bank, the ZMUV fit on
    128 clips, the model of ``args.model`` and its frame or CTC step."""
    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.common.tokenizer import WakeWordTokenizer
    from howl_tpu_torch.data.dataset.dataset import DatasetSplit, DatasetType, WakeWordDataset
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.data.transform.batchifier import AudioSequenceBatchifier, WakeWordFrameBatchifier
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.models.base import model_spec
    from howl_tpu_torch.ops.augment import AugmentConfig
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.zmuv import fit_zmuv
    from howl_tpu_torch.training.step import StepConfig, make_classification_train_step, make_ctc_train_step

    use_frame = SETTINGS.training.objective == "frame"
    ctx = InferenceContext(
        vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type, use_blank=not use_frame
    )
    loader = WakeWordDatasetLoader()
    ds_kwargs = dict(sample_rate=SETTINGS.audio.sample_rate, mono=SETTINGS.audio.use_mono, frame_labeler=ctx.labeler)
    ww_train = WakeWordDataset([], DatasetType.TRAINING, dataset_split=DatasetSplit.TRAINING, **ds_kwargs)
    for ds_path in args.dataset_paths:
        train_ds, _, _ = loader.load_splits(Path(ds_path), **ds_kwargs)
        ww_train.extend(train_ds)
        if args.use_stitched_datasets:
            train_s, _, _ = loader.load_splits(Path(ds_path), prefix="stitched-", **ds_kwargs)
            ww_train.extend(train_s)
    if len(ww_train) == 0:
        raise SystemExit(f"no training clips under {args.dataset_paths}")

    sample_rate = SETTINGS.audio.sample_rate
    window_samples_bank = int(SETTINGS.training.max_window_size_seconds * sample_rate)
    noise_bank = None
    if SETTINGS.training.use_noise_dataset and SETTINGS.training.noise_dataset_path:
        # the same noise mixing as the sequential per-seed path: without it the
        # seeds would train clean while the report's noisy eval assumes noise-augmented models
        from howl_tpu_torch.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader
        from howl_tpu_torch.training.run.train import build_noise_bank
        from howl_tpu_torch.utils import hash_utils

        noise_ds = RecursiveNoiseDatasetLoader().load(
            Path(SETTINGS.training.noise_dataset_path), sample_rate=sample_rate, mono=SETTINGS.audio.use_mono
        )
        noise_train, _ = noise_ds.split(hash_utils.Sha256Splitter(80))
        noise_bank = build_noise_bank(noise_train if len(noise_train) else noise_ds, window_samples_bank)
    window_ms = int(SETTINGS.training.max_window_size_seconds * 1000)
    frontend_cfg = FrontendConfig.from_settings()

    if not use_frame:
        # one corpus-wide WAV-header scan, shared by the probe and all seeds
        from howl_tpu_torch.utils.audio_utils import wav_num_samples

        ctc_max_audio = max(
            (wav_num_samples(m.path, sample_rate) for m in ww_train.metadata_list),
            default=int(window_ms / 1000 * sample_rate),
        )
        ctc_tokenizer = WakeWordTokenizer(ctx.vocab, ignore_oov=False)

    def make_batchifier(seed=None):
        if use_frame:
            return WakeWordFrameBatchifier(ctx.negative_label, window_size_ms=window_ms, sample_rate=sample_rate,
                                           seed=seed)
        return AudioSequenceBatchifier(ctx.negative_label, ctc_tokenizer, sample_rate=sample_rate,
                                       max_audio_samples=ctc_max_audio)

    # one ZMUV fit for every seed (a model-independent statistic)
    probe_bf = make_batchifier(seed=0)
    rng = np.random.default_rng(0)
    zmuv = fit_zmuv(
        (torch.from_numpy(probe_bf([ww_train[int(i)]]).audio_data).to(device)
         for i in rng.permutation(len(ww_train))[:128]),
        frontend_cfg,
    )
    if group is not None:
        from howl_tpu_torch.parallel import data_parallel

        zmuv = data_parallel.broadcast_object(zmuv, group.world)
    step_cfg = StepConfig(
        frontend=frontend_cfg,
        zmuv_mean=zmuv.mean,
        zmuv_std=zmuv.std,
        augment=AugmentConfig(sample_rate=sample_rate) if args.use_augment else None,
        use_vtlp=args.use_augment,
        negative_label=ctx.negative_label,
        blank_label=ctx.blank_label,
        use_deltas=model_spec(args.model).uses_deltas,
    )
    model = create_model(args.model, num_labels=ctx.num_labels)
    batch_size = SETTINGS.training.batch_size
    steps_per_epoch = args.steps_per_epoch or max(len(ww_train) // batch_size, 1)
    bank = torch.from_numpy(noise_bank).to(device) if noise_bank is not None else None
    train_step = (make_classification_train_step if use_frame else make_ctc_train_step)(model, step_cfg, bank,
                                                                                        group=group)
    opt_kwargs = dict(learning_rate=SETTINGS.training.learning_rate, weight_decay=SETTINGS.training.weight_decay,
                      lr_decay=SETTINGS.training.lr_decay, steps_per_epoch=steps_per_epoch)
    return SeedTraining(list(seeds), device, use_frame, ww_train, zmuv, model, train_step, batch_size, steps_per_epoch,
                        opt_kwargs, make_batchifier, mesh, group)


def train_seeds_sharded(args, base: Path, seeds, mesh=None, group=None) -> dict:
    """Train all seeds of the wake-word model at once on the card, or across
    the visible cards, seed s on card s mod k (frame OR
    ctc objective, as the reference harness sweeps any objective by env vars,
    ref eval_wake_word_detection.py:187-207): one sweep step a step for every
    seed (``parallel/seed_sweep.py``), seed s at key s, then per-seed
    workspaces that the eval phase reads as it reads sequentially trained
    ones. The device is ``args.device`` (default
    ``SETTINGS.training.device``) and the seeds lie on ``mesh`` (default
    ``sweep_mesh``; its ``data`` axis must be 1 here). A grid rank (its
    seed's ``group``) trains seed ``seeds[group.seed]`` on its rows and
    rank (s, 0) writes its workspace; every rank returns every seed's
    losses. Returns {"step_losses": (steps, S) array, "epoch_losses": per
    epoch the seeds' mean losses, "steps", "step_s": the sweep steps'
    seconds until each loss was on the host, "prep_s": the batches'
    seconds}."""
    from howl_tpu_torch.ops.tf32 import exact_float32
    from howl_tpu_torch.parallel import data_parallel
    from howl_tpu_torch.parallel.seed_sweep import make_seed_sweep_step, sweep_mesh
    from howl_tpu_torch.workspace import Workspace

    device = resolve_device(getattr(args, "device", None) or SETTINGS.training.device)
    seeds = list(seeds)
    if group is not None:
        device, seeds, mesh = group.device, [seeds[group.seed]], None
    elif mesh is None:
        mesh = sweep_mesh(len(seeds), device)
    setup = seed_training(args, seeds, device, mesh, group)
    Logger.info(f"seed sweep: {len(seeds)} seeds on {mesh or group}")
    states = setup.create_states()
    sweep_step = make_seed_sweep_step(setup.train_step)
    batches = setup.batches()
    record = {"step_losses": [], "epoch_losses": [], "steps": 0, "step_s": 0.0, "prep_s": 0.0}
    for epoch_idx in range(SETTINGS.training.num_epochs):
        losses = []
        for _ in range(setup.steps_per_epoch):
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            with exact_float32():
                states, metrics = sweep_step(states, *batch, seeds)
            losses.append(metrics["loss"].cpu().numpy())
            record["prep_s"] += t1 - t0
            record["step_s"] += time.perf_counter() - t1
            record["steps"] += 1
        mean_loss = np.mean(np.stack(losses), axis=0) if losses else np.full(len(seeds), np.nan)
        record["step_losses"] += losses
        record["epoch_losses"].append(mean_loss.tolist())
        Logger.info(f"epoch {epoch_idx}: per-seed loss={np.round(mean_loss, 4).tolist()}")
    record["step_losses"] = np.stack(record["step_losses"]) if record["step_losses"] else np.zeros((0, len(seeds)))

    for idx, s in enumerate(seeds):
        if group is not None and group.rank:
            continue
        ws = Workspace(base / f"seed_{s}")
        ws.save_model(states[idx].model.state_dict(), best=True)
        ws.save_zmuv(setup.zmuv)
        ws.save_settings(SETTINGS)
        ws.write_args(args)
    if group is not None:  # every seed's losses from its rank (s, 0), once its workspace is written
        roots = data_parallel.gather_objects(record, group.world)[:: group.size]
        record["step_losses"] = np.concatenate([r["step_losses"] for r in roots], axis=1)
        record["epoch_losses"] = [sum(epochs, []) for epochs in zip(*(r["epoch_losses"] for r in roots))]
    return record


def _parser() -> ArgumentParserBuilder:
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--model", type=str, choices=sorted(MODEL_REGISTRY), default="res8"),
        opt("--workspace", type=str, required=True, help="base dir; per-seed workspaces go under it"),
        opt("--dataset-paths", "-i", type=str, nargs="+", default=[SETTINGS.dataset.dataset_path]),
        opt("--num-models", "-n", type=int, default=1, help="number of seeds"),
        opt("--threshold-hop", type=float, default=0.05),
        opt("--use-stitched-datasets", action="store_true"),
        opt("--skip-training", action="store_true", help="only evaluate existing workspaces"),
        opt("--steps-per-epoch", type=int, default=0),
        opt("--no-augment", dest="use_augment", action="store_false", default=True),
        opt(
            "--sharded-seeds",
            action="store_true",
            help="train ALL seeds at once on the card, their batches stacked into one sweep step (frame or ctc "
            "objective; replaces sequential per-seed training)",
        ),
        opt(
            "--device",
            type=str,
            default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu'; without a card only 'cpu' runs",
        ),
    )
    return apb


def run(args=None, stats=None, mesh=None) -> dict:
    """Train the missing seeds, sweep every seed's workspace and write the
    reports. Returns {"per_seed", "hours", "thresholds", "train": the
    sweep's record (``train_seeds_sharded``) or None}. ``stats``, a
    ``training.run.train.LoopStats``, gains the sweeps' evaluator batches
    (rank 0's on a grid). ``mesh`` (default ``sweep_mesh`` of the visible
    cards) lays out ``--sharded-seeds``: a ``data`` axis over 1 runs the
    (seed, data) grid, whose record also holds "ranks": each rank's kernel
    launches (``data_parallel.kernel_launches``) and evaluator batches."""
    from howl_tpu_torch.parallel import data_parallel
    from howl_tpu_torch.parallel.seed_sweep import sweep_mesh

    argv = list(sys.argv[1:] if args is None else args)
    args = _parser().parser.parse_args(argv)
    device = resolve_device(args.device)

    base = Path(args.workspace)
    thresholds = [round(t, 2) for t in np.arange(0.0, 1.000001, args.threshold_hop)]
    Logger.heading(f"wake word experiment: {args.num_models} seeds x {len(thresholds)} thresholds")

    from howl_tpu_torch.training.run.train import run as train_run

    seed_workspaces = [base / f"seed_{s}" for s in range(args.num_models)]
    missing = [s for s in range(args.num_models) if not (seed_workspaces[s] / "model-best.pt").exists()]
    group = data_parallel.current_group()
    sharded = args.sharded_seeds and not args.skip_training and missing
    if group is not None:  # a rank of the grid: rank 0's reading, before any rank writes
        missing, device = data_parallel.broadcast_object(missing, group.world), group.device
    elif sharded:
        mesh = mesh if mesh is not None else sweep_mesh(len(missing), device)
        if mesh.shape["data"] > 1 or data_parallel.under_torchrun():
            return data_parallel.run_ranks("howl_tpu_torch.training.run.eval_wake_word_detection", argv, mesh.size,
                                           device, mesh=mesh, stats=stats)

    train_record = None
    if group is not None:
        train_record = train_seeds_sharded(args, base, missing, group=group)
    elif sharded:
        # train ONLY the missing seeds (the sequential branch skips existing
        # workspaces the same way; retraining all would overwrite them)
        train_record = train_seeds_sharded(args, base, missing, mesh=mesh)
    else:
        # sequential seeds, each through the entry point
        for seed in range(args.num_models):
            ws = seed_workspaces[seed]
            if args.skip_training or (ws / "model-best.pt").exists():
                Logger.info(f"seed {seed}: workspace exists, skipping training")
                continue
            train_args = [
                "--model", args.model, "--workspace", str(ws), "--eval-freq", "0", "--seed", str(seed),
                "--device", str(device),
            ] + sum([["-i", p] for p in args.dataset_paths], [])
            if args.steps_per_epoch:
                train_args += ["--steps-per-epoch", str(args.steps_per_epoch)]
            if args.use_stitched_datasets:
                train_args += ["--use-stitched-datasets"]
            if not args.use_augment:
                train_args += ["--no-augment"]
            train_run(train_args)

    # ---- EVAL PHASE: one model pass per set, all thresholds ----
    # on a grid, workspace i is swept by seed group i mod S, its rows split over the group's ranks
    swept = {}
    eval_stats = stats if stats is not None else LoopStats()
    for i, ws in enumerate(seed_workspaces):
        if group is not None and i % group.seeds != group.seed:
            continue
        results, ws_hours = sweep_workspace(ws, args.model, args.dataset_paths, thresholds,
                                            args.use_stitched_datasets, device=device, stats=eval_stats, group=group)
        swept[i] = ({name: {float(t): v for t, v in res.items()} for name, res in results.items()}, ws_hours)
    if group is not None:
        ranks = data_parallel.gather_objects((swept, {**data_parallel.kernel_launches(),
                                                      "eval_batches": eval_stats.eval_batches}), group.world)
        swept = {i: v for rank_swept, _ in ranks for i, v in rank_swept.items()}
        train_record["ranks"] = [counts for _, counts in ranks]
    per_seed = [swept[i][0] for i in range(args.num_models)]
    hours = swept[args.num_models - 1][1] if swept else {}
    if group is not None and group.world.rank:
        return {"per_seed": per_seed, "hours": hours, "thresholds": thresholds, "train": train_record}

    # ---- REPORT PHASE ----
    report_dir = base / "reports"
    write_reports(report_dir, per_seed, hours, thresholds, "clean")
    if any("noisy" in name for seed in per_seed for name in seed):
        write_reports(report_dir, per_seed, hours, thresholds, "noisy")
    (report_dir / "hours.json").write_text(json.dumps(hours, indent=2))
    Logger.info(f"reports written to {report_dir}")
    return {"per_seed": per_seed, "hours": hours, "thresholds": thresholds, "train": train_record}


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
