"""Wake-word training / evaluation entry point (counterpart of
``howl_tpu/training/run/train.py``; ref: training/run/train.py:35-328).

    python -m howl_tpu_torch.training.run.train --model res8 --workspace WS -i CORPUS [--device cuda|cpu]

It does what the JAX entry point does for res8 with the frame objective:
aligned-dataset loading, positive/negative splits by the transcript
searcher, the ZMUV fit, the train loop with augmentation and noise-bank
mixing (a bank refreshed from the whole noise corpus between epochs),
``--fused-trunk`` trunk-span training and ``--bf16`` over float32 masters,
dev evaluation every ``--eval-freq`` epochs keeping the best checkpoint, the
final clean and noisy dev and test sweeps with ``errors.tsv``, the
``--eval`` mode's ``<threshold>_results.csv``, and ``--resume`` from the
whole train state. The flags are the JAX entry point's, plus ``--device``.

The device is the card (``--device``, default ``SETTINGS.training.device``,
``"cuda"``); without one the run raises unless given ``--device cpu``. On
the card the train step mixes its noise bank through the kernel of
``ops/augment_cuda.py`` (K3), and every evaluator batch runs
``StreamingEngine.infer_batch``: the frontend and stem kernels of
``ops/frontend_cuda.py`` (K1) and ``ops/stem_cuda.py`` (K2). On the CPU
each takes its plain PyTorch version.

As in the JAX entry point, host code reads and windows a batch of clips per
step and reads the loss back after every step; the rest of a step runs on
the device. ``--bf16`` trains a bf16 res8 over float32 master weights; its
features come from the plain float32 log-mel chain (``training/step.py``'s
``featurize``), whose matrix products run in float32, and the evaluator
scores in bf16 from the exact float32 frontend, as the JAX evaluator does.
Without ``--bf16`` each train step runs with TF32 off whatever the caller's
global ``allow_tf32`` flags (``ops/tf32.py``), as the float32 engine scores.

Refused, each with its ROADMAP item: models other than res8, the CTC
objective and ``convert_static`` (item 8); ``--use-timestretch`` and more
than one device (item 12).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.data.dataset.dataset import DatasetSplit, DatasetType, WakeWordDataset
from howl_tpu_torch.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader, WakeWordDatasetLoader
from howl_tpu_torch.data.noise_bank import NoiseBankPrefetcher, NoiseBankSampler, windows_for_budget
from howl_tpu_torch.data.transform.batchifier import WakeWordFrameBatchifier
from howl_tpu_torch.inference.config import EngineConfig
from howl_tpu_torch.inference.engine import StreamingEngine
from howl_tpu_torch.models import MODEL_REGISTRY, ConfusionMatrix, create_model
from howl_tpu_torch.models.base import model_spec
from howl_tpu_torch.ops.augment import AugmentConfig
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.tf32 import exact_float32, is_float32
from howl_tpu_torch.ops.zmuv import fit_zmuv
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.training.state import create_train_state, param_count
from howl_tpu_torch.training.step import (
    StepConfig,
    make_classification_train_step,
    make_ctc_train_step,
    step_generator,
)
from howl_tpu_torch.utils import hash_utils
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.utils.random_utils import set_random_seed
from howl_tpu_torch.workspace import Workspace


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, {item})")


def resolve_device(name: str) -> torch.device:
    """The device a run asks for: a CUDA device that exists, or the CPU.
    Nothing falls back to the CPU by itself."""
    if str(name).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port trains on 'cuda' or 'cpu'")
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available (pass --device cpu to run on the CPU)")
    return device


def build_noise_bank(
    noise_ds, window_samples: int, max_windows: int = 512, seed: int = 0
) -> Optional[np.ndarray]:
    """Seeded whole-corpus (N, window) noise bank for eval mixing: windows
    drawn uniformly over (clip, offset) by ``NoiseBankSampler``, the same for
    every eval pass of one seed, like the reference's ``seed=0`` eval mixers
    (ref: training/run/train.py:219-220, howl/data/transform/transform.py:199-229)."""
    if not len(noise_ds.metadata_list):
        return None
    return NoiseBankSampler(noise_ds, window_samples, num_windows=max_windows, seed=seed).sample(0)


class EvalMixDraws(NamedTuple):
    """The random choices of one eval mixing batch, each (B,)."""

    apply: torch.Tensor  # bool: the row is mixed
    rows: torch.Tensor  # int64: the bank row mixed in
    uniform: torch.Tensor  # float32 in [0, 1): the mix weight over ``strength``


def draw_eval_mix(batch: int, n_rows: int, seed: int, fold: int, prob: float, device) -> EvalMixDraws:
    """The draws of batch ``fold`` of an eval pass, from a generator seeded
    from (seed, fold) alone."""
    gen = step_generator(seed, fold, device)
    apply = torch.rand(batch, generator=gen, device=gen.device) < prob
    rows = torch.randint(0, n_rows, (batch,), generator=gen, device=gen.device)
    uniform = torch.rand(batch, generator=gen, device=gen.device)
    return EvalMixDraws(apply, rows, uniform)


def apply_eval_mix(audio: torch.Tensor, noise_bank: torch.Tensor, draws: EvalMixDraws, strength: float) -> torch.Tensor:
    """Mix each applied row with its bank row, tiled to the clip's length,
    at weight ``uniform * strength``: ``audio * (1 - a) + noise * a``."""
    n = audio.shape[1]
    reps = -(-n // noise_bank.shape[1])
    tiled = noise_bank[draws.rows].repeat(1, reps)[:, :n]
    alpha = torch.where(draws.apply, draws.uniform * strength, 0.0)[:, None]
    return audio * (1.0 - alpha) + tiled * alpha


def mix_for_eval(audio, noise_bank, seed: int = 0, strength: float = 0.2, prob: float = 0.75, fold: int = 0):
    """Deterministic noisy-eval mixing on the audio's device (ref train.py:219-220
    seeded DatasetMixer), vectorized over the batch; ``fold`` varies the draws
    across the batches of one eval pass."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    noise_bank = torch.as_tensor(noise_bank, dtype=torch.float32).to(audio.device)
    draws = draw_eval_mix(audio.shape[0], noise_bank.shape[0], seed, fold, prob, audio.device)
    return apply_eval_mix(audio, noise_bank, draws, float(strength))


class BatchedEvaluator:
    """Scores whole eval splits through ``StreamingEngine.infer_batch`` with
    length bucketing: one engine call per bucket of at most ``max_batch``
    clips. ``batches`` counts those calls and ``seconds`` their wall time
    (host clock; the decisions are read back, which waits for the device)."""

    def __init__(self, engine: StreamingEngine, bucket_seconds: float = 1.0, max_batch: int = 256):
        self.engine = engine
        self.bucket_samples = int(bucket_seconds * engine.cfg.sample_rate)
        self.max_batch = max_batch
        self.batches = 0
        self.seconds = 0.0
        self.last_total_ms = 0.0

    def _batches(self, dataset, mixer_bank, mixer_seed):
        buckets = {}
        total_ms = 0.0
        batch_counter = 0
        for idx in range(len(dataset)):
            sample = dataset[idx]
            n = max(len(sample.audio_data), 1)
            bucket = -(-n // self.bucket_samples) * self.bucket_samples
            buckets.setdefault(bucket, []).append((idx, sample))
            total_ms += n / self.engine.cfg.sample_rate * 1000.0
        self.last_total_ms = total_ms
        if mixer_bank is not None:
            mixer_bank = torch.as_tensor(mixer_bank, dtype=torch.float32).to(self.engine.device)
        for bucket, items in sorted(buckets.items()):
            for start in range(0, len(items), self.max_batch):
                chunk = items[start : start + self.max_batch]
                audio = np.zeros((len(chunk), bucket), np.float32)
                lengths = np.zeros(len(chunk), np.int64)
                for row, (_, sample) in enumerate(chunk):
                    n = min(len(sample.audio_data), bucket)
                    audio[row, :n] = sample.audio_data[:n]
                    lengths[row] = n
                audio = torch.from_numpy(audio).to(self.engine.device)
                if mixer_bank is not None:
                    audio = mix_for_eval(audio, mixer_bank, seed=mixer_seed, fold=batch_counter)
                batch_counter += 1
                yield chunk, audio, torch.from_numpy(lengths)

    def evaluate(self, dataset, positive_set: bool, mixer_bank: Optional[np.ndarray] = None, mixer_seed: int = 0):
        """Returns (ConfusionMatrix, errors list, total_audio_ms)."""
        conf = ConfusionMatrix()
        errors = []
        t0 = time.perf_counter()
        for chunk, audio, lengths in self._batches(dataset, mixer_bank, mixer_seed):
            result = self.engine.infer_batch(audio, lengths)
            self.batches += 1
            detected = torch.as_tensor(result["detected"]).cpu().numpy()[: len(chunk)]
            conf.increment_array(detected, np.full(len(chunk), positive_set))
            for row, (_, sample) in enumerate(chunk):
                if bool(detected[row]) != positive_set:
                    errors.append(
                        (sample.metadata.transcription, int(detected[row]), int(positive_set), str(sample.metadata.path))
                    )
        self.seconds += time.perf_counter() - t0
        return conf, errors, self.last_total_ms

    def evaluate_sweep(
        self,
        dataset,
        positive_set: bool,
        thresholds,
        mixer_bank: Optional[np.ndarray] = None,
        mixer_seed: int = 0,
    ):
        """Every threshold from one scoring of each batch (the engine's
        ``infer_sweep_batch``). Returns ({threshold: ConfusionMatrix},
        total_audio_ms)."""
        thresholds = [float(t) for t in thresholds]
        results = {t: ConfusionMatrix() for t in thresholds}
        t0 = time.perf_counter()
        for chunk, audio, lengths in self._batches(dataset, mixer_bank, mixer_seed):
            detected = self.engine.infer_sweep_batch(audio, lengths, thresholds)  # (K, B)
            self.batches += 1
            labels = np.full(len(chunk), positive_set)
            for k, t in enumerate(thresholds):
                results[t].increment_array(detected[k, : len(chunk)], labels)
        self.seconds += time.perf_counter() - t0
        return results, self.last_total_ms


@dataclass
class LoopStats:
    """Where a ``run`` spent its time, by host timers that wait for the
    device: ``prep_s`` reads, windows and uploads the train batches,
    ``step_s`` runs the train steps until each loss is on the host;
    ``eval_*`` sum the evaluator's calls; ``epoch_losses`` holds each
    epoch's mean train loss."""

    steps: int = 0
    examples: int = 0
    prep_s: float = 0.0
    step_s: float = 0.0
    eval_batches: int = 0
    eval_audio_ms: float = 0.0
    eval_s: float = 0.0
    epoch_losses: list = field(default_factory=list)


def _parser() -> ArgumentParserBuilder:
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--model", type=str, choices=sorted(MODEL_REGISTRY), default="las"),
        opt("--workspace", type=str, default=str(Path("workspaces") / "default")),
        opt("--load-weights", action="store_true"),
        opt("--load-last", action="store_true"),
        opt("--resume", action="store_true", help="restore the whole train state (optimizer included) and continue"),
        opt("--dataset-paths", "-i", type=str, nargs="+", default=[SETTINGS.dataset.dataset_path]),
        opt("--eval-freq", type=int, default=10),
        opt("--eval", action="store_true"),
        opt("--use-stitched-datasets", action="store_true"),
        opt("--steps-per-epoch", type=int, default=0, help="0 = one pass over the train set"),
        opt("--use-augment", action="store_true", default=True),
        opt("--no-augment", dest="use_augment", action="store_false"),
        opt("--seed", type=int, default=None, help="override SETTINGS.training.seed"),
        opt(
            "--num-devices",
            type=int,
            default=0,
            help="data-parallel size: 0 or 1 (one card); more waits for ROADMAP Queue 1, item 12",
        ),
        opt(
            "--fused-trunk",
            action="store_true",
            help="trunk-mode training for res8: batches become context segments "
            "and logits pool the central window span of clip-contextual trunk "
            "features, matching the engine's fused clip-level scoring",
        ),
        opt("--use-timestretch", action="store_true", help="not ported yet (ROADMAP Queue 1, item 12)"),
        opt(
            "--bf16",
            action="store_true",
            help="mixed-precision training: a bf16 res8 over float32 master weights and "
            "optimizer state (checkpoints stay float32); the evaluator scores in bf16",
        ),
        opt(
            "--noise-bank-mb",
            type=float,
            default=16.0,
            help="device-memory budget for the training noise bank (float32; 16 MB "
            "= 524 half-second windows at 16 kHz)",
        ),
        opt(
            "--noise-refresh-epochs",
            type=int,
            default=1,
            help="re-draw the noise bank from the whole corpus every N epochs "
            "(decoded on a background thread while the card trains; 0 = one bank cut at startup)",
        ),
        opt(
            "--device",
            type=str,
            default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu'; without a card only 'cpu' runs",
        ),
    )
    return apb


def run(args=None, stats: Optional[LoopStats] = None) -> dict:
    """Train (or with ``--eval`` evaluate) and return the final evaluation's
    confusion matrices by split, as the JAX entry point does. A ``LoopStats``
    passed as ``stats`` is filled with where the run spent its time."""
    args = _parser().parser.parse_args(args)
    device = resolve_device(args.device)
    stats = stats if stats is not None else LoopStats()
    if args.seed is not None:
        SETTINGS.training.seed = args.seed
    use_frame = SETTINGS.training.objective == "frame"
    # the refusals come before any data is read
    spec = model_spec(args.model)
    if not spec.supports_trunk:  # the zoo serves offline; its training waits (item 8)
        raise _not_ported(f"training model {args.model!r}", "item 8: the families' training")
    if not use_frame:
        make_ctc_train_step(None, None)  # CTC raises (item 8)
    if SETTINGS.training.convert_static:
        raise _not_ported("convert_static (ConvertedStaticModel)", "item 8: remaining model zoo")
    if args.use_timestretch:
        raise _not_ported("--use-timestretch (ops/timestretch.py)", "item 12")
    if args.num_devices not in (0, 1):
        raise _not_ported(f"--num-devices {args.num_devices} (data parallelism over several cards)", "item 12")

    set_random_seed(SETTINGS.training.seed)
    workspace = Workspace(Path(args.workspace), delete_existing=not (args.eval or args.resume))

    Logger.heading("Loading datasets")
    ctx = InferenceContext(
        vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type, use_blank=not use_frame
    )
    loader = WakeWordDatasetLoader()
    ds_kwargs = dict(sample_rate=SETTINGS.audio.sample_rate, mono=SETTINGS.audio.use_mono, frame_labeler=ctx.labeler)

    ww_train = WakeWordDataset([], DatasetType.TRAINING, dataset_split=DatasetSplit.TRAINING, **ds_kwargs)
    ww_dev = WakeWordDataset([], DatasetType.DEV, dataset_split=DatasetSplit.DEV, **ds_kwargs)
    ww_test = WakeWordDataset([], DatasetType.TEST, dataset_split=DatasetSplit.TEST, **ds_kwargs)
    prefixes = [None, "stitched-"] if args.use_stitched_datasets else [None]
    for prefix in prefixes:
        for ds_path in args.dataset_paths:
            train_ds, dev_ds, test_ds = loader.load_splits(Path(ds_path), prefix=prefix, **ds_kwargs)
            ww_train.extend(train_ds)
            ww_dev.extend(dev_ds)
            ww_test.extend(test_ds)

    for name, ds in (("train", ww_train), ("dev", ww_dev), ("test", ww_test)):
        Logger.info(f"{name}: {len(ds)} clips")
    if len(ww_train) == 0 and not args.eval:
        raise SystemExit(
            f"no training clips found under {args.dataset_paths} — expected "
            "aligned-metadata-{training,dev,test}.jsonl plus an audio/ directory"
        )

    dev_pos = ww_dev.filter(lambda x: ctx.searcher.search(x.transcription), clone=True)
    dev_neg = ww_dev.filter(lambda x: not ctx.searcher.search(x.transcription), clone=True)
    test_pos = ww_test.filter(lambda x: ctx.searcher.search(x.transcription), clone=True)
    test_neg = ww_test.filter(lambda x: not ctx.searcher.search(x.transcription), clone=True)
    Logger.info(
        f"dev+: {len(dev_pos)} dev-: {len(dev_neg)} test+: {len(test_pos)} test-: {len(test_neg)}"
    )

    sample_rate = SETTINGS.audio.sample_rate
    window_ms = int(SETTINGS.training.max_window_size_seconds * 1000)
    window_samples = int(window_ms / 1000 * sample_rate)

    trunk_context_samples = 0
    trunk_span = None
    if args.fused_trunk:
        if not spec.supports_trunk:
            raise SystemExit("--fused-trunk requires the frame objective and a trunk-capable model (res8)")
        # margin >= trunk receptive field: conv0 (1 frame/side) + 6 post-pool
        # 3x3 convs (6 pooled = 18 frames/side) -> 19 frames; round to 20
        hop = SETTINGS.audio_transform.hop_length
        trunk_context_samples = 20 * hop
        pool_t = 3  # res8 time pooling
        span = (window_samples // hop + 1) // pool_t
        lo = round((trunk_context_samples // hop) / pool_t)
        trunk_span = (lo, lo + span)

    batchifier = WakeWordFrameBatchifier(
        ctx.negative_label,
        window_size_ms=window_ms,
        sample_rate=sample_rate,
        context_samples=trunk_context_samples,
    )

    # noise dataset -> the train step's bank on the device + host banks for the eval mixers
    noise_bank = None
    noise_sampler = None
    dev_mix_bank = test_mix_bank = None
    if SETTINGS.training.use_noise_dataset and SETTINGS.training.noise_dataset_path:
        noise_ds = RecursiveNoiseDatasetLoader().load(
            Path(SETTINGS.training.noise_dataset_path), sample_rate=sample_rate, mono=SETTINGS.audio.use_mono
        )
        Logger.info(f"loaded {len(noise_ds.metadata_list)} noise files")
        noise_train, noise_rest = noise_ds.split(hash_utils.Sha256Splitter(80))
        noise_dev, noise_test = noise_rest.split(hash_utils.Sha256Splitter(50))
        # small noise corpora can leave a split empty; fall back to all noise
        for name, split in (("noise_train", noise_train), ("noise_dev", noise_dev), ("noise_test", noise_test)):
            if len(split) == 0:
                Logger.warning(f"{name} split is empty; falling back to the full noise set")
        noise_train = noise_train if len(noise_train) else noise_ds
        noise_dev = noise_dev if len(noise_dev) else noise_ds
        noise_test = noise_test if len(noise_test) else noise_ds
        # the bank is sized by a memory budget and drawn from the whole
        # train-noise corpus, then refreshed between epochs
        noise_sampler = NoiseBankSampler(
            noise_train,
            window_samples,
            num_windows=windows_for_budget(args.noise_bank_mb, window_samples),
            seed=SETTINGS.training.seed,
        )
        noise_bank = noise_sampler.sample(0)
        # eval mixers tile noise across the clip, so chunk size just needs to
        # be <= the shortest noise clip
        probe_lens = [len(noise_ds.load_audio(m)) for m in noise_ds.metadata_list[:8]]
        eval_chunk = min([sample_rate * 2] + [n for n in probe_lens if n])
        dev_mix_bank = build_noise_bank(noise_dev, eval_chunk)
        test_mix_bank = build_noise_bank(noise_test, eval_chunk)

    Logger.heading("ZMUV normalization")
    frontend_cfg = FrontendConfig.from_settings()
    zmuv = workspace.load_zmuv()
    if zmuv is None:
        rng = np.random.default_rng(0)
        idxs = rng.permutation(len(ww_train))[:256]
        zmuv = fit_zmuv(
            (torch.from_numpy(batchifier([ww_train[int(i)]]).audio_data).to(device) for i in idxs), frontend_cfg
        )
        workspace.save_zmuv(zmuv)
    Logger.info(f"zmuv: mean={zmuv.mean:.4f} std={zmuv.std:.4f}")

    Logger.heading("Model preparation")
    batch_size = SETTINGS.training.batch_size
    if args.num_devices and batch_size % args.num_devices:
        raise SystemExit(f"--num-devices {args.num_devices} must divide the batch size {batch_size}")
    Logger.info(f"device: {device}")

    step_cfg = StepConfig(
        frontend=frontend_cfg,
        zmuv_mean=zmuv.mean,
        zmuv_std=zmuv.std,
        augment=AugmentConfig(sample_rate=sample_rate) if args.use_augment else None,
        use_vtlp=args.use_augment,
        # ref train.py:215 constructs DatasetMixer with do_replace=False, so
        # replace-mode (clear-label) mixing is OFF during training by default
        replace_prob=0.0,
        negative_label=ctx.negative_label,
        trunk_span=trunk_span,
        use_deltas=spec.uses_deltas,
    )
    compute_dtype = torch.bfloat16 if args.bf16 else None
    model = create_model(args.model, num_labels=ctx.num_labels, dtype=compute_dtype)
    steps_per_epoch = args.steps_per_epoch or max(len(ww_train) // batch_size, 1)
    state = create_train_state(
        model,
        learning_rate=SETTINGS.training.learning_rate,
        weight_decay=SETTINGS.training.weight_decay,
        lr_decay=SETTINGS.training.lr_decay,
        steps_per_epoch=steps_per_epoch,
        generator=torch.Generator().manual_seed(SETTINGS.training.seed),
        device=device,
    )
    Logger.info(f"{param_count(state)} parameters")

    if args.resume and workspace.has_train_state():
        # exact resume: params + optimizer state + step counter (the reference
        # never checkpointed optimizer state)
        state = workspace.load_train_state(state)
        Logger.info(f"resumed full train state at step {state.step}")
    elif args.resume:
        Logger.warning(f"--resume given but {workspace.train_state_path} not found; training fresh")
    elif args.load_weights or args.eval:
        state.model.load_state_dict(workspace.load_model(best=not args.load_last), strict=True)

    def make_engine() -> StreamingEngine:
        # the engine scores its own copy of the weights: a bf16 engine never
        # touches the float32 masters
        return StreamingEngine(
            model, state.model.state_dict(), EngineConfig.from_settings(ctx), frontend_cfg, zmuv.mean, zmuv.std,
            spec=spec, compute_dtype=compute_dtype, frontend_precision="f32", device=device,
        )

    def evaluate_engine(dataset, prefix: str, positive_set: bool, save: bool = False, mixer_bank=None, epoch_idx: int = 0):
        engine = make_engine()
        evaluator = BatchedEvaluator(engine)
        conf, errors, total_ms = evaluator.evaluate(dataset, positive_set, mixer_bank)
        stats.eval_batches += evaluator.batches
        stats.eval_s += evaluator.seconds
        stats.eval_audio_ms += total_ms
        Logger.info(f"{prefix}: {conf} mcc={conf.mcc:.4f}")
        with (workspace.path / "errors.tsv").open("a") as error_file:
            print(prefix, file=error_file)
            for row in errors:
                error_file.write("\t".join(map(str, row)) + "\n")
        if save and not args.eval and positive_set:
            workspace.log_scalar(f"{prefix}/Metric/tp_rate", conf.tp / max(len(dataset), 1), epoch_idx)
            workspace.increment_model(state.model.state_dict(), conf.tp)
        if args.eval:
            threshold = engine.cfg.inference_threshold
            with (workspace.path / f"{round(threshold, 2)}_results.csv").open("a") as f:
                f.write(f"{prefix},{threshold},{conf.tp},{conf.tn},{conf.fp},{conf.fn}\n")
        return conf

    def do_evaluate() -> dict:
        results = {}
        results["dev_pos"] = evaluate_engine(dev_pos, "Dev positive", True)
        results["dev_neg"] = evaluate_engine(dev_neg, "Dev negative", False)
        if dev_mix_bank is not None:
            results["dev_noisy_pos"] = evaluate_engine(dev_pos, "Dev noisy positive", True, mixer_bank=dev_mix_bank)
            results["dev_noisy_neg"] = evaluate_engine(dev_neg, "Dev noisy negative", False, mixer_bank=dev_mix_bank)
        results["test_pos"] = evaluate_engine(test_pos, "Test positive", True)
        results["test_neg"] = evaluate_engine(test_neg, "Test negative", False)
        if test_mix_bank is not None:
            results["test_noisy_pos"] = evaluate_engine(test_pos, "Test noisy positive", True, mixer_bank=test_mix_bank)
            results["test_noisy_neg"] = evaluate_engine(test_neg, "Test noisy negative", False, mixer_bank=test_mix_bank)
        return results

    if args.eval:
        Logger.heading("Model evaluation")
        return {k: vars(v) | {"mcc": v.mcc} for k, v in do_evaluate().items()}

    Logger.heading("Model training")
    workspace.write_args(args)
    workspace.save_settings(SETTINGS)

    train_step = make_classification_train_step(
        model, step_cfg, torch.from_numpy(noise_bank).to(device) if noise_bank is not None else None
    )

    # between-epoch bank refresh: decode the next draw on a background thread
    # while this epoch trains; the upload and set_bank happen here, between epochs
    bank_prefetcher = None
    if noise_sampler is not None and args.noise_refresh_epochs > 0 and args.use_augment:
        bank_prefetcher = NoiseBankPrefetcher(noise_sampler)
        bank_prefetcher.start(1)

    key = SETTINGS.training.seed + 1  # the step folds in its own count (training/step.py: step_generator)
    rng = np.random.default_rng(SETTINGS.training.seed)
    for epoch_idx in range(SETTINGS.training.num_epochs):
        order = rng.permutation(len(ww_train))
        losses = []
        with torch.profiler.record_function("train_epoch"):
            for start in range(0, steps_per_epoch * batch_size, batch_size):
                t0 = time.perf_counter()
                idxs = [int(order[(start + j) % len(order)]) for j in range(batch_size)]
                batch = batchifier([ww_train[i] for i in idxs])
                audio = torch.from_numpy(batch.audio_data).to(device)
                labels = torch.from_numpy(batch.labels).to(device)
                lengths = torch.from_numpy(batch.lengths).to(device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                with exact_float32(is_float32(compute_dtype)):  # TF32 off for the float32 step, not for --bf16
                    state, metrics = train_step(state, audio, labels, lengths, key)
                losses.append(float(metrics["loss"]))
                stats.prep_s += t1 - t0
                stats.step_s += time.perf_counter() - t1
                stats.steps += 1
                stats.examples += batch_size
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        workspace.log_scalar("Training/Loss", mean_loss, epoch_idx)
        workspace.log_scalar("Training/LearningRate", float(state.learning_rate), epoch_idx)
        Logger.info(f"epoch {epoch_idx}: loss={mean_loss:.4f}")
        stats.epoch_losses.append(mean_loss)
        if (
            bank_prefetcher is not None
            and (epoch_idx + 1) % args.noise_refresh_epochs == 0
            and epoch_idx + 1 < SETTINGS.training.num_epochs
        ):
            refresh_idx = (epoch_idx + 1) // args.noise_refresh_epochs
            train_step.set_bank(torch.from_numpy(bank_prefetcher.get()).to(device))
            bank_prefetcher.start(refresh_idx + 1)
        if args.eval_freq > 0 and epoch_idx % args.eval_freq == 0 and epoch_idx != 0:
            evaluate_engine(dev_pos, "Dev positive", True, save=True, epoch_idx=epoch_idx)

    # make sure a checkpoint exists even when eval_freq never triggered
    workspace.increment_model(
        state.model.state_dict(), workspace.best_quality if workspace.best_quality > float("-inf") else 0.0
    )
    workspace.save_train_state(state)

    Logger.heading("Model evaluation")
    results = {k: vars(v) | {"mcc": v.mcc} for k, v in do_evaluate().items()}
    workspace.close()
    return results


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
