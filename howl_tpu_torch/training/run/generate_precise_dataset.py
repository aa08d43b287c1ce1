"""Export howl datasets to the Mycroft-precise layout (counterpart of
``howl_tpu/training/run/generate_precise_dataset.py``; ref:
training/run/generate_precise_dataset.py:19-134).

    python -m howl_tpu_torch.training.run.generate_precise_dataset -i CORPUS -o OUT [--deep-copy]

Layout produced per split: wake-word/ and not-wake-word/ directories, plus
noisy variants (noisy-dev/wake-word/, noisy-test/not-wake-word/, ...) when a
noise dataset is configured. Host code only: the noisy files are mixed in
numpy from ``default_rng(seed)``, as the JAX tool mixes them (not through
the noise-bank kernel), so every file it writes is byte for byte the JAX
tool's.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from shutil import copyfile

import numpy as np

from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.data.dataset.dataset import DatasetSplit, DatasetType, WakeWordDataset
from howl_tpu_torch.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader, WakeWordDatasetLoader
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils import audio_utils
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.hash_utils import Sha256Splitter
from howl_tpu_torch.utils.logger import Logger


def copy_files(dataset, output_dir: Path, deep_copy: bool = False):
    output_dir.mkdir(parents=True, exist_ok=True)
    for metadata in dataset.metadata_list:
        output_path = output_dir / metadata.path.name
        try:
            if deep_copy:
                copyfile(metadata.path, output_path)
            else:
                # resolve: a relative dataset path would create symlinks
                # interpreted relative to the LINK's directory (all dangling)
                os.symlink(Path(metadata.path).resolve(), output_path)
        except FileExistsError:
            pass


def write_noisy_files(dataset, output_dir: Path, noise_windows: np.ndarray, seed: int = 0, strength: float = 0.2):
    output_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for idx in range(len(dataset)):
        sample = dataset[idx]
        audio = sample.audio_data
        row = rng.integers(0, noise_windows.shape[0])
        noise = np.tile(noise_windows[row], -(-len(audio) // noise_windows.shape[1]))[: len(audio)]
        alpha = rng.random() * strength
        mixed = audio * (1 - alpha) + noise * alpha
        audio_utils.write_wav(output_dir / sample.metadata.path.name, mixed, sample.sample_rate)


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--dataset-paths", "-i", type=str, nargs="+", default=[SETTINGS.dataset.dataset_path]),
        opt("--output-path", "-o", type=str, default="data/precise"),
        opt("--deep-copy", action="store_true"),
    )
    args = apb.parser.parse_args(args)

    use_frame = SETTINGS.training.objective == "frame"
    ctx = InferenceContext(
        vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type, use_blank=not use_frame
    )
    loader = WakeWordDatasetLoader()
    ds_kwargs = dict(sample_rate=SETTINGS.audio.sample_rate, mono=SETTINGS.audio.use_mono, frame_labeler=ctx.labeler)

    splits = {
        DatasetSplit.TRAINING: WakeWordDataset([], DatasetType.TRAINING, dataset_split=DatasetSplit.TRAINING, **ds_kwargs),
        DatasetSplit.DEV: WakeWordDataset([], DatasetType.DEV, dataset_split=DatasetSplit.DEV, **ds_kwargs),
        DatasetSplit.TEST: WakeWordDataset([], DatasetType.TEST, dataset_split=DatasetSplit.TEST, **ds_kwargs),
    }
    for ds_path in args.dataset_paths:
        train_ds, dev_ds, test_ds = loader.load_splits(Path(ds_path), **ds_kwargs)
        splits[DatasetSplit.TRAINING].extend(train_ds)
        splits[DatasetSplit.DEV].extend(dev_ds)
        splits[DatasetSplit.TEST].extend(test_ds)

    noise_banks = None
    if SETTINGS.training.use_noise_dataset and SETTINGS.training.noise_dataset_path:
        from howl_tpu_torch.training.run.train import build_noise_bank

        noise_ds = RecursiveNoiseDatasetLoader().load(
            Path(SETTINGS.training.noise_dataset_path),
            sample_rate=SETTINGS.audio.sample_rate,
            mono=SETTINGS.audio.use_mono,
        )
        # disjoint dev/test noise (ref generate_precise_dataset.py:106-110):
        # sharing one bank would mix eval clips with training-adjacent noise
        _, noise_rest = noise_ds.split(Sha256Splitter(80))
        noise_dev, noise_test = noise_rest.split(Sha256Splitter(50))
        chunk = SETTINGS.audio.sample_rate * 2
        noise_banks = {
            DatasetSplit.DEV: build_noise_bank(noise_dev if len(noise_dev) else noise_ds, chunk),
            DatasetSplit.TEST: build_noise_bank(noise_test if len(noise_test) else noise_ds, chunk),
        }

    output = Path(args.output_path)
    dir_names = {DatasetSplit.TRAINING: "", DatasetSplit.DEV: "dev", DatasetSplit.TEST: "test"}
    for split, dataset in splits.items():
        pos = dataset.filter(lambda x: ctx.searcher.search(x.transcription), clone=True)
        neg = dataset.filter(lambda x: not ctx.searcher.search(x.transcription), clone=True)
        base = output / dir_names[split] if dir_names[split] else output
        copy_files(pos, base / "wake-word", args.deep_copy)
        copy_files(neg, base / "not-wake-word", args.deep_copy)
        Logger.info(f"{split.value}: {len(pos)} wake-word, {len(neg)} not-wake-word")
        # noisy variants exist for dev/test only, under the reference's
        # sibling layout (noisy-dev/wake-word etc., ref :115-130) — precise
        # tooling only recognizes wake-word/ and not-wake-word/ dir names
        bank = noise_banks.get(split) if noise_banks else None
        if bank is not None:
            noisy_base = output / f"noisy-{dir_names[split]}"
            write_noisy_files(pos, noisy_base / "wake-word", bank)
            write_noisy_files(neg, noisy_base / "not-wake-word", bank)


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
