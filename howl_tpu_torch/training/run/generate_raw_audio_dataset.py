"""CLI: mine positive/negative raw datasets from a source corpus
(ref: training/run/generate_raw_audio_dataset.py:13-146).

Example:
    VOCAB='["hey","fire","fox"]' INFERENCE_SEQUENCE=[0,1,2] \\
    python -m howl_tpu_torch.training.run.generate_raw_audio_dataset \\
        -i ~/data/common-voice --dataset-type common-voice \\
        --positive-pct 100 --negative-pct 5 -o datasets/
"""

from __future__ import annotations

import sys
from pathlib import Path

from howl_tpu_torch.data.dataset.constants import AudioDatasetType, SampleType
from howl_tpu_torch.etl.raw_generator import RawAudioDatasetGenerator
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt(
            "--input-audio-dataset-path",
            "-i",
            type=str,
            default=str(Path.home() / "data" / "common-voice"),
            help="location of the input audio dataset",
        ),
        opt(
            "--dataset-type",
            type=str,
            default=AudioDatasetType.COMMON_VOICE.value,
            choices=[e.value for e in AudioDatasetType],
        ),
        opt(
            "--datasets-dir-path",
            "-o",
            type=str,
            default="datasets",
            help="dir under which the generated howl datasets are stored",
        ),
        opt("--positive-pct", type=int, default=100, help="percentage of the corpus for positives"),
        opt("--negative-pct", type=int, default=100, help="percentage of the corpus for negatives"),
        opt("--overwrite", action="store_true"),
        opt(
            "--num-workers",
            type=int,
            default=None,
            help="worker pool size for clip re-encode + stats (default: SETTINGS.resource.cpu_count)",
        ),
    )
    args = apb.parser.parse_args(args)

    vocab = SETTINGS.training.vocab
    generator = RawAudioDatasetGenerator(
        Path(args.input_audio_dataset_path), AudioDatasetType(args.dataset_type)
    )
    datasets_dir = Path(args.datasets_dir_path)
    wakeword = "_".join(vocab)
    for sample_type, pct in ((SampleType.POSITIVE, args.positive_pct), (SampleType.NEGATIVE, args.negative_pct)):
        if pct <= 0:
            continue
        out_dir = datasets_dir / wakeword / sample_type.value
        if out_dir.exists() and not args.overwrite and any(out_dir.iterdir()):
            Logger.warning(f"{out_dir} exists; pass --overwrite to regenerate")
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        generator.generate_datasets(out_dir, sample_type, pct, num_workers=args.num_workers)


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
