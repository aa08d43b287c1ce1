"""CLI: attach MFA or stub alignments to a raw dataset
(ref: training/run/attach_alignment.py:8-60)."""

from __future__ import annotations

import sys
from pathlib import Path

from howl_tpu_torch.data.common.tokenizer import TokenType
from howl_tpu_torch.etl.aligned_generator import AlignedAudioDatasetGenerator, AlignmentType
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--input-raw-audio-dataset-path", "-i", type=str, required=True),
        opt("--token-type", type=str, default="word", choices=[e.value for e in TokenType]),
        opt("--alignment-type", type=str, required=True, choices=[e.value for e in AlignmentType]),
        opt("--alignments-path", type=str, default=None, help="location of the MFA TextGrid files"),
        opt(
            "--num-workers",
            type=int,
            default=None,
            help="worker pool size for TextGrid ingestion (default: SETTINGS.resource.cpu_count)",
        ),
    )
    args = apb.parser.parse_args(args)

    generator = AlignedAudioDatasetGenerator(
        Path(args.input_raw_audio_dataset_path),
        AlignmentType(args.alignment_type),
        alignments_path=Path(args.alignments_path) if args.alignments_path else None,
        token_type=TokenType(args.token_type),
        num_workers=args.num_workers,
    )
    generator.generate_datasets()


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
