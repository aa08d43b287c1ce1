"""CLI: generate stitched wakeword samples from an aligned dataset
(ref: training/run/stitch_vocab_samples.py:14-84)."""

from __future__ import annotations

import sys
from pathlib import Path

from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.etl.stitched_generator import StitchedAudioDatasetGenerator
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--aligned-dataset-path", "-i", type=str, required=True),
        opt("--max-num-training-samples", type=int, default=5000),
        opt("--max-num-dev-samples", type=int, default=1000),
        opt("--max-num-test-samples", type=int, default=1000),
        opt(
            "--disable-detect-keyword",
            action="store_true",
            help="skip secondary keyword-detection validation of stitched samples",
        ),
    )
    args = apb.parser.parse_args(args)

    ctx = InferenceContext(vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type)
    validate_fn = None
    if not args.disable_detect_keyword:
        from howl_tpu_torch.utils.keyword_detector import default_keyword_validator

        validate_fn = default_keyword_validator()

    generator = StitchedAudioDatasetGenerator(
        Path(args.aligned_dataset_path),
        vocab=ctx.vocab,
        max_num_training_samples=args.max_num_training_samples,
        max_num_dev_samples=args.max_num_dev_samples,
        max_num_test_samples=args.max_num_test_samples,
        validate_fn=validate_fn,
        labeler=ctx.labeler,
    )
    generator.generate_datasets()


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
