"""Config-driven training CLI (counterpart of
``howl_tpu/training/run/refactored_train.py``; ref:
training/run/refactored_train.py), through the ``Trainer``.

    python -m howl_tpu_torch.training.run.refactored_train --training_config config.json [--eval] [--device cuda|cpu]

Any other flag goes on to ``training.run.train``. The run is on the card
unless given ``--device cpu`` (default ``SETTINGS.training.device``); without
a card it raises before anything is read.
"""

from __future__ import annotations

import sys

from howl_tpu_torch.config import TrainingConfig
from howl_tpu_torch.trainer import Trainer
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.platform import ensure_platform


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--training_config", "--config", type=str, required=True, help="path to TrainingConfig json"),
        opt("--eval", action="store_true"),
        opt("--device", type=str, default=None, help="'cuda' (default: SETTINGS.training.device) or 'cpu'"),
    )
    args, extra = apb.parser.parse_known_args(args)
    device = ensure_platform(args.device)
    cfg = TrainingConfig.parse_file(args.training_config)
    trainer = Trainer(cfg)
    extra = [*extra, "--device", str(device)]
    return trainer.evaluate(extra) if args.eval else trainer.train(extra)


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
