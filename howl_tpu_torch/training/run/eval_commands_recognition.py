"""GSC commands-recognition protocol: models x seeds -> accuracy report
(counterpart of ``howl_tpu/training/run/eval_commands_recognition.py``; ref:
training/run/eval_commands_recognition.py:22-148 — 20 epochs, batch 64, 1 s
window, LR 0.01 for res8 / 0.001 otherwise, NUM_MELS 40; mean/std/p90/95/99
across seeds; xlsx replaced by CSV).

    python -m howl_tpu_torch.training.run.eval_commands_recognition --workspace BASE -i GSC [--models res8 ...] [-n SEEDS] [--device cuda|cpu]

Each model's seeds train one after another through ``pretrain_gsc.run``
under ``SETTINGS.scoped`` (the protocol's training settings, the seed, the
model's learning rate, 40 mels, the dataset path), each on the device named
by ``--device`` (default ``SETTINGS.training.device``: the card unless given
``cpu``; without a card the run raises before anything is read).
``BASE/commands_recognition_report.csv`` and ``commands_recognition_raw.json``
are the JAX harness's, byte for byte, from the same test accuracies.
"""

from __future__ import annotations

import csv
import json
import sys
from pathlib import Path

from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.training.run.eval_wake_word_detection import _percentiles
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.utils.platform import ensure_platform

PROTOCOL_TRAINING = {
    "num_epochs": 20,
    "batch_size": 64,
    "max_window_size_seconds": 1.0,
    "eval_window_size_seconds": 1.0,
    # the reference protocol pins these per run (ref eval_commands_
    # recognition.py:70-74); without them ambient env/defaults leak in and
    # the accuracy table is not comparable
    "weight_decay": 0.00001,
    "lr_decay": 0.8,
    "use_noise_dataset": False,
}
MODEL_LR = {"res8": 0.01}
DEFAULT_LR = 0.001


def run(args=None) -> dict:
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--models", type=str, nargs="+", default=["res8", "lstm", "las", "mobilenet"]),
        opt("--workspace", type=str, required=True),
        opt("--dataset-path", "-i", type=str, default=None),
        opt("--num-models", "-n", type=int, default=1, help="seeds per model"),
        opt("--num-labels", type=int, default=12),
        opt("--vocab", type=str, default=None, help="JSON list; default GSC-10 command words"),
        opt("--epochs", type=int, default=None, help="override the protocol's 20 epochs"),
        opt("--batch-size", type=int, default=None, help="override the protocol's batch 64"),
        opt(
            "--device",
            type=str,
            default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu', for every run; without a card only 'cpu' runs",
        ),
    )
    args = apb.parser.parse_args(args)
    ensure_platform(args.device)

    vocab = json.loads(args.vocab) if args.vocab else [
        "yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go",
    ]
    base = Path(args.workspace)

    from howl_tpu_torch.training.run import pretrain_gsc

    results = {}
    for model in args.models:
        accs = []
        for seed in range(args.num_models):
            ws = base / model / f"seed_{seed}"
            training = dict(
                PROTOCOL_TRAINING,
                seed=seed,
                vocab=list(vocab),
                learning_rate=MODEL_LR.get(model, DEFAULT_LR),
            )
            if args.epochs is not None:
                training["num_epochs"] = args.epochs
            if args.batch_size is not None:
                training["batch_size"] = args.batch_size
            scope = {"training": training, "audio_transform": {"num_mels": 40}}
            if args.dataset_path:
                scope["dataset"] = {"dataset_path": args.dataset_path}
            with SETTINGS.scoped(**scope):
                out = pretrain_gsc.run(["--model", model, "--workspace", str(ws), "--num-labels", str(args.num_labels),
                                        "--device", args.device])
            accs.append(out["test_acc"])
        results[model] = {"accuracies": accs, **_percentiles(accs)}
        Logger.info(f"{model}: test acc mean={results[model]['mean']:.4f}")

    base.mkdir(parents=True, exist_ok=True)
    with (base / "commands_recognition_report.csv").open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["model", "mean", "std", "p90", "p95", "p99"])
        for model, stats in results.items():
            writer.writerow(
                [model] + [round(stats[k], 4) for k in ("mean", "std", "p90", "p95", "p99")]
            )
    (base / "commands_recognition_raw.json").write_text(json.dumps(results, indent=2))
    return results


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
