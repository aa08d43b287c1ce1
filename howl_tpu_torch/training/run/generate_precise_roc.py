"""Comparison ROC: harness reports vs Mycroft-precise result files
(counterpart of ``howl_tpu/training/run/generate_precise_roc.py``; ref:
training/run/generate_precise_roc.py — xlsx there, CSV/JSON here).

Precise results are expected as a JSON list of
{"threshold": t, "tp": ..., "fn": ..., "fp": ...} per split; our side reads the
harness report CSVs via generate_roc.load_metrics. Known corpus audio-hours
(the FAH denominators the reference hard-codes, generate_precise_roc.py:25-33)
are available as presets.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from howl_tpu_torch.training.run.generate_roc import load_metrics
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger

# negative-set audio seconds per corpus (ref generate_precise_roc.py:25-33)
KNOWN_NEGATIVE_SECONDS = {
    "hey_ff": {"dev": 10679.505062500015, "test": 10364.291000000001},
    "hey_snips": {"dev": 46066.6921250002, "test": 47047.301562499844},
}


def load_precise_metrics(path: Path, negative_hours: float):
    records = json.loads(Path(path).read_text())
    points = []
    for rec in sorted(records, key=lambda r: r["threshold"]):
        tp, fn, fp = rec.get("tp", 0), rec.get("fn", 0), rec.get("fp", 0)
        frr = fn / max(tp + fn, 1e-9)
        fah = fp / max(negative_hours, 1e-9)
        points.append((rec["threshold"], fah, frr))
    return points


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--report-dir", "-i", type=str, required=True, help="howl_tpu harness report dir"),
        opt("--precise-results", type=str, default=None, help="Mycroft-precise results json"),
        opt("--exp-type", type=str, default=None, choices=sorted(KNOWN_NEGATIVE_SECONDS)),
        opt("--split", type=str, default="Test", choices=["Dev", "Test"]),
        opt("--output", "-o", type=str, default="precise_roc.pdf"),
    )
    args = apb.parser.parse_args(args)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    ours = load_metrics(Path(args.report_dir) / "report_clean.csv", args.split)
    if ours:
        ours.sort(key=lambda p: p[1])
        ax.plot([p[1] for p in ours], [p[2] * 100 for p in ours], marker="o", markersize=3, label="howl_tpu")
    if args.precise_results:
        neg_hours = 1.0
        if args.exp_type:
            neg_hours = KNOWN_NEGATIVE_SECONDS[args.exp_type][args.split.lower()] / 3600.0
        else:
            Logger.warning(
                "--precise-results without --exp-type: plotting raw FP counts "
                "on the FAH axis (negative hours unknown, assumed 1.0)"
            )
        precise = load_precise_metrics(Path(args.precise_results), neg_hours)
        precise.sort(key=lambda p: p[1])
        ax.plot(
            [p[1] for p in precise], [p[2] * 100 for p in precise], marker="s", markersize=3, label="precise"
        )
    ax.set_xlabel("False alarms per hour")
    ax.set_ylabel("False rejection rate (%)")
    ax.set_title(f"{args.split} ROC: howl_tpu vs Mycroft-precise")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.output)
    Logger.info(f"wrote {args.output}")


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
