"""ROC curves: false alarms/hour vs false rejection rate across thresholds
(counterpart of ``howl_tpu/training/run/generate_roc.py``; ref:
training/run/generate_roc.py:7-120).

Reads the harness's report CSVs (report_clean.csv / report_noisy.csv) and
plots FAH (from the negative sets) against FRR (from the positive sets) per
threshold, one curve per report, to a PDF, with a JSON sidecar of the
points. The plot needs matplotlib, imported inside ``run``; ``load_metrics``
needs nothing beyond the standard library.
"""

from __future__ import annotations

import csv
import json
import sys
from collections import defaultdict
from pathlib import Path

from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger


def load_metrics(report_csv: Path, split: str = "Test"):
    """Report csv -> sorted [(threshold, fah, frr)]. ``split``: Dev or Test."""
    rows = defaultdict(dict)
    with Path(report_csv).open() as f:
        for rec in csv.DictReader(f):
            rows[(rec["set"], float(rec["threshold"]))][rec["metric"]] = float(rec["mean"])
    noisy = "noisy" in report_csv.name
    pos_name = f"{split} noisy positive" if noisy else f"{split} positive"
    neg_name = f"{split} noisy negative" if noisy else f"{split} negative"
    points = []
    thresholds = sorted({t for (name, t) in rows if name == pos_name})
    for t in thresholds:
        pos = rows.get((pos_name, t))
        neg = rows.get((neg_name, t))
        if not pos or not neg:
            continue
        tp, fn = pos.get("tp", 0.0), pos.get("fn", 0.0)
        frr = fn / max(tp + fn, 1e-9)
        fah = neg.get("fah", 0.0)
        points.append((t, fah, frr))
    return points


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--report-dirs", "-i", type=str, nargs="+", required=True,
            help="harness report dirs (each containing report_clean.csv)"),
        opt("--names", type=str, nargs="*", default=None, help="curve labels"),
        opt("--split", type=str, default="Test", choices=["Dev", "Test"]),
        opt("--output", "-o", type=str, default="roc.pdf"),
        opt("--noisy", action="store_true", help="use the noisy reports"),
    )
    args = apb.parser.parse_args(args)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    names = args.names or [Path(d).parent.name for d in args.report_dirs]
    if len(names) != len(args.report_dirs):
        raise SystemExit(
            f"--names has {len(names)} entries for {len(args.report_dirs)} report dirs"
        )
    curves = {}
    for report_dir, name in zip(args.report_dirs, names):
        csv_path = Path(report_dir) / ("report_noisy.csv" if args.noisy else "report_clean.csv")
        points = load_metrics(csv_path, args.split)
        if not points:
            Logger.warning(f"no points from {csv_path}")
            continue
        points.sort(key=lambda p: p[1])
        fah = [p[1] for p in points]
        frr = [p[2] * 100 for p in points]
        ax.plot(fah, frr, marker="o", markersize=3, label=name)
        curves[name] = points
    ax.set_xlabel("False alarms per hour")
    ax.set_ylabel("False rejection rate (%)")
    ax.set_title(f"{args.split} ROC ({'noisy' if args.noisy else 'clean'})")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.output)
    Logger.info(f"wrote {args.output}")
    # machine-readable sidecar
    Path(args.output).with_suffix(".json").write_text(
        json.dumps({name: points for name, points in curves.items()}, indent=2)
    )
    return curves


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
