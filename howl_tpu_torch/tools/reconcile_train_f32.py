"""Both precisions of the res8 train step at the bench's geometry, on the
card (counterpart of ``tools/reconcile_train_f32.py``).

    python -m howl_tpu_torch.tools.reconcile_train_f32 [--device cuda] [--repeats R]

Measures the bf16 step over float32 masters and the float32 step through
``howl_tpu_torch.bench.bench_train_step`` (batch 1024 x 8,000 samples,
chains of 64 steps, CUDA events, the three train steps in turns) and prints
one JSON line: each precision's median examples per second, their [min,
max] over the repeats, and the card's name and power limit. The JAX tool
also prints the TPU rounds' recorded rates; those are not the port's
numbers and are left out.

It runs on the card: with ``--device cuda`` (the default) and no CUDA
device it raises. ``--device cpu`` runs the bench's CPU sizes on the plain
versions.
"""

from __future__ import annotations

import json
import statistics

import torch

from howl_tpu_torch.tools._study import device_parser, pick_device


def main(argv=None) -> dict:
    from howl_tpu_torch import bench

    p = device_parser(__doc__)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = bench.CARD if dev.type == "cuda" else bench.CPU
    runs = bench.bench_train_step(dev, sizes, args.repeats, args.seed)
    record = {}
    for name, key in (("bf16", "train_examples_per_sec"), ("f32", "train_examples_per_sec_f32")):
        rates = [sizes.train_batch / (ms / 1e3) for ms in runs[key]]
        record[f"train_examples_per_sec_{name}"] = statistics.median(rates)
        record[f"spread_{name}"] = [min(rates), max(rates)]
    record["device"] = bench.card_line() if dev.type == "cuda" else None
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
