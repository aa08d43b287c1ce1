"""The readings that a cell's limits are set from, many seeds in one process.

    python -m benchmark.readings --workload <name> --seeds 1,2,3 --seconds 5 [--control]

Runs the cell as ``benchmark.run`` does, once for each seed, and prints for
each a JSON line of the numbers it compares (``checks``) and, with
``--control``, the same numbers read from the control: the plain reference
one precision below the configuration's (fp8 for a bf16 path, int4 for an
int8 trunk) in the program's place, on the same recordings or streams. The
benchmark's own runs never read the control.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from benchmark import run

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    run._environment(run.ROOT)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, lines = run.run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0), t0=t0,
                                     control=args.control)
        notes = json.loads(lines[1])
        print(json.dumps({"seed": seed, "correct": result["correct"], "checks": result["checks"],
                          "control": notes.get("control"), "metrics": result["metrics"],
                          "fired_share": notes.get("fired_share"), "reference_s": notes.get("reference_s"),
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
