"""Judge the fused frontend kernel's precision grades against the float64
goldens, on the card (counterpart of ``tools/validate_pallas_precision.py``;
the kernels here are CUDA C++, ``csrc/frontend.cu`` and
``csrc/frontend_tc.cu``).

    python -m howl_tpu_torch.tools.validate_pallas_precision [--device cuda]

The kernel's plain version rounds where the kernel rounds, so holding the
two against each other says nothing about how far a grade drifts from the
truth. This tool runs ``log_mel_spectrogram_cuda`` at each grade ("f32",
"bf16x3", "bf16x2", "bf16": the JAX tool's f32x6, bf16x3, bf16x2 and bf16x1;
no ZMUV), through the kernel that ``frontend_route`` picks
for it, which is the one the serving engine runs, on ``tests/golden/frontend_input.npy`` and
compares with the torchaudio-exact ``frontend_logmel_{40,80}.npy``, printing
the statistics the golden tests gate on: the largest error above the
log-offset floor (gold > -10), the largest error anywhere, the mean, and the
largest error above each of the three-pass grade's tiers (gold > 0, -5, -10).
``within_golden_bounds`` holds a record to its grade's bounds in
``tests/test_golden_frontend.py``: "f32" to the exact grade's (3e-3 above
the floor, 0.02 anywhere), "bf16x3" to the JAX kernel's three-pass tiers
(2e-4, 3e-3, 1.5e-2; 0.15 anywhere). At 40 mels every grade runs on the
tensor-core kernel ("f32" as six bf16 passes, the JAX tool's f32x6); at 80
mels "bf16x3" and "f32" take the FMA kernel.

It runs on the card: with ``--device cuda`` (the default) and no CUDA device
it raises. With ``--device cpu`` the wrapper takes its plain version.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.frontend_cuda import frontend_route, log_mel_spectrogram_cuda
from howl_tpu_torch.tools._study import device_parser, pick_device

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"
FLOOR = -10.0
GRADES = ("f32", "bf16x3", "bf16x2", "bf16")
# tests/test_golden_frontend.py: the exact grade's bounds, and the three-pass grade's tiers (gold above a level)
F32_BOUNDS = {"above_floor_max": 3e-3, "global_max": 0.02}
BF16X3_TIERS = ((0.0, 2e-4), (-5.0, 3e-3), (-10.0, 1.5e-2))
BF16X3_GLOBAL = 0.15


def within_golden_bounds(rec: dict) -> bool:
    """Whether a record meets its grade's golden bounds; the grades the
    golden tests bound no tighter than the JAX kernel's noise ("bf16x2",
    "bf16") always do."""
    if rec["grade"] == "f32":
        return all(rec[key] < bound for key, bound in F32_BOUNDS.items())
    if rec["grade"] == "bf16x3":
        return all(rec["tier_max"][i] < tol for i, (_, tol) in enumerate(BF16X3_TIERS)) and rec["global_max"] < BF16X3_GLOBAL
    return True


def run(dev: torch.device) -> list:
    """One record per (n_mels, grade): {"n_mels", "grade", "route",
    "above_floor_max", "global_max", "mean", "tier_max"}; route is the kernel
    that ran ("tc" or "fma"), or "plain" on the CPU; tier_max the largest
    error above each level of ``BF16X3_TIERS``."""
    audio = torch.from_numpy(np.load(GOLDEN / "frontend_input.npy")).to(dev)
    records = []
    for n_mels in (40, 80):
        gold = np.load(GOLDEN / f"frontend_logmel_{n_mels}.npy")
        cfg = FrontendConfig(n_mels=n_mels)
        for grade in GRADES:
            out = log_mel_spectrogram_cuda(audio, cfg, 0.0, 1.0, precision=grade).cpu().numpy()
            err = np.abs(out - gold)
            route = frontend_route(cfg, grade) if dev.type == "cuda" else "plain"
            rec = {"n_mels": n_mels, "grade": grade, "route": route, "above_floor_max": float(err[gold > FLOOR].max()),
                   "global_max": float(err.max()), "mean": float(err.mean()),
                   "tier_max": [float(err[gold > level].max()) for level, _ in BF16X3_TIERS]}
            print(f"n_mels={n_mels} precision={grade:8s} route={route:5s} above_floor_max={rec['above_floor_max']:.5f} "
                  f"global_max={rec['global_max']:.5f} mean={rec['mean']:.6f} tiers_max="
                  + "/".join(f"{e:.5f}" for e in rec["tier_max"]), flush=True)
            records.append(rec)
    return records


def main(argv=None) -> list:
    return run(pick_device(device_parser(__doc__).parse_args(argv).device))


if __name__ == "__main__":
    main()
