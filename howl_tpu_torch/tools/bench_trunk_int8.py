"""Measure the int8 residual trunk against the bf16 one on the card
(counterpart of ``tools/bench_trunk_int8.py``).

    python -m howl_tpu_torch.tools.bench_trunk_int8 [--device cuda|cpu] [--batch 512] [--iters 16] [--seed 0]

Legs, on pooled stem activations at the serving geometry, (B, 213, 10, 45)
in bf16 (``--batch`` clips of 8 s), res8 weights and activations from the
seed, the int8 scales calibrated on the activations themselves:

  1. bf16 residual stack (incumbent): ``Res8.residual_features`` in bf16,
     cuDNN's six convs and BatchNorm, the serving engine's stage 3;
  2. int8 full pipeline (kernel): ``ops/int8_trunk.residual_features_int8``,
     six launches of ``csrc/int8_trunk.cu``: the quantize on load, the s8
     conv, ReLU, dequant, the residual adds and BN, the pre-BN sums of
     layers 2 and 4 kept;
  3. int8 conv rate (kernel, epilogue cut): six chained launches with the
     epilogue cut to the conv, ReLU and dequant (no residual, BN or pre-BN
     store), so each layer reads and writes one activation. The JAX tool's
     third leg chains s8 convs with a shift-only requant instead; here each
     layer quantizes the last one's dequantized output as it loads it.

Each leg is timed by the two-point slope of chains of ``iters`` and 4 x
``iters`` calls, each call's input bumped in place by its output (x 1e-30),
the median of 3 repeats (``_study.slope_ms``); CUDA events on the card.

It runs on the card: with ``--device cuda`` (the default) and no CUDA device
it raises. ``--device cpu`` runs the plain versions at batch 4, 2 iterations,
on the host clock.
"""

from __future__ import annotations

import numpy as np
import torch

from howl_tpu_torch.tools._study import REPEATS, bumped_chain, device_parser, pick_device, slope_ms

T_OUT = 213  # pooled trunk frames of an 8 s clip
F_OUT = 10  # pooled mel bins (40 / 4)
CH = 45  # res8's maps
LEGS = ("bf16 residual stack (incumbent, cuDNN)", "int8 full pipeline (kernel)",
        "int8 conv rate (kernel: conv + ReLU + dequant)")


def run(batch: int, iters: int, seed: int, dev: torch.device) -> dict:
    """{leg name: ms per iteration}."""
    from howl_tpu_torch.bench import NUM_LABELS, res8_numpy_variables
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference.config import cast_compute_dtype
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.int8_trunk import (
        calibrate_act_scales,
        int8_conv_layer_cuda,
        quantize_residual_trunk,
        residual_features_int8,
    )

    rng = np.random.default_rng(seed)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, NUM_LABELS))
    x32 = torch.from_numpy(rng.standard_normal((batch, T_OUT, F_OUT, CH)).astype(np.float32)).to(dev)
    x0 = x32.to(torch.bfloat16)
    model = create_model("res8", num_labels=NUM_LABELS).to(device=dev, dtype=torch.bfloat16).eval()
    model.load_state_dict(cast_compute_dtype(state, torch.bfloat16))
    params = quantize_residual_trunk(state, calibrate_act_scales(x32, state), dev)
    del x32

    def conv_rate(x):
        for i in range(len(params.w_i8)):
            x, _ = int8_conv_layer_cuda(x, params.w_i8[i], params.act_scale[i], params.w_scale[i])
        return x

    fns = (model.residual_features, lambda x: residual_features_int8(x, params, torch.bfloat16), conv_rate)
    results = {}
    with torch.no_grad():
        for name, fn in zip(LEGS, fns):
            ms, _ = slope_ms(bumped_chain(fn, x0), iters, 4 * iters, REPEATS, dev)
            results[name] = ms
            print(f"{name:50s}: {ms:8.3f} ms/iter", flush=True)
    return results


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    if dev.type == "cpu":
        args.batch, args.iters = 4, 2  # the JAX tool's size off the accelerator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(args.batch, args.iters, args.seed, dev)


if __name__ == "__main__":
    main()
