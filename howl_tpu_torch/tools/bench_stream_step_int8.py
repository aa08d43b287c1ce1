"""Measure int8 residual convs inside the streaming-trunk step on the card
(counterpart of ``tools/bench_stream_step_int8.py``).

    python -m howl_tpu_torch.tools.bench_stream_step_int8 [--device cuda|cpu] [--iters 16] [--seed 0]

The trunk engine (``FusedStreamingOnlineEngine``) runs res8's six residual
convs each hop over (B, n_new + 2, F', 45) ring slabs
(``Res8.trunk_stream_step``). This tool asks whether the int8 layer kernel
pays there, before any engine adopts it (none does). Legs, per geometry (B,
n_new): (16,384, 1) and (65,536, 3) on the card, (8, 1) on the CPU:

  1. ``Res8.trunk_stream_step`` in bf16, the incumbent the engine runs:
     conv0 by ``F.conv2d`` on the slab, the six layers by cuDNN on the rings;
  2. the int8 replica: the same rings, ingest, residual adds and BN, with
     each layer's conv, ReLU and dequant by the kernel
     (``ops/int8_trunk.int8_conv_layer_cuda`` with its epilogue cut to
     those) on the layer's slab with SAME padding, rows [1, 1 + n_new)
     kept, the residual and BN then in torch, as the JAX replica does.

Static scales are the JAX tool's fixed 0.05 for every layer: values
saturate, which changes no time. Each leg is timed by the two-point slope of
chains of ``iters`` and 4 x ``iters`` steps, each step taking the last one's
rings and its slab bumped by the last output (x 1e-30), the median of 3
repeats; CUDA events on the card.

It runs on the card: with ``--device cuda`` (the default) and no CUDA device
it raises. ``--device cpu`` runs the plain versions at (8, 1), 2 iterations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.tools._study import REPEATS, device_parser, pick_device, slope_ms

F_OUT = 10
CH = 45
CARD_GEOMETRIES = ((16384, 1), (65536, 3))
CPU_GEOMETRIES = ((8, 1),)
RINGS = ("s0", "s1", "s2", "s3", "s4", "s5", "r2", "r4")
LEGS = ("trunk_stream_step (bf16)", "int8 replica")


def int8_stream_step(model, params, mel_slab: torch.Tensor, rings: dict, n_new: int):
    """The int8 replica of ``Res8.trunk_stream_step`` with delta = n_new:
    (updated rings, the s6 frequency mean in float32)."""
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda

    dt = model.compute_dtype()
    pool_t = model.pooling[0]
    mel = mel_slab[..., 0][:, None].to(dt)  # (B, 1, T, F): time is H
    y = F.relu(F.conv2d(mel, model.conv0.weight.to(dt), padding=1))[:, :, 1 : 1 + n_new * pool_t]
    y = F.avg_pool2d(y, model.pooling, stride=model.pooling).permute(0, 2, 3, 1)
    rings = dict(rings)
    rings["s0"] = model._ingest(rings["s0"], y, n_new)
    s6_mean = None
    for i in range(1, 7):
        slab = rings[f"s{i - 1}"][:, -(n_new + 2) :].contiguous()
        y, _ = int8_conv_layer_cuda(slab, params.w_i8[i - 1], params.act_scale[i - 1], params.w_scale[i - 1])
        y = y[:, 1 : 1 + n_new]
        if i % 2 == 0:
            x = y + rings["s0" if i == 2 else f"r{i - 2}"][:, -(n_new + 2) : -2]
            if i < 6:
                rings[f"r{i}"] = model._ingest(rings[f"r{i}"], x, n_new)
        else:
            x = y
        s = x * params.bn_scale[i - 1].to(dt) + params.bn_shift[i - 1].to(dt)
        if i < 6:
            rings[f"s{i}"] = model._ingest(rings[f"s{i}"], s, n_new)
        else:
            s6_mean = s.float().mean(dim=2)
    return rings, s6_mean


def run(geometries, iters: int, seed: int, dev: torch.device) -> dict:
    """{(B, n_new): {leg name: ms per step}}."""
    from howl_tpu_torch.bench import NUM_LABELS, res8_numpy_variables
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference.config import cast_compute_dtype
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.int8_trunk import quantize_residual_trunk

    dt = torch.bfloat16
    state = res8_variables_to_state_dict(res8_numpy_variables(np.random.default_rng(seed), NUM_LABELS))
    model = create_model("res8", num_labels=NUM_LABELS).to(device=dev, dtype=dt).eval()
    model.load_state_dict(cast_compute_dtype(state, dt))
    params = quantize_residual_trunk(state, [0.05] * 6, dev)
    results = {}
    for b, n_new in geometries:
        rng = np.random.default_rng(seed)
        mel = torch.from_numpy((rng.standard_normal((b, n_new * 3 + 2, 40, 1)) * 0.5).astype(np.float32)).to(dev, dt)
        rings0 = {k: torch.from_numpy((rng.standard_normal((b, n_new + 2, F_OUT, CH)) * 0.5).astype(np.float32))
                  .to(dev, dt) for k in RINGS}
        steps = (lambda m, r: model.trunk_stream_step(m, r, n_new),
                 lambda m, r: int8_stream_step(model, params, m, r, n_new))
        results[b, n_new] = {}
        for name, step in zip(LEGS, steps):

            def make_chain(n, step=step):
                def chain():
                    rings = rings0
                    for _ in range(n):
                        rings, s6 = step(mel, rings)
                        mel.view(-1)[:1] += (s6.reshape(-1)[:1] * 1e-30).to(dt)

                return chain

            with torch.no_grad():
                ms, _ = slope_ms(make_chain, iters, 4 * iters, REPEATS, dev)
            results[b, n_new][name] = ms
            print(f"[B={b} n_new={n_new}] {name:28s}: {ms:8.3f} ms/iter", flush=True)
        del mel, rings0
    return results


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(CARD_GEOMETRIES if on_card else CPU_GEOMETRIES, args.iters if on_card else 2, args.seed, dev)


if __name__ == "__main__":
    main()
