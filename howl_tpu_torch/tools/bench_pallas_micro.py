"""The frontend cost study on a GPU (counterpart of
``tools/bench_pallas_micro.py``; the name is kept so the two are found
together, but the kernels here are CUDA C++, not Pallas).

    python -m howl_tpu_torch.tools.bench_pallas_micro [--batch 512] [--clip-seconds 8] [--iters 16] [--seed 0] [--device cuda]

The question: what of the log-mel frontend's cost is moving the frames, and
what is the DFT product? The tool times the JAX tool's six legs, under its
names, at the serving geometry (batch 512 x 8 s clips, n_fft 512, hop 200):

  1. stream-only: M1 (``csrc/micro_stream.cu``) stages every (total, 512)
     float32 frame row on chip and writes a quarter of it;
  2. gemm1-bf16, gemm3-bf16: M2 (``csrc/micro_gemm.cu``) adds one and three
     bf16 (total, 512) @ (512, 512) products on the tensor cores;
  3. polyphase x1, x3: M3 (``csrc/micro_poly.cu``) reads the hop-row view of
     the audio instead, 0.39 of the bytes, and rebuilds the frames on chip;
  4. framing only: ``frame_signal``, what writing the frames tensor costs.

Three library legs follow for orientation; nothing but this tool calls
them: ``x[:, :128] + s`` in PyTorch (it reads a quarter of the bytes M1
stages), cuBLAS's bf16 product of the pre-cast frames with W, and the
polyphase sum as one cuDNN ``conv1d`` over the hop rows (input pre-cast and
transposed outside the timing, all 512 columns written).

Each leg prints ms per call from CUDA events: the mean over ``--iters``
calls after a warm-up call, 3 repeats; the kernel legs run in turns with
their plain versions (plain, kernel, kernel, plain, plain, kernel). The JAX
tool chains its iterations inside one ``lax.scan`` and carries a scalar
through SMEM, so that XLA cannot hoist the loop-invariant call and the
relay's dispatch cost cancels. Eager CUDA launches need neither: every call
is a launch of its own, and ``s`` is a float argument of the launch.

Operands are drawn from ``--seed`` with numpy, in the JAX tool's order
(audio, then W). The tool runs on the card: with ``--device cuda`` (the
default) and no CUDA device it raises. ``--device cpu`` runs the JAX tool's
CPU size (batch 4, 2 s, 2 iterations), where every kernel leg is its plain
version and times are host times; each line names its route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.ops.frontend import FrontendConfig, frame_signal
from howl_tpu_torch.tools._study import REPEATS, Leg, study_main, time_legs
from howl_tpu_torch.tools.frontend_micro_kernels import (
    OUT_COLS,
    STREAM_FB,
    MicroGeometry,
    gemm_cuda,
    gemm_plain,
    hop_view,
    micro_geometry,
    poly_cuda,
    poly_plain,
    poly_weight_blocks,
    stream_cuda,
    stream_plain,
)

S_TIMED = 0.0  # the scalar of the timed calls; the kernels take it at run time


@dataclass
class MicroInputs:
    """Seeded operands of the six legs, on one device."""

    geom: MicroGeometry
    config: FrontendConfig
    audio: torch.Tensor  # (B, samples) float32
    w: torch.Tensor  # (512, 512) bf16
    frames: torch.Tensor  # (total, 512) float32: the center-padded frames, cut to whole blocks
    h: torch.Tensor  # (B, rows, 200) float32: the hop-row view


def make_inputs(batch: int, clip_seconds: float, seed: int, dev: torch.device) -> MicroInputs:
    config = FrontendConfig(n_mels=40)
    geom = micro_geometry(batch, clip_seconds, config)
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(rng.standard_normal((batch, geom.samples)).astype(np.float32) * np.float32(0.1)).to(dev)
    w = torch.from_numpy(rng.standard_normal((geom.n_fft, geom.n_fft)).astype(np.float32)).to(dev, torch.bfloat16)
    frames = frame_signal(audio, config).reshape(batch * geom.n_frames, geom.n_fft)[: geom.total].contiguous()
    return MicroInputs(geom, config, audio, w, frames, hop_view(audio, geom).contiguous())


def study_legs(inp: MicroInputs) -> list:
    x, w, h, s, t_pad = inp.frames, inp.w, inp.h, S_TIMED, inp.geom.t_pad
    return [
        Leg(f"stream-only FB={STREAM_FB}", lambda: stream_cuda(x, s), lambda: stream_plain(x, s)),
        Leg(f"gemm1-bf16  FB={STREAM_FB}", lambda: gemm_cuda(x, w, s, 1), lambda: gemm_plain(x, w, s, 1)),
        Leg(f"gemm3-bf16  FB={STREAM_FB}", lambda: gemm_cuda(x, w, s, 3), lambda: gemm_plain(x, w, s, 3)),
        Leg("polyphase x1 (1-pass dft)", lambda: poly_cuda(h, w, s, t_pad, 1), lambda: poly_plain(h, w, s, t_pad, 1)),
        Leg("polyphase x3 (3-pass dft)", lambda: poly_cuda(h, w, s, t_pad, 3), lambda: poly_plain(h, w, s, t_pad, 3)),
        Leg("framing only", lambda: frame_signal(inp.audio + s * 1e-30, inp.config), library="torch"),
    ]


def library_legs(inp: MicroInputs) -> list:
    """One library call per question, on operands cast and laid out ahead of
    the timing: bf16 on a card, float32 on the CPU."""
    cdt = torch.bfloat16 if inp.frames.device.type == "cuda" else torch.float32
    x, s = inp.frames, S_TIMED
    xb, wb = x.to(cdt), inp.w.to(cdt)
    h_t = inp.h.to(cdt).transpose(1, 2).contiguous()  # (B, hop, rows): hop samples are the channels
    taps = poly_weight_blocks(inp.w, inp.geom.hop).permute(2, 1, 0).to(cdt).contiguous()  # (512, hop, n_sub)
    return [
        Leg(f"torch x[:, :{OUT_COLS}] + s (a quarter of the bytes)", lambda: x[:, :OUT_COLS] + s, library="torch"),
        Leg("cublas (total, 512) @ (512, 512), frames pre-cast", lambda: xb @ wb, library="cublas"),
        Leg("cudnn conv1d over the hop rows, all 512 columns", lambda: F.conv1d(h_t, taps), library="cudnn"),
    ]


def run(batch: int, clip_seconds: float, iters: int, seed: int, dev: torch.device) -> tuple:
    """Time the six legs and the three library legs; returns
    ({leg name: {"route", "ms", "plain_ms"}}, the inputs)."""
    on_card = dev.type == "cuda"
    inp = make_inputs(batch, clip_seconds, seed, dev)
    g = inp.geom
    print(f"frontend cost study: batch {batch} x {clip_seconds:g} s, {g.total} frame rows, hop rows "
          f"({batch}, {g.rows}, {g.hop}), {iters} iterations, {REPEATS} repeats, "
          f"on {torch.cuda.get_device_name(dev) if on_card else 'the CPU (host times, plain versions)'}", flush=True)
    results = time_legs(study_legs(inp), iters, dev)
    results.update(time_legs(library_legs(inp), iters, dev))
    return results, inp


def main(argv=None) -> dict:
    return study_main(run, __doc__, argv)


if __name__ == "__main__":
    main()
