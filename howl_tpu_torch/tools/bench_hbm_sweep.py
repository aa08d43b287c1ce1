"""The device-memory bandwidth sweep on a GPU (counterpart of
``tools/bench_hbm_sweep.py``; the kernels here are CUDA C++, not Pallas).

    python -m howl_tpu_torch.tools.bench_hbm_sweep [--mb 256] [--iters 8] [--quick] [--json FILE] [--device cuda]

The question: what do a plain read, a copy and a whole-array copy of a large
array reach on this card, and do the block height and the dtype matter? The
tool times the JAX tool's legs, under its names and in its order, on an
array of ``--mb`` MB (131,072 x 512 float32, or 262,144 x 512 bf16: the same
bytes):

  1. two PyTorch baselines: an elementwise pass that reads and writes the
     array (``acc.mul_``) and a full reduction (``x.sum()``);
  2. stream-264-repro: the stream leg of the frontend cost study at block
     height 256 (``csrc/micro_stream.cu``, second entry): every row staged
     whole, a quarter of it written;
  3. auto read and auto copy in float32 over the block heights bn = 256 ..
     4096, and in bf16 at 1024 and 4096 (``csrc/hbm_auto_read.cu``,
     ``csrc/hbm_auto_copy.cu``). One CTA owns a block of bn rows and walks it
     through a ring in shared memory, so bn sets how many CTAs there are:
     512 at bn = 256 and 32 at bn = 4096, on a card of 132 SMs;
  4. the whole-array copy by bulk asynchronous copies alone
     (``csrc/hbm2hbm.cu``).

The JAX tool's manual read, write and copy legs (k-deep rings of explicit
copies) are not ported yet; the tool says so and times nothing under their
names. Four library legs follow for orientation, one PyTorch call per
kernel's function; nothing but this tool calls them: ``x + s``,
``x[:, :128] + s`` (which reads only the quarter the function needs),
``out.copy_(x)`` and ``x.view(-1, 256, 512)[:, :8, :128] + s`` (the read
leg's corners at block height 256, which reads the corners alone).

GB/s is the bytes a leg's definition touches over its time, with the JAX
tool's accounting: the array once for a read, twice for a copy, 1.25 times
for the stream leg. Time is the two-point slope: chains of N and 4N launches
in a row on one stream are timed with CUDA events and ``(t_4N - t_N) / 3N``
taken, which cancels what a chain costs once; the plain mean of the 4N chain
is printed beside it. Each figure is the median of 3; a kernel leg runs in
turns with its plain version (plain, kernel, kernel, plain, plain, kernel).
The JAX tool carries a scalar through its chain so that XLA cannot hoist the
loop-invariant call; eager launches are never hoisted, so ``s`` is a float
argument here.

The array is drawn with numpy from seed 0 as the JAX tool draws it. The tool
runs on the card: with ``--device cuda`` (the default) and no CUDA device it
raises. ``--device cpu`` runs the JAX tool's CPU size (16 MB, 2 iterations),
where every kernel leg is its plain version and times are host times; each
line names its route.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from howl_tpu_torch.tools._study import REPEATS, device_parser, pick_device, slope_ms, slope_turns
from howl_tpu_torch.tools.hbm_sweep_kernels import (
    COLS,
    CORNER_ROWS,
    OUT_COLS,
    SweepGeometry,
    auto_copy_cuda,
    auto_copy_plain,
    auto_read_cuda,
    auto_read_plain,
    hbm2hbm_cuda,
    hbm2hbm_plain,
    stream_repro_cuda,
    stream_repro_plain,
    sweep_geometry,
)

S_TIMED = 0.0  # the scalar of the timed calls; the kernels take it at run time
SEED = 0  # the JAX tool's
CPU_SIZE = (16, 2)  # MB, iterations: the JAX tool's CPU size
BNS = (256, 512, 1024, 2048, 4096)
QUICK_BNS = (512, 2048)
BF16_BNS = (1024, 4096)
STREAM_BN = 256
TURNS = ("plain", "kernel", "kernel", "plain", "plain", "kernel")
KERNELS = {"auto_read": auto_read_cuda, "auto_copy": auto_copy_cuda, "stream_repro": stream_repro_cuda,
           "hbm2hbm": hbm2hbm_cuda}
NOT_PORTED = ("manual read / manual write / manual copy legs: not ported yet (ROADMAP.md Queue 2, rows 12-14: "
              "make_manual_read, make_manual_write, make_manual_copy); nothing is timed under their names")


@dataclass
class SweepLeg:
    name: str
    gb: float  # GB the leg's definition touches per iteration
    fn: Callable[[int], object]  # iteration i of the leg
    plain: Optional[Callable[[int], object]] = None  # a kernel leg's plain version
    kernel: Optional[str] = None  # a kernel leg's key in KERNELS
    library: bool = False  # one of the library legs that follow the study's


def make_inputs(mb: int, seed: int, dev: torch.device) -> tuple:
    """(geometry, x32, x16): the float32 array drawn as the JAX tool draws
    it, and the same bytes in bf16, which are two copies of it stacked."""
    geom = sweep_geometry(mb)
    rng = np.random.default_rng(seed)
    x32 = torch.from_numpy(rng.standard_normal((geom.rows_f32, COLS)).astype(np.float32)).to(dev)
    return geom, x32, torch.cat([x32, x32]).to(torch.bfloat16)


def study_legs(geom: SweepGeometry, x32: torch.Tensor, x16: torch.Tensor, quick: bool) -> list:
    gb, s = geom.bytes_total / 1e9, S_TIMED
    acc = x32.clone()  # the copy baseline's array: every pass reads and writes it in place
    legs = [
        # the multiplier alternates as the JAX tool's does; it stays within a few ulp of 1 over any chain
        SweepLeg("torch copy f32 (r+w)", 2 * gb, lambda i: acc.mul_(1.0 + 1e-7 * (i % 2))),
        SweepLeg("torch reduce f32 (r)", gb, lambda i: x32.sum()),
        SweepLeg(f"stream-264-repro f32 bn={STREAM_BN} (r+w/4)", 1.25 * gb, lambda i: stream_repro_cuda(x32, STREAM_BN, s),
                 lambda i: stream_repro_plain(x32, s), "stream_repro"),
    ]

    def read(x, tag, bn):
        return SweepLeg(f"auto read  {tag} bn={bn}", gb, lambda i: auto_read_cuda(x, bn, s),
                        lambda i: auto_read_plain(x, bn, s), "auto_read")

    def copy(x, tag, bn):
        return SweepLeg(f"auto copy  {tag} bn={bn}", 2 * gb, lambda i: auto_copy_cuda(x, bn, s),
                        lambda i: auto_copy_plain(x, s), "auto_copy")

    bns = QUICK_BNS if quick else BNS
    legs += [read(x32, "f32", bn) for bn in bns] + [copy(x32, "f32", bn) for bn in bns]
    if not quick:
        for bn in BF16_BNS:
            legs += [read(x16, "bf16", bn), copy(x16, "bf16", bn)]
    legs.append(SweepLeg("hbm->hbm whole-array DMA (r+w)", 2 * gb, lambda i: hbm2hbm_cuda(x32, s),
                         lambda i: hbm2hbm_plain(x32, s), "hbm2hbm"))
    return legs


def auto_read_library(x: torch.Tensor, bn: int, s: float) -> torch.Tensor:
    """The read leg's function in float32 as one PyTorch call between two
    views: the add gathers the corners itself."""
    return (x.view(-1, bn, COLS)[:, :CORNER_ROWS, :OUT_COLS] + s).view(-1, OUT_COLS)


def library_legs(geom: SweepGeometry, x32: torch.Tensor) -> list:
    """One PyTorch call per function, with the bytes that call needs."""
    gb, s, bn = geom.bytes_total / 1e9, S_TIMED, BNS[0]
    out = torch.empty_like(x32)
    corners_gb = 2 * (geom.rows_f32 // bn * CORNER_ROWS * OUT_COLS * 4) / 1e9  # the corners read, the output written
    return [
        SweepLeg("library: torch x + s f32 (r+w)", 2 * gb, lambda i: x32 + s, library=True),
        SweepLeg(f"library: torch x[:, :{OUT_COLS}] + s f32 (r/4+w/4)", 0.5 * gb, lambda i: x32[:, :OUT_COLS] + s, library=True),
        SweepLeg("library: torch out.copy_(x) f32 (r+w)", 2 * gb, lambda i: out.copy_(x32), library=True),
        SweepLeg(f"library: torch x.view(-1, {bn}, {COLS})[:, :{CORNER_ROWS}, :{OUT_COLS}] + s f32 (corners r+w)", corners_gb,
                 lambda i: auto_read_library(x32, bn, s), library=True),
    ]


def time_leg(leg: SweepLeg, iters: int, dev: torch.device, tally: dict) -> dict:
    """One leg's record; ``tally[kernel]`` grows by the launches its kernel chains made."""
    lo, hi = iters, 4 * iters

    def chains(fn, key=None):
        def make(n):
            def chain():
                for i in range(n):
                    fn(i)
                if key:
                    tally[key] += n

            return chain

        return make

    plain_ms = None
    with torch.no_grad():
        if leg.kernel and dev.type == "cuda":
            route = "cuda kernel"
            turns = slope_turns({"plain": chains(leg.plain), "kernel": chains(leg.fn, leg.kernel)}, TURNS, lo, hi, dev)
            (ms, mean_ms), plain_ms = turns["kernel"], turns["plain"][0]
        else:
            route = "torch" if dev.type == "cuda" else ("plain, cpu" if leg.kernel else "torch, cpu")
            ms, mean_ms = slope_ms(chains(leg.fn), lo, hi, REPEATS, dev)
    gbps = leg.gb / (ms / 1e3)
    line = f"{leg.name:44s}: {ms:8.3f} ms/iter  {gbps:7.1f} GB/s  (mean of the {hi}-chain {mean_ms:.3f} ms) [{route}]"
    print(line + (f"; plain {plain_ms:.3f} ms/iter" if plain_ms is not None else ""), flush=True)
    return {"config": leg.name, "ms_per_iter": ms, "gbps": gbps, "mean_ms_per_iter": mean_ms, "route": route,
            "plain_ms_per_iter": plain_ms, "library": leg.library}


def run(mb: int, iters: int, quick: bool, seed: int, dev: torch.device) -> tuple:
    """Time every leg; returns (the records in the order they ran, {kernel:
    the launches its timed chains made}), the second all zeros on the CPU."""
    on_card = dev.type == "cuda"
    geom, x32, x16 = make_inputs(mb, seed, dev)
    print(f"device-memory bandwidth sweep: {mb} MB, float32 ({geom.rows_f32}, {COLS}), bf16 ({geom.rows_bf16}, {COLS}), "
          f"chains of {iters} and {4 * iters} iterations, median of {REPEATS}, "
          f"on {torch.cuda.get_device_name(dev) if on_card else 'the CPU (host times, plain versions)'}", flush=True)
    tally = dict.fromkeys(KERNELS, 0)
    records = [time_leg(leg, iters, dev, tally) for leg in study_legs(geom, x32, x16, quick)]
    print(NOT_PORTED, flush=True)
    best = max(records, key=lambda r: r["gbps"])
    print(f"\nbest: {best['config']}  {best['gbps']:.1f} GB/s", flush=True)
    records += [time_leg(leg, iters, dev, tally) for leg in library_legs(geom, x32)]
    return records, tally


def main(argv=None) -> list:
    p = device_parser(__doc__)
    p.add_argument("--mb", type=int, default=256, help="array size in MB")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--quick", action="store_true", help="coarse subset only")
    p.add_argument("--json", type=str, default=None, help="write results JSON here")
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    if dev.type == "cpu":
        args.mb, args.iters = CPU_SIZE
    records, _ = run(args.mb, args.iters, args.quick, SEED, dev)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.json}")
    return records


if __name__ == "__main__":
    main()
