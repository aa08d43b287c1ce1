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
  4. manual read, write and copy: the same reads, writes and copies moved
     by bulk asynchronous copies alone, started and waited for by the kernel
     through a ring of k slots (``csrc/hbm_manual_read.cu``,
     ``csrc/hbm_manual_write.cu``, ``csrc/hbm_manual_copy.cu``), in float32
     for k = 2, 3, 4 and chunk heights cb = 512, 1024, then seven single
     legs up to k = 8 and in bf16. On the card the read and the write give
     one CTA a chunk of cb rows, so cb sets the CTA count (float32: 256 at
     cb = 512, 64 at 2048), and walk it through k slots of 16 KB in shared
     memory, whatever k; k also sets how many CTAs fit an SM. The read runs
     k - 1 copies ahead of the one it waits for; the write fills a slot anew
     before every copy and refills it only after the copy of k stages before
     has read it. The copy sweeps the chunks' 16 KB stages with a persistent
     grid, stage j to CTA j % CTAs, and runs k chains load -> store -> load
     per CTA, each waiting for its store to land. Each of these legs' lines
     ends with its CTAs, k, the stage size, the bytes a CTA keeps in flight
     and the CTAs that share an SM;
  5. the whole-array copy by bulk asynchronous copies alone, its 32 KB
     stages swept by a persistent grid (``csrc/hbm2hbm.cu``).

Six library legs follow for orientation, one PyTorch call per kernel's
function; nothing but this tool calls them: ``x + s``, ``x[:, :128] + s``
(which reads only the quarter the function needs), ``out.copy_(x)`` (the
whole-array copy's and the manual copy's), ``x.view(-1, 256, 512)[:, :8,
:128] + s`` (the read leg's corners at block height 256, which reads the
corners alone), ``s + x.view(-1, 512, 512)[:, :8, :128].float().sum(0)`` (the
manual read's at cb = 512: a tree sum, so close to the sequential sum but not
bit for bit) and one broadcast ``copy_`` of the chunk values into
``out.view(-1, 512, 512)`` (the manual write's; the values are made before
the timed call).

GB/s is the bytes a leg's definition touches over its time, with the JAX
tool's accounting: the array once for a read, twice for a copy, 1.25 times
for the stream leg. Time is the two-point slope: chains of N and 4N launches
in a row on one stream are timed with CUDA events and ``(t_4N - t_N) / 3N``
taken, which cancels what a chain costs once; the plain mean of the 4N chain
is printed beside it. Each figure is the median of 3; a kernel leg runs in
turns with its plain version (plain, kernel, kernel, plain, plain, kernel).
Every call allocates its outputs itself, the kernel's and the plain
version's alike (the caching allocator hands the same block back, so no
device work is added to either).
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
    chunk_values,
    manual_copy_cuda,
    manual_copy_plain,
    manual_read_cuda,
    manual_read_plain,
    manual_write_cuda,
    manual_write_plain,
    ring_ctas_per_sm,
    ring_geometry,
    ring_on_card,
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
           "manual_read": manual_read_cuda, "manual_write": manual_write_cuda, "manual_copy": manual_copy_cuda,
           "hbm2hbm": hbm2hbm_cuda}
# the manual legs: (k, cb) crossed for read, write and copy, then single legs, as the JAX tool lists them
MANUAL_KS, MANUAL_CBS = (2, 3, 4), (512, 1024)
QUICK_MANUAL_KS, QUICK_MANUAL_CBS = (2, 4), (1024,)
MANUAL_SINGLES = (("read", "f32", 2, 2048), ("read", "f32", 6, 512), ("read", "f32", 8, 512), ("read", "f32", 8, 1024),
                  ("read", "bf16", 3, 1024), ("copy", "bf16", 3, 1024), ("copy", "f32", 8, 512))
MANUAL = {"read": (manual_read_cuda, manual_read_plain, 1), "write": (manual_write_cuda, manual_write_plain, 1),
          "copy": (manual_copy_cuda, manual_copy_plain, 2)}  # mode: (kernel, plain version, passes over the array)
LIBRARY_CB = MANUAL_CBS[0]  # the chunk height of the manual read's and write's library legs


@dataclass
class SweepLeg:
    name: str
    gb: float  # GB the leg's definition touches per iteration
    fn: Callable[[int], object]  # iteration i of the leg
    plain: Optional[Callable[[int], object]] = None  # a kernel leg's plain version
    kernel: Optional[str] = None  # a kernel leg's key in KERNELS
    library: bool = False  # one of the library legs that follow the study's
    ring: Optional[dict] = None  # a manual leg's ring on the card: hbm_sweep_kernels.ring_geometry


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

    def manual(mode, tag, k, cb):
        x, (kernel, plain, passes) = {"f32": x32, "bf16": x16}[tag], MANUAL[mode]
        return SweepLeg(f"manual {mode:5s} {tag} k={k} cb={cb}", passes * gb, lambda i: kernel(x, k, cb, s),
                        lambda i: plain(x, k, cb, s), f"manual_{mode}", ring=ring_geometry(x, k, cb, mode))

    ks, cbs = (QUICK_MANUAL_KS, QUICK_MANUAL_CBS) if quick else (MANUAL_KS, MANUAL_CBS)
    legs += [manual(mode, "f32", k, cb) for mode in MANUAL for k in ks for cb in cbs]
    if not quick:
        legs += [manual(*single) for single in MANUAL_SINGLES]
    legs.append(SweepLeg("hbm->hbm whole-array DMA (r+w)", 2 * gb, lambda i: hbm2hbm_cuda(x32, s),
                         lambda i: hbm2hbm_plain(x32, s), "hbm2hbm"))
    return legs


def auto_read_library(x: torch.Tensor, bn: int, s: float) -> torch.Tensor:
    """The read leg's function in float32 as one PyTorch call between two
    views: the add gathers the corners itself."""
    return (x.view(-1, bn, COLS)[:, :CORNER_ROWS, :OUT_COLS] + s).view(-1, OUT_COLS)


def manual_read_library(x: torch.Tensor, cb: int, s: float) -> torch.Tensor:
    """The manual read's function as one PyTorch call (beside two views and
    the adding of s): ``sum`` adds the corners as a tree, so the result is
    close to the sequential sum, not equal to it bit for bit."""
    return s + x.view(-1, cb, COLS)[:, :CORNER_ROWS, :OUT_COLS].float().sum(0)


def manual_write_library(out: torch.Tensor, values: torch.Tensor, cb: int) -> torch.Tensor:
    """The manual write's function as one PyTorch call: a broadcast ``copy_``
    of the chunk values (``hbm_sweep_kernels.chunk_values``) into ``out``."""
    out.view(-1, cb, COLS).copy_(values[:, None, None])
    return out


def library_legs(geom: SweepGeometry, x32: torch.Tensor) -> list:
    """One PyTorch call per function, with the bytes that call needs."""
    gb, s, bn, cb = geom.bytes_total / 1e9, S_TIMED, BNS[0], LIBRARY_CB
    out = torch.empty_like(x32)
    values = chunk_values(x32, cb, s)
    chunk_corners_gb = (geom.rows_f32 // cb * CORNER_ROWS * OUT_COLS * 4) / 1e9  # the corners read; 4 KB written
    corners_gb = 2 * (geom.rows_f32 // bn * CORNER_ROWS * OUT_COLS * 4) / 1e9  # the corners read, the output written
    return [
        SweepLeg("library: torch x + s f32 (r+w)", 2 * gb, lambda i: x32 + s, library=True),
        SweepLeg(f"library: torch x[:, :{OUT_COLS}] + s f32 (r/4+w/4)", 0.5 * gb, lambda i: x32[:, :OUT_COLS] + s, library=True),
        SweepLeg("library: torch out.copy_(x) f32 (r+w)", 2 * gb, lambda i: out.copy_(x32), library=True),
        SweepLeg(f"library: torch x.view(-1, {bn}, {COLS})[:, :{CORNER_ROWS}, :{OUT_COLS}] + s f32 (corners r+w)", corners_gb,
                 lambda i: auto_read_library(x32, bn, s), library=True),
        SweepLeg(f"library: torch s + x.view(-1, {cb}, {COLS})[:, :{CORNER_ROWS}, :{OUT_COLS}].float().sum(0) f32 (corners r)",
                 chunk_corners_gb, lambda i: manual_read_library(x32, cb, s), library=True),
        SweepLeg(f"library: torch out.view(-1, {cb}, {COLS}).copy_(values) f32 (w)", gb,
                 lambda i: manual_write_library(out, values, cb), library=True),
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
    line += f"; plain {plain_ms:.3f} ms/iter" if plain_ms is not None else ""
    ring = leg.ring
    if ring:
        if route == "cuda kernel":
            per_sm = ring_ctas_per_sm(KERNELS[leg.kernel], ring["k"], ring["bf16"], dev)
            ring = ring_on_card(ring, per_sm, torch.cuda.get_device_properties(dev).multi_processor_count)
        else:
            ring = dict(ring, ctas_per_sm=None)
        ctas = "every CTA that fits the card" if ring["ctas"] is None else f"{ring['ctas']} CTAs"
        where = (f"{ring['stages']} stages of {ring['stage_bytes']} B swept by {ctas}" if ring["schedule"] == "sweep"
                 else f"{ctas}, a chunk each")
        line += (f"; on the card {where}, k={ring['k']} slots of {ring['stage_bytes']} B, "
                 f"{ring['bytes_in_flight_per_cta']} B in flight per CTA"
                 + (f", {ring['ctas_per_sm']} CTAs to an SM" if ring["ctas_per_sm"] else ""))
    print(line, flush=True)
    return {"config": leg.name, "ms_per_iter": ms, "gbps": gbps, "mean_ms_per_iter": mean_ms, "route": route,
            "plain_ms_per_iter": plain_ms, "library": leg.library, "ring": ring}


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
