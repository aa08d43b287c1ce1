"""What the measuring tools of this package share: their arguments, the rule
for the device they run on, the timing of a list of legs, and the frontend
kernel's legs at one route and frame tile."""

from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

REPEATS = 3
CPU_SIZE = (4, 2.0, 2)  # batch, clip seconds, iterations: the JAX tools' CPU size


@dataclass
class Leg:
    name: str
    fn: Callable[[], torch.Tensor]
    plain: Optional[Callable[[], torch.Tensor]] = None  # the kernel legs' plain versions
    library: str = "cudnn"  # what runs a leg without a kernel on the card


def time_ms(fn: Callable[[], torch.Tensor], iters: int, dev: torch.device) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1000 / iters
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def chain_ms(chain: Callable[[], None], dev: torch.device, clock: Callable[[], float] = time.perf_counter) -> float:
    """Milliseconds one call of ``chain`` takes: CUDA events on a card,
    ``clock`` (seconds; the host clock) on the CPU."""
    if dev.type != "cuda":
        t0 = clock()
        chain()
        return (clock() - t0) * 1000
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bumped_chain(fn, x: torch.Tensor):
    """``make_chain(n)`` for :func:`slope_ms`: n calls of ``fn(x)``, each
    output's first element times 1e-30 added in place to x's first element,
    so each call depends on the last."""
    flat = x.view(-1)

    def make_chain(n):
        def chain():
            for _ in range(n):
                out = fn(x)
                flat[:1] += (out.reshape(-1)[:1].float() * 1e-30).to(x.dtype)

        return chain

    return make_chain


def slope_turns(makers: dict, order, lo: int, hi: int, dev: torch.device, clock=time.perf_counter) -> dict:
    """Two-point slopes of several chains timed in turns. ``makers[who](n)``
    returns a chain, a callable that runs n iterations; on a card those are n
    launches in a row on one stream. Every chain is warmed with one call of
    its short form; then, for each ``who`` in ``order``, the chains of ``lo``
    and ``hi`` iterations are timed and ``(t_hi - t_lo) / (hi - lo)`` taken,
    which cancels whatever a call costs once. Returns {who: (the median of
    its slopes, the median of its long chain's plain mean ``t_hi / hi``)},
    in ms per iteration."""
    chains = {who: (make(lo), make(hi)) for who, make in makers.items()}
    for chain_lo, _ in chains.values():
        chain_lo()
    slopes, means = {who: [] for who in makers}, {who: [] for who in makers}
    for who in order:
        t_lo, t_hi = (chain_ms(chain, dev, clock) for chain in chains[who])
        slopes[who].append((t_hi - t_lo) / (hi - lo))
        means[who].append(t_hi / hi)
    return {who: (statistics.median(slopes[who]), statistics.median(means[who])) for who in makers}


def slope_ms(make_chain, lo: int, hi: int, repeats: int, dev: torch.device, clock=time.perf_counter) -> tuple:
    """(ms per iteration by the two-point slope, the long chain's plain
    mean): the medians of ``repeats`` measurements, see :func:`slope_turns`."""
    return slope_turns({"leg": make_chain}, ("leg",) * repeats, lo, hi, dev, clock)["leg"]


def _fmt(times) -> str:
    return ", ".join(f"{t:.3f}" for t in times)


def time_legs(legs: list, iters: int, dev: torch.device) -> dict:
    """Time each leg: {leg name: {"route", "ms", "plain_ms"}}, one mean per
    repeat in ``ms`` and ``plain_ms``. On a card a kernel leg runs in turns
    with its plain version; on the CPU it is its plain version."""
    on_card = dev.type == "cuda"
    results = {}
    with torch.no_grad():
        for leg in legs:
            if leg.plain is None or not on_card:
                route = ("plain, cpu" if leg.plain else "torch, cpu") if not on_card else leg.library
                ms = [time_ms(leg.fn, iters, dev) for _ in range(REPEATS)]
                plain_ms = None
                print(f"{leg.name:50s}: {_fmt(ms)} ms/iter [{route}]", flush=True)
            else:
                route = "cuda kernel"
                turns = {"plain": [], "kernel": []}
                for who in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
                    turns[who].append(time_ms(leg.plain if who == "plain" else leg.fn, iters, dev))
                ms, plain_ms = turns["kernel"], turns["plain"]
                print(f"{leg.name:50s}: {_fmt(ms)} ms/iter [{route}]; plain {_fmt(plain_ms)} ms/iter", flush=True)
            results[leg.name] = {"route": route, "ms": ms, "plain_ms": plain_ms}
    return results


def device_parser(doc: str) -> argparse.ArgumentParser:
    """The ``--device`` argument every tool takes; ``doc`` is the tool's docstring."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def study_parser(doc: str) -> argparse.ArgumentParser:
    """The arguments of the two kernel studies."""
    p = device_parser(doc)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--clip-seconds", type=float, default=8.0)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    return p


def pick_device(name: str) -> torch.device:
    """The device a tool runs on: the card unless the caller asked for the
    CPU. ``cuda`` without a CUDA device raises; nothing falls back."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): this tool measures on the card; "
            "pass --device cpu to run its CPU size on the plain versions"
        )
    return torch.device("cuda", 0)


def study_main(run: Callable, doc: str, argv=None) -> dict:
    """A study's ``main``: parse, pick the device, take the CPU size on the
    CPU, and return ``run``'s records. Float32 products stay full float32
    (TF32 off) so the plain versions are float32 references."""
    args = study_parser(doc).parse_args(argv)
    dev = pick_device(args.device)
    if dev.type == "cpu":
        args.batch, args.clip_seconds, args.iters = CPU_SIZE
    torch.backends.cuda.matmul.allow_tf32 = False
    return run(args.batch, args.clip_seconds, args.iters, args.seed, dev)[0]


def k1_refusal(cfg, grade: str, route: str, tile: int):
    """Why the frontend kernel cannot run a grade at one route and frame
    tile, reckoned before any launch ("does not fit (N bytes of shared
    memory)"), or None."""
    from howl_tpu_torch.ops.frontend_cuda import TC_MAX_SHARED, fma_shared_bytes, tc_shared_bytes

    need = (tc_shared_bytes if route == "tc" else fma_shared_bytes)(cfg, grade, tile)
    return f"does not fit ({need} bytes of shared memory)" if need > TC_MAX_SHARED else None


def k1_leg(cfg, grade: str, route: str, tile: int, dev: torch.device, out_dtype=torch.bfloat16):
    """``fn(audio)``: the frontend kernel at one grade, route and frame tile
    (no ZMUV), as a JAX tool's leg calls ``log_mel_spectrogram_pallas`` at
    one block geometry. On a card the route is forced; on the CPU the plain
    version runs, which takes no route and checks the tile."""
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda

    kw = {"route": route} if dev.type == "cuda" else {}
    return lambda audio: log_mel_spectrogram_cuda(audio, cfg, 0.0, 1.0, precision=grade, out_dtype=out_dtype,
                                                  frame_tile=tile, **kw)


def study_audio(batch: int, clip_seconds: float, seed: int, dev: torch.device) -> torch.Tensor:
    """The frontend tools' audio, as the JAX tools draw it: seeded numpy
    normal noise times 0.1, (batch, clip_seconds * 16 kHz) float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((batch, int(clip_seconds * 16000))).astype(np.float32) * 0.1
    return torch.from_numpy(audio).to(dev)
