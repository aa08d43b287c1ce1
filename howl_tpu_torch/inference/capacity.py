"""Serving capacity: can an engine configuration hold the 62.5 ms cadence on
one card? (counterpart of ``howl_tpu/inference/capacity.py``)

The live engines take any stream count, and a configuration past what the
card sustains only piles up underruns in the server. This module holds the
measured step-time model of each engine, so ``hub.load_workspace_engine``
can warn or refuse before it builds an unsustainable engine, pick an engine
(``auto=True``), and print the capacity table
(``python -m howl_tpu_torch.tools.gen_capacity_table``) from the same
numbers.

Step-time model: ms_per_step(n) = a + b * n, fit through the first and last
measured (streams, ms per step) points, a clamped to >= 0. The sustainable
count also respects the measured ceiling (the streams a card holds at the
cadence at the largest measured count), discounted by ``VARIANCE_MARGIN``,
the largest swing of the same code between two calibration runs; the 0.85
headroom in ``sustainable_streams`` is the fit's own margin. The arithmetic
is the JAX module's. The numbers are not: every profile below was measured on
an H100 by ``python -m howl_tpu_torch.tools.gen_capacity_table --calibrate``,
on the engines as the hub builds them by default (float32, the exact
frontend grade). A push engine's step is a whole ``MultiStreamServer.tick``:
the host gather of (N, hop_block x hop) float32 audio from the native mux on
``GATHER_THREADS`` threads, then the engine's step with its fire flags
fetched; the producers' pushes, on their own threads, are not in it. The
``OnlineEngine``, which no server drives, is its ``ingest`` of host windows
alone. A bf16 engine steps faster, so its checks err on the safe side.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

HOP_MS = 62.5  # the engines' cadence at the default 16 kHz / 1,000-sample hop
GATHER_THREADS = 1  # the threads of the profiled ticks' gather: MultiStreamServer's default

# The largest swing of the same code's ceiling between calibration runs on separate H100 machines (NVIDIA H100 80GB
# HBM3, 700.00 W; `python -m howl_tpu_torch.tools.gen_capacity_table --calibrate 1024,16384,65536`: two runs of the
# tool alone, 52 steps a point, and one inside `chip_smoke.py`'s phase 17c (e), 16 steps a point, on a slower host;
# PERF.md section 6): the hop_block=3 engine's, 20,330 streams in the first run and 17,292 in the third,
# 17.6 % (online 11.8 %, incremental 10.3 %, the trunk 8.5 %). Rounded up. The points at 1,024 streams swing more
# (the blocked engine's 44.96 and 91.58 ms); they set no ceiling.
VARIANCE_MARGIN = 0.18


class CapacityWarning(UserWarning):
    """An engine configuration predicted to miss its serving cadence."""


class CapacityError(ValueError):
    """No single-card engine configuration can sustain the requested load."""


@dataclass(frozen=True)
class EngineProfile:
    kind: str  # the hub's flag spelling
    label: str  # a name for tables
    points: Tuple[Tuple[int, float], ...]  # (num_streams, ms per step)
    ceiling: int  # measured streams a card holds at the cadence
    hops_per_step: int = 1  # hop_block: hops scored a step
    extra_latency_hops: int = 0  # decision lag (the trunk's lookahead and blocking)

    def fit(self) -> Tuple[float, float]:
        """(a, b) of ms_per_step = a + b * n from the first and last points."""
        (n0, t0), (n1, t1) = self.points[0], self.points[-1]
        b = (t1 - t0) / float(n1 - n0)
        a = t0 - b * n0
        if a < 0.0:  # a dispatch floor is never negative: anchor on the big point
            a, b = 0.0, t1 / n1
        return a, b

    def predict_step_ms(self, num_streams: int) -> float:
        a, b = self.fit()
        return a + b * num_streams

    def budget_ms(self, hop_ms: float = HOP_MS) -> float:
        return hop_ms * self.hops_per_step

    def sustainable_streams(self, hop_ms: float = HOP_MS, headroom: float = 0.85) -> int:
        """The most streams whose predicted step fits in headroom x budget,
        capped at the measured ceiling less ``VARIANCE_MARGIN``."""
        a, b = self.fit()
        n = (self.budget_ms(hop_ms) * headroom - a) / b
        return int(min(max(n, 0), self.ceiling * (1.0 - VARIANCE_MARGIN)))


# Measured on NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader) by
# `python -m howl_tpu_torch.tools.gen_capacity_table --calibrate 1024,16384,65536` (a push engine's step a whole
# server tick) in the three runs above: each point is the slower reading of the tool's two runs (medians of 52 steps;
# the third run's medians of 16 are too few to set a fit's intercept), each ceiling the lowest of the three runs (ms
# a step; streams a card holds at the hop).
PROFILES: Dict[Tuple[str, int], EngineProfile] = {
    ("online", 1): EngineProfile(
        kind="online", label="OnlineEngine (full-window re-score)",
        points=((1024, 18.846), (16384, 135.04), (65536, 549.289)),
        ceiling=7582,
    ),
    ("incremental", 1): EngineProfile(
        kind="incremental", label="IncrementalOnlineEngine",
        points=((1024, 15.466), (16384, 90.12), (65536, 360.686)),
        ceiling=11362,
    ),
    ("streaming_trunk", 1): EngineProfile(
        kind="streaming_trunk", label="FusedStreamingOnlineEngine",
        points=((1024, 20.675), (16384, 80.345), (65536, 270.166)),
        ceiling=15161,
        extra_latency_hops=4,  # the trunk's lookahead, schedule.lag
    ),
    ("streaming_trunk", 3): EngineProfile(
        kind="streaming_trunk", label="FusedStreamingOnlineEngine hop_block=3",
        points=((1024, 44.961), (16384, 189.937), (65536, 628.922)),
        ceiling=17292,
        hops_per_step=3,
        extra_latency_hops=6,  # the lookahead and up to hop_block - 1 hops of observation delay
    ),
}


@dataclass(frozen=True)
class CapacityReport:
    ok: bool
    kind: str
    hop_block: int
    num_streams: int
    predicted_step_ms: float
    budget_ms: float
    sustainable_streams: int
    message: str


def _profile(kind: str, hop_block: int) -> Optional[EngineProfile]:
    """The profile of (kind, hop_block); an unmeasured hop_block of the trunk
    engine scales the measured block profile's cost by its hops (a step's
    work is about linear in the hops it scores). None where nothing was
    measured to start from."""
    prof = PROFILES.get((kind, hop_block))
    base = PROFILES.get(("streaming_trunk", 3))
    if prof is None and kind == "streaming_trunk" and base is not None:
        a, b = base.fit()
        scale = hop_block / base.hops_per_step
        prof = EngineProfile(
            kind=kind, label=f"FusedStreamingOnlineEngine hop_block={hop_block}",
            points=((16384, (a + b * 16384) * scale), (65536, (a + b * 65536) * scale)),
            ceiling=base.ceiling,
            hops_per_step=hop_block,
            extra_latency_hops=base.extra_latency_hops - base.hops_per_step + hop_block,
        )
    return prof


def check_capacity(kind: str, num_streams: int, hop_block: int = 1, hop_ms: float = HOP_MS) -> CapacityReport:
    """Whether (engine, num_streams) is predicted to hold the cadence on one card."""
    prof = _profile(kind, hop_block)
    if prof is None:
        return CapacityReport(True, kind, hop_block, num_streams, 0.0, hop_ms, num_streams,
                              f"no capacity profile for {kind!r} hop_block={hop_block}; unchecked")
    predicted = prof.predict_step_ms(num_streams)
    budget = prof.budget_ms(hop_ms)
    sustainable = prof.sustainable_streams(hop_ms)
    ok = num_streams <= sustainable
    if ok:
        msg = f"{prof.label}: {num_streams} streams -> ~{predicted:.1f} ms/step in a {budget:.1f} ms budget"
    else:
        n_cards = max(math.ceil(num_streams / max(sustainable, 1)), 2)
        msg = (
            f"{prof.label} cannot sustain {num_streams} streams on one card: predicted ~{predicted:.1f} ms/step "
            f"against a {budget:.1f} ms budget (sustainable ~{sustainable}). Use hub.load_workspace_engine(auto=True) "
            f"to pick a cheaper engine, raise hop_block, or split the streams over ~{n_cards} cards: "
            f"engine.shard_streams(make_mesh(data={n_cards}))."
        )
    return CapacityReport(ok, kind, hop_block, num_streams, predicted, budget, sustainable, msg)


def recommend(num_streams: int, supports_trunk: bool = True, hop_ms: float = HOP_MS) -> Dict[str, object]:
    """The lowest-decision-latency engine that sustains ``num_streams`` on one
    card, as hub keyword arguments (the hub's ``auto=True``). The plain
    ``OnlineEngine`` is not a candidate, as in JAX. Raises CapacityError when
    no profiled configuration fits."""
    candidates = [({"incremental": True}, ("incremental", 1))]
    if supports_trunk:
        candidates += [({"streaming_trunk": True}, ("streaming_trunk", 1)),
                       ({"streaming_trunk": True, "hop_block": 3}, ("streaming_trunk", 3))]
    profiled = [(kwargs, key, PROFILES[key]) for kwargs, key in candidates if key in PROFILES]
    for kwargs, _, prof in profiled:
        if num_streams <= prof.sustainable_streams(hop_ms):
            return kwargs
    if not profiled:
        raise CapacityError(f"no capacity profile for the candidate engines {[key for _, key in candidates]}")
    _, (best_kind, best_block), prof = profiled[-1]
    sustainable = prof.sustainable_streams(hop_ms)
    n_cards = math.ceil(num_streams / max(sustainable, 1))
    raise CapacityError(
        f"no single-card engine sustains {num_streams} streams (best: {best_kind} hop_block={best_block} at "
        f"~{sustainable}); split the streams over ~{n_cards} cards: engine.shard_streams(make_mesh(data={n_cards}))"
    )


def capacity_table(hop_ms: float = HOP_MS) -> list:
    """Rows of the capacity table, from the model the hub's checks use."""
    rows = []
    for (kind, hop_block), prof in sorted(PROFILES.items()):
        rows.append({
            "engine": prof.label,
            "kind": kind,
            "hop_block": hop_block,
            "sustainable_streams": prof.sustainable_streams(hop_ms),
            "ceiling": prof.ceiling,
            "step_ms_at_16k": round(prof.predict_step_ms(16384), 2),
            "decision_latency_hops": prof.extra_latency_hops,
        })
    return rows
