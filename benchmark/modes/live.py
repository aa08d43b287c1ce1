"""Live serving: ``streams`` always-listening streams, one hop of every
stream a call through the configuration's live engine (``push`` or
``ingest``), hops back to back: a closed loop, a server at its capacity.
Each hop's audio is a float32 array in pinned host memory, taken in turn
from a ring of ``ring_hops`` arrays made from the seed; what an array holds
is the configuration's ``feed``: a hop of new samples of every stream
("hop") or every stream's whole window ("window").

Traffic parameters: ``streams``, ``ring_hops``, ``audio`` (``harness.make_audio``'s parameters),
``warmup_hops`` (pushed before the window, every phase of the engine's
schedule among them), ``check_streams`` drawn from the seed, whose
posteriors, labels and fire flags are kept from every hop for the check,
``trace_slice_s``.

End to end: ``live_streams``, streams x hops completed / window seconds /
hops a stream asks for a second; ``hop_ms_p95``, the 95th percentile over
every hop of the window of the time from the engine call, the hop's audio
in pinned host memory, until its labels and fire flags are on the host.
``correct``: the kept posteriors against the plain reference's scoring of
the same audio (``probs_gap``, the widest gap; ``probs_gap_mean``, the mean
gap; ``probs_gap_worst``, the mean gap of the worst stream), and the kept labels and fire flags against
the reference's rule applied to the program's own posteriors
(``decision_mismatches``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import harness, port
from benchmark.reference import detect


def run(ctx) -> harness.Outcome:
    cfg, tr, dev, clock = ctx.config, ctx.traffic, ctx.device, ctx.clock
    c, g = cfg.data, cfg.data["geometry"]
    n, ring_n = tr["streams"], tr["ring_hops"]
    sr = c["audio"]["sample_rate"]
    width = g["hop_samples"] if c["live"]["feed"] == "hop" else g["window_samples"]
    weights = harness.make_weights(port.state_shapes(cfg.module.model(c)), harness.sub_seed(ctx.seed, 0), dev)
    fit = c["weights"]
    cfg.module.fit_weights(c, weights, harness.make_audio(
        (fit["fit_recordings"], int(fit["fit_seconds"] * sr)), harness.sub_seed(ctx.seed, 50), tr["audio"], sr, dev))
    pin = dev.type == "cuda"
    ring = []
    for r in range(ring_n):
        a = harness.make_audio((n, width), harness.sub_seed(ctx.seed, 1 + r), tr["audio"], sr, dev)
        ring.append(torch.empty((n, width), dtype=torch.float32, pin_memory=pin).copy_(a))
    del a
    clock.mark("weights_and_audio")
    engine = cfg.module.live_engine(c, weights, n, dev)
    posteriors, lag = cfg.module.live_posteriors(engine)
    clock.mark("engine")

    rng = np.random.default_rng(harness.sub_seed(ctx.seed, 99))
    keep_np = np.sort(rng.choice(n, tr["check_streams"], replace=False))
    keep = torch.from_numpy(keep_np).to(dev)
    kept_probs, kept_labels, kept_fired, latency = [], [], [], []
    bad = torch.zeros((), dtype=torch.long, device=dev)

    def hop(j: int) -> None:
        nonlocal bad
        t0 = time.perf_counter()
        cfg.module.push(engine, ring[j % ring_n])
        latency.append(time.perf_counter() - t0)
        p = posteriors()
        bad = bad + (~torch.isfinite(p).all(dim=1)).sum()
        kept_probs.append(p[keep])
        kept_labels.append(engine.last_labels[keep_np].copy())
        kept_fired.append(engine.last_fired[keep_np].copy())

    t0 = time.perf_counter()
    _, launches = port.count_launches(lambda: hop(0))
    first_hop = time.perf_counter() - t0
    for j in range(1, tr["warmup_hops"]):
        hop(j)
    clock.mark("warmup")
    ctx.note("launches_first_hop", launches)
    ctx.note("first_hop_s", first_hop)
    warm = hops = len(latency)
    start = time.perf_counter()
    deadline = start + ctx.seconds
    clock.mark("setup_end")
    now = start
    while now < deadline:
        hop(hops)
        hops += 1
        now = time.perf_counter()
    window_s = now - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_hops = hops - warm
    lat_ms = [1e3 * t for t in latency[warm:]]
    sl = None
    if ctx.trace:  # a slice traced once the window has closed, the streams' next hops
        slice_hops = max(2, math.ceil(tr["trace_slice_s"] / max(window_s / max(window_hops, 1), 1e-3)))
        firsts = []

        def run_slice():
            firsts.append(hops + len(firsts) * slice_hops)
            for k in range(slice_hops):
                hop(firsts[-1] + k)
            return slice_hops

        sl = harness.trace_slice(run_slice, dev)
        hops += 2 * slice_hops
    failed = int(bad)

    # the check, once the program's state is freed
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    probs = torch.stack(kept_probs, dim=1)  # (kept streams, hops, L)
    labels = torch.from_numpy(np.stack(kept_labels, axis=1)).to(dev).long()
    fired = torch.from_numpy(np.stack(kept_fired, axis=1)).to(dev)
    k_of = np.arange(hops) + 1 - lag  # the window each push decides; negative: none yet
    valid = torch.from_numpy(k_of >= 0).to(dev)
    if c["live"]["feed"] == "hop":
        # one recording a stream: its preroll of silence, then every hop pushed
        audio = torch.cat([torch.zeros((len(keep_np), cfg.module.preroll_samples(c)), device=dev)]
                          + [ring[j % ring_n][keep_np].to(dev) for j in range(hops)], dim=1)
        ref = cfg.module.reference(c, weights, "live", audio, int(k_of[-1]) + 1)  # (kept, windows, L)
        diff = (probs[:, valid] - ref[:, torch.from_numpy(k_of[k_of >= 0]).to(dev)]).abs()
        control = (lambda: cfg.module.reference(c, weights, "live", audio, int(k_of[-1]) + 1, control=True))
    else:
        # each hop's window is a recording of its own; the ring repeats them
        windows = torch.stack([ring[r][keep_np] for r in range(ring_n)], dim=1).to(dev)  # (kept, ring, samples)
        ref = cfg.module.reference(c, weights, "live", windows.flatten(0, 1), 1)
        ref = ref.reshape(len(keep_np), ring_n, -1)
        control = (lambda: cfg.module.reference(c, weights, "live", windows.flatten(0, 1), 1, control=True)
                   .reshape(ref.shape))
        diff = (probs - ref[:, torch.arange(hops, device=dev) % ring_n]).abs()
    gap, gap_mean, gap_worst = float(diff.max()), float(diff.mean()), float(diff.mean(dim=(1, 2)).max())
    if ctx.control:  # the control's readings: the reference one precision lower, in the program's place
        d = (control() - ref).abs()
        ctx.note("control", harness.control_verdict({"probs_gap": float(d.max()), "probs_gap_mean": float(d.mean()),
                                                     "probs_gap_worst": float(d.mean(dim=(1, 2)).max())}, ctx.limits))
    # the rule on the program's posteriors: window k at k strides, the pushes before the first window invalid
    decided = detect.decide(probs, valid[None, :].expand(len(keep_np), -1), c["engine"], g["stride_ms"])
    mismatches = int((decided["labels"] != labels).sum()) + int((decided["fired"] != fired).sum())
    ctx.note("reference_s", time.perf_counter() - t_ref)
    ctx.note("fired_share", float(fired.float().mean()))
    checks = harness.checks({"probs_gap": gap, "probs_gap_mean": gap_mean, "probs_gap_worst": gap_worst,
                             "decision_mismatches": mismatches}, ctx.limits)
    if sl is not None:
        window, k, devs, hosts, runtime, lost = sl
        ctx.note("primer_lost", lost)
        sl = harness.Slice(window, k, devs, hosts, runtime, run_calls=window_hops, run_window_s=window_s,
                           config=cfg, traffic=tr)
        ctx.note("idle_share_untraced", harness.idle_untraced(sl))
    hops_per_s = 1000.0 / g["stride_ms"]
    e2e = {"live_streams": n * window_hops / window_s / hops_per_s, "hop_ms_p95": harness.percentile(lat_ms, 95)}
    for key, value in (("window_s", window_s), ("hops", window_hops), ("hop_ms_p50", harness.percentile(lat_ms, 50))):
        ctx.note(key, value)
    return harness.Outcome(e2e, n * window_hops, failed, checks, peak, sl)
