"""Offline scoring: batches of recordings through the configuration's
``StreamingEngine.infer_batch``, back to back, each batch's decisions
(``detected``, ``first_fire_step``) copied to the host.

Traffic parameters: ``batch`` recordings of ``clip_seconds`` each,
``pool_batches`` distinct batches made on the card from the seed and served
in turn, ``audio`` the parameters of the generator (``harness.make_audio``); ``check_recordings`` of
each batch, drawn from the seed, are kept from every call for the check.

End to end: ``offline_rtf``, the seconds of audio of every batch completed in
the window over the window's seconds. ``correct``: the posteriors of the
kept recordings against the plain reference's (``probs_gap``, the widest
gap; ``probs_gap_mean``, the mean gap; ``probs_gap_worst``, the mean gap of
the worst recording), and their decisions against the reference's rule applied to the
program's own posteriors (``decision_mismatches``, exact).
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
    sr = c["audio"]["sample_rate"]
    batch, samples = tr["batch"], int(round(tr["clip_seconds"] * sr))
    pool_n = tr["pool_batches"]
    weights = harness.make_weights(port.state_shapes(cfg.module.model(c)), harness.sub_seed(ctx.seed, 0), dev)
    fit = c["weights"]
    cfg.module.fit_weights(c, weights, harness.make_audio(
        (fit["fit_recordings"], int(fit["fit_seconds"] * sr)), harness.sub_seed(ctx.seed, 50), tr["audio"], sr, dev))
    pool = [harness.make_audio((batch, samples), harness.sub_seed(ctx.seed, 1 + p), tr["audio"], sr, dev)
            for p in range(pool_n)]
    clock.mark("weights_and_audio")
    calibration = cfg.module.calibration_audio(c, pool[0])
    engine = cfg.module.offline_engine(c, weights, calibration, dev)
    clock.mark("engine")

    rng = np.random.default_rng(harness.sub_seed(ctx.seed, 99))
    keep = torch.from_numpy(np.sort(rng.choice(batch, tr["check_recordings"], replace=False))).to(dev)
    kept, host = [], []
    k, n_win = len(keep), engine.n_windows(samples)

    def step(i: int) -> None:
        """One batch; its decisions, and what the check keeps of it, in one copy to the host."""
        p = i % pool_n
        out = engine.infer_batch(pool[p])
        bad = ~torch.isfinite(out["probs"]).all(dim=2).all(dim=1)
        flat = torch.cat([out["detected"].float(), out["first_fire_step"].float(), bad.float(),
                          out["labels"][keep].float().flatten(), out["fired"][keep].float().flatten(),
                          out["probs"][keep].flatten()]).cpu().numpy()
        host.append((p, flat[: 3 * batch].reshape(3, batch)))
        rest = flat[3 * batch :]
        kept.append((p, rest[2 * k * n_win :].reshape(k, n_win, -1), rest[: k * n_win].reshape(k, n_win),
                     rest[k * n_win : 2 * k * n_win].reshape(k, n_win)))

    t0 = time.perf_counter()
    _, launches = port.count_launches(lambda: step(0))
    first_call = time.perf_counter() - t0
    for p in range(pool_n):  # each batch once more: every shape and buffer of the window
        step(p)
    kept.clear()
    host.clear()
    clock.mark("warmup")
    ctx.note("launches_per_batch", launches)
    ctx.note("first_call_s", first_call)
    calls = 0
    start = time.perf_counter()
    deadline = start + ctx.seconds
    clock.mark("setup_end")
    now = start
    while now < deadline:
        step(calls)
        calls += 1
        now = time.perf_counter()
    window_s = now - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_calls = calls
    audio_s = window_calls * batch * tr["clip_seconds"]
    sl = None
    if ctx.trace:  # a slice traced once the window has closed, the same batches in turn
        slice_calls = max(2, math.ceil(tr["trace_slice_s"] / max(window_s / calls, 1e-3)))
        first = calls

        def run_slice():
            for j in range(slice_calls):
                step(first + j)
            return slice_calls

        sl = harness.trace_slice(run_slice, dev)
        calls += 2 * slice_calls

    # the check, once the program's state is freed
    check_audio = [pool[p][keep].clone() for p in range(pool_n)]
    calibration = None if calibration is None else calibration.clone()
    del engine, pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = cfg.module.reference(c, weights, "offline", torch.cat(check_audio), n_win, calibration)
    refs = refs.split(len(keep))
    if ctx.control:  # the control's readings: the reference one precision lower, in the program's place
        ctl = cfg.module.reference(c, weights, "offline", torch.cat(check_audio), n_win, calibration, control=True)
        d = (ctl - torch.cat(refs)).abs()
        ctx.note("control", harness.control_verdict({"probs_gap": float(d.max()), "probs_gap_mean": float(d.mean()),
                                                     "probs_gap_worst": float(d.mean(dim=(1, 2)).max())}, ctx.limits))
    refs_np = [r.cpu().numpy() for r in refs]
    gaps = [np.abs(probs - refs_np[p]) for p, probs, _, _ in kept]
    gap = max(float(d.max()) for d in gaps)
    gap_mean = sum(float(d.mean()) for d in gaps) / len(gaps)
    gap_worst = max(float(d.mean(axis=(1, 2)).max()) for d in gaps)
    del gaps
    mismatches = 0
    keep_np = keep.cpu().numpy()
    for lo in range(0, len(kept), 64):
        part = kept[lo : lo + 64]
        probs = torch.from_numpy(np.concatenate([x[1] for x in part])).to(dev)
        ref = detect.decide(probs, torch.ones(probs.shape[:2], dtype=torch.bool, device=dev), c["engine"],
                            g["stride_ms"])
        labels = np.concatenate([x[2] for x in part]).astype(np.int64)
        fired = np.concatenate([x[3] for x in part]).astype(bool)
        mismatches += int((ref["labels"].cpu().numpy() != labels).sum())
        mismatches += int((ref["fired"].cpu().numpy() != fired).sum())
        det = np.concatenate([host[lo + i][1][0][keep_np] for i in range(len(part))]).astype(bool)
        first = np.concatenate([host[lo + i][1][1][keep_np] for i in range(len(part))]).astype(np.int64)
        mismatches += int((ref["detected"].cpu().numpy() != det).sum())
        mismatches += int((ref["first_fire_step"].long().cpu().numpy() != first).sum())
    failed = int(sum(h[2].sum() for _, h in host))
    ctx.note("reference_s", time.perf_counter() - t_ref)
    ctx.note("fired_share", float(np.mean([h[0].mean() for _, h in host])))
    checks = harness.checks({"probs_gap": gap, "probs_gap_mean": gap_mean, "probs_gap_worst": gap_worst,
                             "decision_mismatches": mismatches}, ctx.limits)
    if sl is not None:
        window, n, devs, hosts, runtime, lost = sl
        ctx.note("primer_lost", lost)
        sl = harness.Slice(window, n, devs, hosts, runtime, run_calls=window_calls, run_window_s=window_s,
                           config=cfg, traffic=tr)
        ctx.note("idle_share_untraced", harness.idle_untraced(sl))
    for key, value in (("window_s", window_s), ("batches", window_calls), ("windows_a_recording", n_win)):
        ctx.note(key, value)
    return harness.Outcome({"offline_rtf": audio_s / window_s}, calls * batch, failed, checks, peak, sl)
