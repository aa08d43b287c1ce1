"""The port's benchmark: batched res8 wake-word scoring and the res8 train
step on one NVIDIA GPU (counterpart of the JAX package's ``bench.py``).

    python -m howl_tpu_torch.bench [--device cuda|cpu] [--repeats R] [--seed S]

Prints ONE JSON line with ``bench.py``'s keys, measured on the card:

  * ``value``: the realtime factor of offline scoring, seconds of audio per
    second, of ``StreamingEngine.infer_batch`` on 512 clips of 8 s in bf16
    with the fused trunk (the frontend kernel K1 at its "bf16" grade, the
    stem kernel K2, and the residual trunk that :data:`HEADLINE_TRUNK`
    names: the int8 trunk's kernel, calibrated on the batch's first 64
    clips, as ``bench.py`` builds its headline engine, or cuDNN's bf16
    convs), decisions included; ``vs_baseline`` is value / 1000,
    ``bench.py``'s north star;
  * ``mfu``: the analytic FLOPs of that path (:func:`path_flops_per_clip`,
    the same count whichever trunk runs, as ``bench.py`` counts it) over the
    time and the card's dense bf16 peak (:func:`peak_bf16_flops`); ``null``
    on a card with no peak on record;
  * ``legacy_realtime_factor``: the same batch through the per-window
    mega-batch scorer (``fused_trunk=False``);
  * ``train_examples_per_sec`` / ``train_mfu``: the bf16 res8 train step over
    float32 masters at batch 1024 x 8,000 samples (VTLP, augmentation,
    AdamW); ``train_noise_examples_per_sec`` the same step mixing from a
    (512, 32000) noise bank (the kernel K3) with replace_prob 0.1;
    ``train_examples_per_sec_f32`` the float32 step;
  * the seven online keys, live serving at the client's 62.5 ms hop, bf16,
    ``bench.py``'s sizes: ``online_streams_per_chip`` (the
    ``IncrementalOnlineEngine``, which featurizes only each hop) and
    ``online_streams_full_window`` (the ``OnlineEngine``, K1 on every whole
    window), each 512 streams x 256 steps on a ring of 16 hops, streams =
    n * steps / time / 16; ``online_step_latency_ms``, the incremental
    step's p50 / p99 at 1,024, 16,384 and 65,536 streams, a sample one
    chain of 32 steps / 32, 12 samples; ``online_streams_per_chip_trunk``
    and ``online_step_latency_ms_trunk``, the ``FusedStreamingOnlineEngine``
    at 16,384 and 65,536 streams, a sample 11 periods of hops, 8 samples
    (streams: the better count's n / (p50 * 16)); and ``..._trunk_blocked``,
    the same with ``hop_block`` = the schedule's period, latencies per hop;

and three keys of its own: ``spread``, the [min, max] of each measured key
over the repeats (of each latency's samples, by stream count); ``rungs``,
what ran (each kernel's route, grade and launches per batch or step;
``rungs["int8"]`` names the trunk ``value`` measured, the int8 trunk's
kernel route, "fused" or "layer", with both int8 kernels' launches a batch,
and both trunks' median ms per batch from this run); ``device``, the card's ``nvidia-smi``
name and power limit. Each measured offline and train key is the median
over ``--repeats`` (5) repeats, the headline, the same engine with the other
trunk and the legacy scorer (then the three train steps) in turns; the two
per-window online rates too, their engines in turns.

Method: as in ``bench.py``, iterations are chained: after each batch the
detections' sum times 1e-30 is added in place to ``audio[0, 0]``, so each
input depends on the last decisions; a train step depends on the last
through the state. A chain of 32 batches (8 for the legacy scorer; 64 train
steps) is timed by CUDA events after a warm-up, audio already on the card.
An online chain steps through the engine's state, each step taking the
last one's, with every stream's audio read from a ring on the card at the
step's offset, as ``bench.py`` replays it; nothing is copied to the host
inside a chain. Float32 products and convolutions run in full float32 (TF32
off).

Weights are random from the seed: numpy variables in the JAX package's
layout carried across by ``compat.res8_variables_to_state_dict``, so the
JAX engine can run the same weights. Audio is seeded noise.

``--device cpu`` runs ``bench.py``'s CPU sizes (batch 4 x 2 s, 2 batches a
chain, train batch 8, 2 steps, a (4, 2048) bank; online 8 streams x 4
steps, latencies and trunks at 8 streams, 2 samples of 2 steps or periods)
on the kernels' plain versions, with the card's dtypes and scorers; ``mfu``
and ``train_mfu`` are 0.0 there, as ``bench.py`` gives them off the
accelerator. Without ``--device cpu`` and without a card it raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

SAMPLE_RATE = 16000
N_MELS = 40
NUM_LABELS = 4
TRAIN_WINDOW = 8000
REPLACE_PROB = 0.1
ONLINE_KEYS = (
    "online_streams_per_chip", "online_streams_full_window", "online_step_latency_ms",
    "online_streams_per_chip_trunk", "online_step_latency_ms_trunk", "online_streams_per_chip_trunk_blocked",
    "online_step_latency_ms_trunk_blocked",
)
# The residual trunk of the headline engine: "int8" (the int8 trunk's kernel, as bench.py's headline on its
# accelerator) or "bf16" (cuDNN). Adopted on a same-call A/B of the full fused step, the serving ablation's int8 leg
# against its bf16-trunk leg in turns (chip_smoke.py's int8 phase; PERF.md); int8 only where it was no slower.
HEADLINE_TRUNK = "int8"
TRUNKS = ("int8", "bf16")
CALIBRATION_CLIPS = 64  # bench.py: int8_calibration_audio=audio[:64]
# dense bf16 with float32 sums, from NVIDIA's data sheet, at the full 700 W
H100_SXM_BF16_FLOPS = 989e12
_BF16_PEAKS = (("H100 80GB HBM3", H100_SXM_BF16_FLOPS), ("H100 SXM", H100_SXM_BF16_FLOPS))


class OnlineSizes(NamedTuple):
    streams: int  # of the two per-window rates
    steps: int  # in one of their chains
    latency_counts: tuple  # stream counts of the incremental step's latency
    latency_steps: int  # steps a latency sample
    latency_samples: int
    trunk_counts: tuple  # stream counts of the trunk engines
    trunk_periods: int  # schedule periods (per-hop) or blocks (blocked) a sample
    trunk_samples: int


class Sizes(NamedTuple):
    batch: int
    clip_seconds: float
    iters: int  # batches in a timed chain of the headline engine
    legacy_iters: int  # of the per-window scorer
    train_batch: int
    train_steps: int  # steps in a timed chain
    bank_shape: tuple
    online: OnlineSizes


HOP_MS = 62.5  # the client's hop: a live stream asks for 16 steps a second
RING_HOPS = 16  # the per-window rates' audio ring, in hops
LATENCY_RING_HOPS = 4
# bench.py's sizes
CARD = Sizes(512, 8.0, 32, 8, 1024, 64, (512, 32000), OnlineSizes(512, 256, (1024, 16384, 65536), 32, 12,
                                                                 (16384, 65536), 11, 8))
CPU = Sizes(4, 2.0, 2, 1, 8, 2, (4, 2048), OnlineSizes(8, 4, (8,), 2, 2, (8,), 2, 2))


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s by the name
    ``torch.cuda.get_device_name`` gives, or None for a card not on record."""
    return next((peak for part, peak in _BF16_PEAKS if part in device_name), None)


def path_flops_per_clip(clip_samples: int, engine, num_labels: int, maps=45):
    """Analytic FLOPs (2*MACs) of one clip through the fused serving path,
    with the window/stride/frontend geometry taken from the constructed
    engine (``bench.py``'s count, term for term)."""
    fe = engine.frontend
    frames = fe.num_frames(clip_samples)
    frontend = frames * (2 * fe.n_fft * fe.n_freqs + fe.n_freqs * fe.n_mels)
    conv0 = frames * fe.n_mels * maps * 9  # in-ch 1
    pooled = frames // engine.model.pooling[0]
    trunk = pooled * (fe.n_mels // engine.model.pooling[1]) * maps * maps * 9 * 6
    head = engine.n_windows(clip_samples) * maps * num_labels
    return 2 * (frontend + conv0 + trunk + head)


def train_flops_per_example(window_samples: int, frontend, maps=45, num_labels=4, pool=(3, 4)):
    """Analytic train-step FLOPs per example: the forward work of the VTLP
    frontend + res8 + head, times 3 for the backward (``bench.py``'s count,
    term for term)."""
    frames = frontend.num_frames(window_samples)
    fe = frames * (2 * frontend.n_fft * frontend.n_freqs + frontend.n_freqs * frontend.n_mels)
    conv0 = frames * frontend.n_mels * maps * 9
    trunk = (frames // pool[0]) * (frontend.n_mels // pool[1]) * maps * maps * 9 * 6
    head = maps * num_labels
    return 3 * 2 * (fe + conv0 + trunk + head)


def res8_numpy_variables(rng: np.random.Generator, num_labels: int, maps: int = 45) -> dict:
    """Seeded res8 variables in the JAX package's layout (HWIO convs, (in,
    out) dense), lecun-normal like flax's initializers, with nonzero
    BatchNorm running stats."""
    params, stats = {}, {}
    for i in range(7):
        cin = 1 if i == 0 else maps
        params[f"conv{i}"] = {"kernel": rng.standard_normal((3, 3, cin, maps)) / np.sqrt(9 * cin)}
    for i in range(1, 7):
        stats[f"bn{i}"] = {"mean": rng.normal(0.0, 0.1, maps), "var": rng.uniform(0.5, 1.5, maps)}
    params["output"] = {
        "kernel": rng.standard_normal((maps, num_labels)) / np.sqrt(maps),
        "bias": rng.normal(0.0, 0.1, num_labels),
    }
    return {"params": params, "batch_stats": stats}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- serving ----


def serving_config():
    """``bench.py``'s engine configuration: res8, 4 labels, 500 ms windows
    every 62.5 ms."""
    from howl_tpu_torch.inference import EngineConfig

    return EngineConfig(
        inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
        negative_label=3, num_labels=NUM_LABELS, sample_rate=SAMPLE_RATE,
    )


def _engine(dev, state_dict, fused: bool, trunk: str = "bf16", calibration_audio=None):
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    if trunk not in TRUNKS:
        raise ValueError(f"trunk must be one of {TRUNKS}, got {trunk!r}")
    return StreamingEngine(create_model("res8", num_labels=NUM_LABELS), state_dict, serving_config(),
                           FrontendConfig(n_mels=N_MELS), 0.0, 1.0, compute_dtype=torch.bfloat16, fused_trunk=fused,
                           frontend_precision="bf16", use_int8_trunk=trunk == "int8",
                           int8_calibration_audio=calibration_audio, device=dev)


def headline_engine(dev, state_dict, trunk: str = "bf16", calibration_audio=None):
    """The bf16 fused-trunk engine at the "bf16" frontend grade (what "auto"
    serves in bf16), ZMUV 0 / 1 as ``bench.py`` serves, with the residual trunk
    ``trunk`` names ("int8": calibrated on ``calibration_audio``)."""
    return _engine(dev, state_dict, True, trunk, calibration_audio)


def serving_engines(dev, state_dict, trunk: str = "bf16", calibration_audio=None):
    """(headline, legacy): :func:`headline_engine` and the bf16 per-window
    mega-batch engine on the same weights."""
    return headline_engine(dev, state_dict, trunk, calibration_audio), _engine(dev, state_dict, False)


def chained_batch_ms(engine, audio: torch.Tensor, n_iters: int) -> float:
    """Milliseconds per batch of a chain of ``n_iters`` ``infer_batch``
    calls, each input bumped in place by the last detections (CUDA events
    on a card, the host clock on the CPU)."""
    from howl_tpu_torch.tools._study import chain_ms

    def chain():
        for _ in range(n_iters):
            out = engine.infer_batch(audio)
            audio[:1, :1] += out["detected"].sum().float() * 1e-30

    return chain_ms(chain, audio.device) / n_iters


def _scorer_rung(engine, audio: torch.Tensor) -> dict:
    """What one batch of ``engine`` runs, read from the launch counters
    around it on a card (the plain versions on the CPU count nothing)."""
    from howl_tpu_torch.ops.frontend_cuda import frontend_grade, frontend_route, log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda, int8_trunk_fused_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, stem_route

    on_card = audio.device.type == "cuda"
    counters = (log_mel_spectrogram_cuda, res8_stem_cuda)
    for fn in counters:
        fn.launches = fn.launches_tc = 0
    int8_conv_layer_cuda.launches = int8_trunk_fused_cuda.launches = 0
    engine.infer_batch(audio)
    if on_card:
        torch.cuda.synchronize(audio.device)
    grade, dtype = frontend_grade(engine.frontend_precision), engine.compute_dtype or torch.float32
    # which int8 kernel ran, read from its counters: "fused" (one launch a batch), "layer" (six) or "plain"
    int8_route = ("fused" if int8_trunk_fused_cuda.launches else "layer" if int8_conv_layer_cuda.launches
                  else "plain")
    return {
        "scorer": "fused trunk" if engine.fused_trunk else "per-window mega-batch",
        "compute_dtype": str(dtype).replace("torch.", ""),
        "frontend": {"kernel": "K1", "route": frontend_route(engine.frontend, grade) if on_card else "plain",
                     "grade": grade, "layout": "tm" if engine.fused_trunk else "fm",
                     "launches_per_batch": log_mel_spectrogram_cuda.launches},
        "stem": {"kernel": "K2", "route": stem_route(dtype, engine.frontend.n_mels, engine.model.num_maps,
                                                     engine.model.pooling) if on_card else "plain",
                 "launches_per_batch": res8_stem_cuda.launches},
        "residual_convs": ({"kernel": "int8 trunk", "route": int8_route,
                            "launches_per_batch": {"int8_fused": int8_trunk_fused_cuda.launches,
                                                   "int8_layer": int8_conv_layer_cuda.launches}}
                           if engine._int8_params is not None else "cuDNN (F.conv2d)" if on_card else "F.conv2d"),
    }


def bench_serving(dev, sizes: Sizes, repeats: int, seed: int) -> dict:
    """{"batch_ms", "legacy_batch_ms": one value per repeat, "rungs",
    "flops_per_batch", "audio_seconds"}; the headline engine's trunk is
    :data:`HEADLINE_TRUNK`, and the same engine with the other trunk runs in
    turns with it for ``rungs["int8"]``."""
    from howl_tpu_torch.compat import res8_variables_to_state_dict

    rng = np.random.default_rng(seed)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, NUM_LABELS))
    clip_samples = int(sizes.clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy((rng.standard_normal((sizes.batch, clip_samples)) * 0.1).astype(np.float32)).to(dev)
    calibration = audio[:CALIBRATION_CLIPS]
    engine, legacy = serving_engines(dev, state, HEADLINE_TRUNK, calibration)
    other_trunk = next(t for t in TRUNKS if t != HEADLINE_TRUNK)
    other = headline_engine(dev, state, other_trunk, calibration)
    # one batch each, untimed: the warm-up, and what ran
    rungs = {"headline": _scorer_rung(engine, audio), "legacy": _scorer_rung(legacy, audio)}
    other_rung = _scorer_rung(other, audio)
    int8_convs = (rungs["headline"] if HEADLINE_TRUNK == "int8" else other_rung)["residual_convs"]
    runs = {"batch_ms": [], "other_batch_ms": [], "legacy_batch_ms": []}
    for _ in range(repeats):
        runs["batch_ms"].append(chained_batch_ms(engine, audio, sizes.iters))
        runs["other_batch_ms"].append(chained_batch_ms(other, audio, sizes.iters))
        runs["legacy_batch_ms"].append(chained_batch_ms(legacy, audio, sizes.legacy_iters))
    ms = {HEADLINE_TRUNK: runs["batch_ms"], other_trunk: runs.pop("other_batch_ms")}
    rungs["int8"] = {"value_trunk": HEADLINE_TRUNK, "route": int8_convs["route"],
                     "launches_per_batch": int8_convs["launches_per_batch"],
                     "calibration_clips": int(calibration.shape[0]),
                     "batch_ms": {t: statistics.median(ms[t]) for t in TRUNKS}}
    return {**runs, "rungs": rungs, "audio_seconds": sizes.batch * sizes.clip_seconds,
            "flops_per_batch": path_flops_per_clip(clip_samples, engine, NUM_LABELS) * sizes.batch}


# ---- online serving ----


def online_engine(kind: str, dev, state_dict, num_streams: int, **kw):
    """One of the bench's live engines on ``serving_config()``, bf16, ZMUV 0
    / 1 as ``bench.py`` serves: "full_window" (``OnlineEngine``),
    "incremental" (``IncrementalOnlineEngine``) or "trunk"
    (``FusedStreamingOnlineEngine``, ``hop_block`` in ``kw``)."""
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    cls = {"full_window": OnlineEngine, "incremental": IncrementalOnlineEngine, "trunk": FusedStreamingOnlineEngine}
    return cls[kind](create_model("res8", num_labels=NUM_LABELS), state_dict, serving_config(),
                     FrontendConfig(n_mels=N_MELS), 0.0, 1.0, num_streams=num_streams, compute_dtype=torch.bfloat16,
                     device=dev, **kw)


def hop_chain(engine, buf: torch.Tensor, n_steps: int, ring_hops: int):
    """A chain of ``n_steps`` hops through a per-window engine, each step
    taking the last one's state (kept on the engine): step k reads its
    streams' audio at offset ``(k % ring_hops) * hop_samples`` of ``buf``,
    the window ending there (``OnlineEngine``) or the hop (the incremental
    engine), at time (k + 1) * 62.5 ms, as ``bench.py`` replays it."""
    hop = engine.hop_samples
    full = hasattr(engine, "window_samples")

    def chain():
        for k in range(n_steps):
            off, t_now = (k % ring_hops) * hop, (k + 1) * HOP_MS
            if full:
                engine.state, *_ = engine._step(buf[:, off : off + engine.window_samples].contiguous(), engine.state,
                                                t_now)
            else:
                engine.tail, engine.mel_ring, engine.state, *_ = engine._step(
                    buf[:, off : off + hop], engine.tail, engine.mel_ring, engine.state, t_now)

    return chain


def trunk_chain(engine, buf: torch.Tensor, ring_hops: int, super_steps: int):
    """A chain of ``make_chained_runner``'s replay through a trunk engine,
    the carry kept between calls."""
    from howl_tpu_torch.inference.streaming_trunk import make_chained_runner

    run, carry = make_chained_runner(engine, ring_hops, super_steps)
    holder = [carry]

    def chain():
        holder[0], _ = run(buf, *holder[0])

    return chain


def _counted(fn, on_card: bool) -> tuple:
    """(``fn()``, K1's and K2's launches while it ran: {"k1", "k2", "k1_tc",
    "k2_tc"}), the counters zeroed just before and read just after."""
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    counters = {"k1": log_mel_spectrogram_cuda, "k2": res8_stem_cuda}
    for c in counters.values():
        c.launches = c.launches_tc = 0
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, {**{k: c.launches for k, c in counters.items()}, **{f"{k}_tc": c.launches_tc for k, c in counters.items()}}


def _online_rungs(counts: dict, on_card: bool, period: int) -> dict:
    """What each live engine runs, from the launch counts of one step of
    each per-window engine and of the trunk engine's prefill."""
    def kernel(kind, k, launches_key):
        route = ("tc" if counts[kind][f"{k}_tc"] else "fma") if on_card else "plain"
        return {"kernel": k.upper(), "route": route, launches_key: counts[kind][k]}

    chain = "the log-mel chain (torch.matmul, grade bf16, center=False)"
    return {
        "compute_dtype": "bfloat16",
        "full_window": {"engine": "OnlineEngine",
                        "frontend": {**kernel("full_window", "k1", "launches_per_step"), "grade": "bf16", "layout": "fm"},
                        "stem": kernel("full_window", "k2", "launches_per_step")},
        "incremental": {"engine": "IncrementalOnlineEngine", "frontend": chain,
                        "stem": kernel("incremental", "k2", "launches_per_step")},
        "trunk": {"engine": "FusedStreamingOnlineEngine", "frontend": chain, "stem": "F.conv2d over each hop's slab",
                  "prefill_stem": kernel("trunk", "k2", "launches"), "hop_block": {"per-hop": 1, "blocked": period}},
        "residual_convs": "cuDNN (F.conv2d)" if on_card else "F.conv2d",
        "decisions": "detect_step (the scan form, torch)",
    }


def bench_online(dev, sizes: Sizes, repeats: int, seed: int, state_dict) -> dict:
    """The seven online keys' timings: {"per_window": {key: streams, one per
    repeat}, "latency" / "trunk" / "trunk_blocked": {count: ms per hop, one
    per sample}, "hop_block", "rungs"}."""
    from howl_tpu_torch.tools._study import chain_ms

    o, on_card = sizes.online, dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 10)

    def noise(n, samples):
        return torch.randn((n, samples), generator=gen, device=dev) * 0.1

    kinds = {"online_streams_full_window": "full_window", "online_streams_per_chip": "incremental"}
    engines = {key: online_engine(kind, dev, state_dict, o.streams) for key, kind in kinds.items()}
    full = engines["online_streams_full_window"]
    buf = noise(o.streams, full.window_samples + RING_HOPS * full.hop_samples)
    chains = {key: hop_chain(eng, buf, o.steps, RING_HOPS) for key, eng in engines.items()}
    # one step each, untimed: the warm-up, and what ran
    counts = {kind: _counted(hop_chain(engines[key], buf, 1, RING_HOPS), on_card)[1] for key, kind in kinds.items()}
    per_window = {key: [] for key in engines}
    for r in range(repeats):
        for key in (list(engines) if r % 2 == 0 else list(reversed(engines))):
            ms = chain_ms(chains[key], dev)
            per_window[key].append(o.streams * o.steps / (ms / 1e3) / (1000.0 / HOP_MS))
    del engines, chains, full, buf

    latency = {}
    for n in o.latency_counts:
        eng = online_engine("incremental", dev, state_dict, n)
        chain = hop_chain(eng, noise(n, LATENCY_RING_HOPS * eng.hop_samples), o.latency_steps, LATENCY_RING_HOPS)
        chain()  # the warm-up
        latency[str(n)] = [chain_ms(chain, dev) / o.latency_steps for _ in range(o.latency_samples)]
        del eng, chain
        _free(dev)

    # the trunk engines last, the earlier ones freed: at 65,536 streams one keeps ~2 GB, its prefill more
    trunk, blocked, period = {}, {}, None
    for n in o.trunk_counts:
        eng, counted = _counted(lambda: online_engine("trunk", dev, state_dict, n), on_card)
        counts.setdefault("trunk", counted)
        period = eng.schedule.period
        # period + 1 hops of ring: the runner refuses a multiple of the period
        chain = trunk_chain(eng, noise(n, (period + 1) * eng.hop_samples), period + 1, o.trunk_periods)
        chain()
        trunk[str(n)] = [chain_ms(chain, dev) / (o.trunk_periods * period) for _ in range(o.trunk_samples)]
        del eng, chain
        _free(dev)
        eng = online_engine("trunk", dev, state_dict, n, hop_block=period)
        chain = trunk_chain(eng, noise(n, 2 * period * eng.hop_samples), 2, o.trunk_periods)  # trunk_periods blocks
        chain()
        blocked[str(n)] = [chain_ms(chain, dev) / (o.trunk_periods * period) for _ in range(o.trunk_samples)]
        del eng, chain
        _free(dev)
    return {"per_window": per_window, "latency": latency, "trunk": trunk, "trunk_blocked": blocked,
            "hop_block": period, "rungs": _online_rungs(counts, on_card, period)}


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def online_record(online: dict) -> tuple:
    """(the seven keys, their spreads) from ``bench_online``'s timings:
    streams as ints as ``bench.py`` gives them (the per-window rates the
    median over the repeats, the trunk rates n / (p50 * 16) at the better
    count), latencies {count: {"p50", "p99"}} in ms per hop, rounded to 3
    digits."""
    keys, spread = {}, {}
    for key, values in online["per_window"].items():
        keys[key], spread[key] = int(statistics.median(values)), [min(values), max(values)]
    keys["online_step_latency_ms"], spread["online_step_latency_ms"] = _latencies(online["latency"])
    for suffix, runs in (("trunk", online["trunk"]), ("trunk_blocked", online["trunk_blocked"])):
        lat, lat_spread = _latencies(runs, hop_block=online["hop_block"] if suffix == "trunk_blocked" else None)
        rates = {n: int(n) / (float(np.percentile(ms, 50)) / 1e3 * (1000.0 / HOP_MS)) for n, ms in runs.items()}
        best = max(rates, key=rates.get)
        keys[f"online_streams_per_chip_{suffix}"] = int(rates[best])
        spread[f"online_streams_per_chip_{suffix}"] = [int(best) / (max(runs[best]) / 1e3 * (1000.0 / HOP_MS)),
                                                        int(best) / (min(runs[best]) / 1e3 * (1000.0 / HOP_MS))]
        keys[f"online_step_latency_ms_{suffix}"], spread[f"online_step_latency_ms_{suffix}"] = lat, lat_spread
    return keys, spread


def _latencies(runs: dict, hop_block=None) -> tuple:
    lat = {n: {"p50": round(float(np.percentile(ms, 50)), 3), "p99": round(float(np.percentile(ms, 99)), 3),
               **({"hop_block": hop_block} if hop_block else {})} for n, ms in runs.items()}
    return lat, {n: [min(ms), max(ms)] for n, ms in runs.items()}


# ---- training ----


def train_setup(dev, audio: np.ndarray, labels: np.ndarray, bank_shape: Optional[tuple], seed: int):
    """The train bench's configuration on ``audio`` and ``labels`` (numpy):
    seeded numpy res8 variables, a seeded noise bank on the device (None
    for ``bank_shape=None``), ZMUV fit
    on the first 256 clips, 40 mels, VTLP, default augmentation,
    replace_prob 0.1 (it acts only with the bank). Returns (audio, labels,
    bank, cfg, state_for), ``state_for(dtype)`` giving a fresh (model,
    AdamW state) at that compute dtype over float32 masters."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.augment import AugmentConfig
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.zmuv import fit_zmuv
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import StepConfig

    variables = res8_numpy_variables(np.random.default_rng(seed), NUM_LABELS)
    audio, labels = torch.from_numpy(audio).to(dev), torch.from_numpy(labels).to(dev)
    bank = None
    if bank_shape is not None:
        bank = torch.randn(bank_shape, generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev) * 0.05
    frontend = FrontendConfig(n_mels=N_MELS)
    zmuv = fit_zmuv([audio[:256]], frontend)
    cfg = StepConfig(
        frontend, zmuv.mean, zmuv.std, augment=AugmentConfig(), use_vtlp=True, replace_prob=REPLACE_PROB,
        negative_label=3, use_deltas=False,
    )

    def state_for(dtype):
        model = create_model("res8", num_labels=NUM_LABELS, dtype=dtype)
        return model, create_train_state(
            model, 0.01, lr_decay=0.99, steps_per_epoch=100, variables=variables, device=dev
        )

    return audio, labels, bank, cfg, state_for


def chained_step_ms(step, state, audio: torch.Tensor, labels: torch.Tensor, n_steps: int,
                    metrics: Optional[list] = None) -> float:
    """Milliseconds per step of a chain of ``n_steps`` train steps through
    ``state`` (CUDA events on a card, the host clock on the CPU); the last
    step's metrics are appended to ``metrics`` when it is given."""
    from howl_tpu_torch.tools._study import chain_ms

    def chain():
        for _ in range(n_steps):
            out = step(state, audio, labels, None, 0)  # the step's draws follow (0, state.step)
        if metrics is not None:
            metrics.append(out[1])

    return chain_ms(chain, audio.device) / n_steps


def train_steps(model, f32_model, cfg, bank) -> dict:
    """The three timed steps by the key of the rate each gives."""
    from howl_tpu_torch.training.step import make_classification_train_step

    return {
        "train_examples_per_sec": make_classification_train_step(model, cfg),
        "train_noise_examples_per_sec": make_classification_train_step(model, cfg, bank),
        "train_examples_per_sec_f32": make_classification_train_step(f32_model, cfg),
    }


def time_train_steps(steps: dict, states: dict, audio, labels, n_steps: int, repeats: int) -> dict:
    """{key: ms per step, one value per repeat}: each step warmed with one
    step, then chains of ``n_steps`` in turns, the order reversed on every
    other repeat."""
    for key, step in steps.items():
        step(states[key], audio, labels, None, 0)
    runs = {key: [] for key in steps}
    for r in range(repeats):
        for key in (list(steps) if r % 2 == 0 else list(reversed(steps))):
            runs[key].append(chained_step_ms(steps[key], states[key], audio, labels, n_steps))
    return runs


def bench_train_step(dev, sizes: Sizes, repeats: int, seed: int) -> dict:
    """{rate key: ms per step, one value per repeat} for the three train
    steps on seeded noise with random labels, as ``bench.py`` trains."""
    rng = np.random.default_rng(seed + 2)
    audio = (rng.standard_normal((sizes.train_batch, TRAIN_WINDOW)) * 0.1).astype(np.float32)
    labels = rng.integers(0, NUM_LABELS, sizes.train_batch)
    audio, labels, bank, cfg, state_for = train_setup(dev, audio, labels, sizes.bank_shape, seed + 3)
    (model, state), (f32_model, f32_state) = state_for(torch.bfloat16), state_for(None)
    steps = train_steps(model, f32_model, cfg, bank)
    states = {key: f32_state if key.endswith("_f32") else state for key in steps}
    return time_train_steps(steps, states, audio, labels, sizes.train_steps, repeats)


# ---- the record ----


def make_record(serve: dict, train: dict, sizes: Sizes, on_card: bool, peak: Optional[float], mix_launches_per_step,
                device: Optional[str], online: Optional[dict] = None) -> dict:
    """The bench's record from the serving and train timings (one value per
    repeat each): every measured key the median over the repeats, rounded as
    ``bench.py`` rounds it, with its [min, max] under ``spread``; the online
    keys from ``online`` (``bench_online``'s timings; null without).
    ``mfu`` and ``train_mfu`` are 0.0 off the card, as ``bench.py`` gives
    them, and null on a card with no ``peak``."""
    from howl_tpu_torch.ops.frontend import FrontendConfig

    train_flops = train_flops_per_example(TRAIN_WINDOW, FrontendConfig(n_mels=N_MELS))

    def util(flops_per_s):
        return (flops_per_s / peak if peak else None) if on_card else 0.0

    per_repeat = {
        "value": [serve["audio_seconds"] / (ms / 1e3) for ms in serve["batch_ms"]],
        "mfu": [util(serve["flops_per_batch"] / (ms / 1e3)) for ms in serve["batch_ms"]],
        "legacy_realtime_factor": [serve["audio_seconds"] / (ms / 1e3) for ms in serve["legacy_batch_ms"]],
        **{key: [sizes.train_batch / (ms / 1e3) for ms in runs] for key, runs in train.items()},
    }
    per_repeat["train_mfu"] = [util(train_flops * rate) for rate in per_repeat["train_examples_per_sec"]]
    med, spread = {}, {}
    for key, values in per_repeat.items():
        measured = None not in values
        med[key] = statistics.median(values) if measured else None
        spread[key] = [min(values), max(values)] if measured else None
    digits = {"mfu": 4, "train_mfu": 4}
    out = {key: None if value is None else round(value, digits.get(key, 1)) for key, value in med.items()}
    online_keys, online_spread = online_record(online) if online else (dict.fromkeys(ONLINE_KEYS), {})
    spread.update(online_spread)
    rungs = {**serve["rungs"], "online": online["rungs"] if online else None,
             "train": {"noise_bank_mix": {"kernel": "K3", "route": "cuda" if on_card else "plain",
                                          "launches_per_step": mix_launches_per_step},
                       "frontend": "VTLP log-mel in float32 (torch)", "model": "cuDNN (F.conv2d)" if on_card else "F.conv2d"}}
    return {
        "metric": "mel_res8_streaming_realtime_factor",
        "value": out["value"],
        "unit": f"x_realtime_per_{'gpu' if on_card else 'cpu'}_chip",
        "vs_baseline": round(med["value"] / 1000.0, 3),
        "mfu": out["mfu"],
        "legacy_realtime_factor": out["legacy_realtime_factor"],
        **{key: online_keys[key] for key in ONLINE_KEYS},
        "train_examples_per_sec": out["train_examples_per_sec"],
        "train_mfu": out["train_mfu"],
        "train_noise_examples_per_sec": out["train_noise_examples_per_sec"],
        "train_examples_per_sec_f32": out["train_examples_per_sec_f32"],
        "spread": spread,
        "rungs": rungs,
        "device": device,
    }


def run(dev, sizes: Sizes, repeats: int, seed: int) -> dict:
    """Measure and return the bench's record (see the module's docstring)."""
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda

    on_card = dev.type == "cuda"
    peak = peak_bf16_flops(torch.cuda.get_device_name(dev)) if on_card else None
    if on_card and peak is None:
        print(f"mfu, train_mfu: null: no bf16 peak on record for {torch.cuda.get_device_name(dev)!r}", file=sys.stderr)
    serve = bench_serving(dev, sizes, repeats, seed)
    state = res8_variables_to_state_dict(res8_numpy_variables(np.random.default_rng(seed), NUM_LABELS))
    online = bench_online(dev, sizes, repeats, seed, state)  # the serving weights
    mix_noise_bank_cuda.launches = 0
    train = bench_train_step(dev, sizes, repeats, seed)
    noise_steps = 1 + repeats * sizes.train_steps  # the warm-up and the chains
    return make_record(serve, train, sizes, on_card, peak, mix_noise_bank_cuda.launches / noise_steps,
                       card_line() if on_card else None, online)


def main(argv=None) -> dict:
    from howl_tpu_torch.tools._study import device_parser, pick_device

    p = device_parser(__doc__)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = run(dev, CARD if dev.type == "cuda" else CPU, args.repeats, args.seed)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
