"""The hardware decision gate: the port's fast serving engines against its
exact engine, on the card (counterpart of ``tools/validate_tpu_decisions.py``).

    python -m howl_tpu_torch.tools.validate_tpu_decisions [--device cuda]

CPU tests cannot run the CUDA kernels, so this is their decision-level
check: each row scores the same clips (16 x 4 s of seeded noise, threshold
0.35, the JAX tool's setup) with an exact engine and a fast one and
compares detections, first-fire steps and per-step labels. A row is OK when
the detections and the first-fire steps are equal and at least 99 % of the
labels agree.

The exact engine is res8 in float32 with the frontend at its "f32" grade
(on the card ``csrc/frontend_tc.cu``'s six bf16 passes, as the JAX kernel
computes ``Precision.HIGHEST``, where ``frontend_route`` serves it: 40
mels; ``csrc/frontend.cu``'s float32 products elsewhere), where the JAX
tool's oracle is its float32 engine on the XLA chain at HIGHEST. It prints
the route its oracle's frontend takes. The rows:

    res8+k1[bf16]+k2      the bf16 serving engine: the frontend kernel at
                          "bf16" ("tc", ``csrc/frontend_tc.cu``) and the
                          stem kernel ("tc", ``csrc/stem_tc.cu``);
    res8+k1[bf16x2]+k2    the same with the frontend at "bf16x2";
    res8+k1[bf16x3]+k2    the same with the frontend at the three-pass
                          grade, the JAX kernel's default (``precision=None``),
                          on the tensor-core kernel too ("tc", three passes of
                          ``csrc/frontend_tc.cu``'s ring);
    res8+k1[bf16]+k2+int8 the bf16 serving engine with the int8 residual
                          trunk (``csrc/int8_trunk.cu``), its scales
                          calibrated on the clips it scores, as the JAX
                          tool's row calibrates (the best case: a deployment
                          calibrates on held-out audio and validates again);
    res8 legacy[bf16]     the per-window mega-batch scorer in bf16 against
                          the same scorer in float32;
    res8+online[bf16]     the live engines serving in bf16, their frontend
    res8+trunk[bf16]      at the 1-pass "bf16" grade against the same
    res8+full-window[bf16]  engine with its frontend pinned to the exact
                          "f32" grade, as the JAX tool's rows pin HIGHEST,
                          on the same streams pushed hop by hop:
                          ``IncrementalOnlineEngine``,
                          ``FusedStreamingOnlineEngine`` and
                          ``OnlineEngine`` (a window ending at every hop).
                          The JAX tool's rule for these rows: every hop's
                          fire flags equal, at least 99 % of the labels.

    small-cnn, lstm,      the other families of the JAX tool's list: each
    gru, las, mobilenet   scores the same batch with its exact float32
                          engine (the frontend at "f32"; las's stacked chain
                          is float32 either way) and its bf16 engine (the
                          frontend at "bf16"), on seeded numpy weights
                          carried across by ``compat`` and on
                          ``family_audio``'s clips, at the word and threshold
                          ``family_setup`` picks from the float32
                          posteriors, every decision 0.01 from flipping.

``family_setup`` is shared with ``chip_smoke.py``: random weights in flax's
initialization give every clip nearly the same posteriors through a deep
net (MobileNet's), or posteriors so chaotic that bf16 rounding moves them by
0.1 (MobileNet's at twice the variance), so each family's kernel variance
and seed are fixed in ``FAMILY_WEIGHTS``, chosen once from float32 scores.
The family rows see eight distinct clips, ``family_audio``'s kinds, however
large the batch: with random weights, clips that differ more (tones of
other pitches and levels, noise that does not repeat) leave no threshold
that a margin keeps off every decision's edge.

It runs on the card: with ``--device cuda`` (the default) and no CUDA
device it raises. ``--device cpu`` runs the plain versions at 4 clips of
2 s. ``main`` returns the exit code: 0 when every row is OK.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from howl_tpu_torch.tools._study import CPU_SIZE, device_parser, pick_device

FAMILIES = ("small-cnn", "lstm", "gru", "las", "mobilenet")
THRESHOLD = 0.35
CARD_SIZE = (16, 4.0)  # clips, seconds: the JAX tool's
FAMILY_MARGIN = 0.01  # how far from flipping the family rows' decisions are picked
# (kernel gain, seed) of each family's weights: the kernels' standard deviation in units of flax's lecun-normal,
# and the numpy seed. Chosen once, on float32 scores of ``family_audio``'s clips, as weights whose posteriors a
# margin splits at every batch size the tools use
FAMILY_WEIGHTS = {"small-cnn": (1.2, 1), "seq-cnn": (1.3, 1), "mobilenet": (1.2, 2), "lstm": (2.0, 0),
                  "seq-lstm": (2.0, 1), "gru": (1.2, 1), "las": (2.0, 2)}
FAMILY_ZMUV = (-6.0, 4.0)
FAMILY_PERIOD = 160  # samples: one hop at 16 kHz


def compare(exact_out: dict, fast_out: dict) -> dict:
    """The JAX tool's rule: detections equal, first-fire steps equal, label
    agreement at least 0.99."""
    det_eq = torch.equal(exact_out["detected"].cpu(), fast_out["detected"].cpu())
    fire_eq = torch.equal(exact_out["first_fire_step"].cpu(), fast_out["first_fire_step"].cpu())
    lab_frac = float((exact_out["labels"].cpu() == fast_out["labels"].cpu()).double().mean())
    return {"detected_eq": det_eq, "first_fire_eq": fire_eq, "label_agreement": lab_frac,
            "ok": det_eq and fire_eq and lab_frac >= 0.99}


def compare_online(exact: tuple, fast: tuple) -> dict:
    """The JAX tool's rule for the live engines, on (fire flags, labels) per
    hop: the fire flags equal, label agreement at least 0.99."""
    fired_eq = bool(np.array_equal(exact[0], fast[0]))
    lab_frac = float((exact[1] == fast[1]).mean())
    return {"fired_eq": fired_eq, "label_agreement": lab_frac, "ok": fired_eq and lab_frac >= 0.99}


def run_online(kind: str, dev, state, cfg, frontend, audio: torch.Tensor, dft_precision) -> tuple:
    """Push ``audio``'s streams hop by hop through a bf16 live engine
    ("online": incremental, "trunk", "full-window": the window ending at
    each hop) with its frontend at ``dft_precision``; (fire flags, labels),
    each (hops, streams)."""
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine
    from howl_tpu_torch.models import create_model

    cls = {"online": IncrementalOnlineEngine, "trunk": FusedStreamingOnlineEngine, "full-window": OnlineEngine}[kind]
    eng = cls(create_model("res8", num_labels=cfg.num_labels), state, cfg, frontend, num_streams=audio.shape[0],
              compute_dtype=torch.bfloat16, dft_precision=dft_precision, device=dev)
    hop, fired, labels = eng.hop_samples, [], []
    for end in range(hop, audio.shape[1] + 1, hop):
        if kind == "full-window":
            eng.ingest(audio[:, max(0, end - eng.window_samples) : end])
        else:
            eng.push(audio[:, end - hop : end])
        fired.append(eng.last_fired)
        labels.append(eng.last_labels)
    return np.stack(fired), np.stack(labels)


def margin_word_threshold(probs: np.ndarray, margin: float, halves: bool = True) -> dict:
    """A one-word sequence and a threshold that split the streams, from
    per-hop posteriors (T, N, L); a stream fires when the word is its top
    label at or above the threshold at some hop. With ``halves`` the word
    fires on the first half of the streams and not on the second, the
    threshold taken from a grid of 199 between the halves' top posteriors;
    without, some streams fire and some do not, the grid spanning the lowest
    to the highest top posterior. Every hop's decision stays at least
    ``margin`` from flipping (no top posterior within ``margin`` of the
    threshold, no two top labels within ``margin`` at or above it), and of
    the grid the threshold furthest from every top posterior is taken.
    Returns {"word", "threshold", "distance", "fires"}; raises when none
    exists. Decision checks between two precisions or two engines use it so
    that an equality they find is not a coin toss on a near tie."""
    half = probs.shape[1] // 2
    top2 = np.sort(probs, -1)[..., -2:]
    peak, runner_up = top2[..., 1], top2[..., 0]
    tied = peak - runner_up < margin
    best = None
    for word in range(probs.shape[-1]):
        top = np.where(probs.argmax(-1) == word, peak, 0.0).max(0)  # (N,)
        low, high = (float(top[half:].max()), float(top[:half].min())) if halves else (float(peak.min()), float(peak.max()))
        for thr in np.linspace(low, high, 201)[1:-1] if high > low else ():
            fires = top >= thr
            if fires.all() or not fires.any():
                continue
            distance = float(np.abs(peak - thr).min())
            if distance >= margin and not tied[peak >= thr - margin].any():
                if best is None or distance > best["distance"]:
                    best = {"word": word, "threshold": float(thr), "distance": distance, "fires": int(fires.sum())}
    if best is None:
        raise ValueError(f"no word and threshold split the streams with a margin of {margin}")
    return best


def family_audio(batch: int, samples: int, seed: int = 0) -> np.ndarray:
    """(batch, samples) clips of eight kinds in turn, loud and quiet: a tone
    of 500, 1000, 1500 or 3000 Hz at 0.5 over a buzz at 0.05, or a buzz at
    0.002. Each buzz is a seeded noise segment of one hop repeated, and each
    tone a whole number of cycles a hop, so a clip repeats with the hop:
    all its full windows, and a sequential model's frames once its state
    settles, score alike. The posteriors then come in clusters that a
    margin-picked threshold can split; clips of a kind are the same clip,
    so a batch holds at most eight distinct clips."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    reps = -(-samples // FAMILY_PERIOD)

    def buzz(level):
        return level * np.tile(rng.standard_normal(FAMILY_PERIOD), reps)[:samples]

    kinds = []
    for f in (500.0, 1000.0, 1500.0, 3000.0):
        kinds += [0.5 * np.sin(2 * np.pi * f * t) + buzz(0.05), buzz(0.002)]
    return np.stack([kinds[i % len(kinds)] for i in range(batch)]).astype(np.float32)


def family_engine(name: str, state, cfg, frontend, dev, compute_dtype=None, frontend_precision="auto", **kw):
    """The engine a family serves with: ``WholeClipEngine`` for a sequential
    model, else ``StreamingEngine``."""
    from howl_tpu_torch.inference import StreamingEngine, WholeClipEngine
    from howl_tpu_torch.models import create_model, model_spec

    cls = WholeClipEngine if model_spec(name).is_sequential else StreamingEngine
    return cls(create_model(name, num_labels=cfg.num_labels), state, cfg, frontend, *FAMILY_ZMUV,
               compute_dtype=compute_dtype, frontend_precision=frontend_precision, device=dev, **kw)


def family_setup(name: str, cfg, frontend, dev, audio) -> tuple:
    """(state dict, config, pick) for a family's decision checks: the seeded
    numpy weights of ``FAMILY_WEIGHTS`` (``compat.numpy_variables``), and
    the word and threshold that ``margin_word_threshold`` picks, without
    halves, from the exact float32 engine's posteriors on ``audio``. Its
    margin is the larger of ``FAMILY_MARGIN`` and twice the largest
    posterior that rounding the weights to bf16 moves on ``audio``'s first
    16 clips (the float32 engine on both). No bf16 result enters the pick.
    Raises when no word and threshold split the clips at that margin."""
    from howl_tpu_torch.compat import numpy_variables, variables_to_state_dict
    from howl_tpu_torch.inference.config import cast_compute_dtype

    def probs(state, clips):
        eng = family_engine(name, state, cfg, frontend, dev, frontend_precision="f32")
        return eng.score_batch(clips)["probs"].cpu().numpy().transpose(1, 0, 2)

    gain, seed = FAMILY_WEIGHTS[name]
    state = variables_to_state_dict(name, numpy_variables(name, cfg.num_labels, np.random.default_rng(seed),
                                                          kernel_gain=gain))
    rounded = {k: cast_compute_dtype({k: v}, torch.bfloat16)[k].to(v.dtype) for k, v in state.items()}
    margin = max(FAMILY_MARGIN, 2 * float(np.abs(probs(state, audio[:16]) - probs(rounded, audio[:16])).max()))
    pick = margin_word_threshold(probs(state, audio), margin, halves=False)
    word = pick["word"]
    cfg = dataclasses.replace(cfg, inference_sequence=(word,), negative_label=(word + 1) % cfg.num_labels,
                              inference_threshold=pick["threshold"])
    return state, cfg, {"gain": gain, "seed": seed, "margin": margin, **pick}


def run(dev: torch.device, batch: int, clip_seconds: float, seed: int = 0) -> dict:
    """{row tag: record}, each record with ``ok`` True or False."""
    from howl_tpu_torch.bench import res8_numpy_variables, serving_config
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import frontend_route

    cfg = dataclasses.replace(serving_config(), inference_threshold=THRESHOLD)
    frontend = FrontendConfig(n_mels=40)
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        (rng.standard_normal((batch, int(clip_seconds * cfg.sample_rate))) * 0.1).astype(np.float32)).to(dev)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, cfg.num_labels))

    def engine(dtype=None, frontend_precision="bf16", **kw):  # every row names its grade; the exact engine "f32"
        return StreamingEngine(create_model("res8", num_labels=cfg.num_labels), state, cfg, frontend,
                               compute_dtype=dtype, frontend_precision=frontend_precision, device=dev, **kw)

    bf16 = torch.bfloat16
    oracle_route = frontend_route(frontend, "f32") if dev.type == "cuda" else "plain"
    print(f"oracle: res8 in float32, the frontend at the exact grade 'f32' on route {oracle_route!r}", flush=True)
    exact = engine(frontend_precision="f32").infer_batch(audio)
    rows = {
        "res8+k1[bf16]+k2": compare(exact, engine(bf16).infer_batch(audio)),
        "res8+k1[bf16x2]+k2": compare(exact, engine(bf16, frontend_precision="bf16x2").infer_batch(audio)),
        "res8+k1[bf16x3]+k2": compare(exact, engine(bf16, frontend_precision="bf16x3").infer_batch(audio)),
        "res8+k1[bf16]+k2+int8": compare(exact, engine(bf16, use_int8_trunk=True,
                                                       int8_calibration_audio=audio).infer_batch(audio)),
        "res8 legacy[bf16]": compare(engine(fused_trunk=False, frontend_precision="f32").infer_batch(audio),
                                     engine(bf16, fused_trunk=False).infer_batch(audio)),
        **{f"res8+{kind}[bf16]": compare_online(run_online(kind, dev, state, cfg, frontend, audio, "f32"),
                                               run_online(kind, dev, state, cfg, frontend, audio, "bf16"))
           for kind in ("online", "trunk", "full-window")},
    }
    fam_audio = torch.from_numpy(family_audio(batch, int(clip_seconds * cfg.sample_rate))).to(dev)
    for name in FAMILIES:
        fam_state, fam_cfg, pick = family_setup(name, cfg, frontend, dev, fam_audio)
        print(f"{name}: seed {pick['seed']}, kernel gain {pick['gain']:.4f}, word {pick['word']}, threshold "
              f"{pick['threshold']:.4f}, {pick['distance']:.4f} from the nearest top posterior (margin "
              f"{pick['margin']:.4f})", flush=True)
        rows[name] = compare(
            family_engine(name, fam_state, fam_cfg, frontend, dev, frontend_precision="f32").infer_batch(fam_audio),
            family_engine(name, fam_state, fam_cfg, frontend, dev, torch.bfloat16, "bf16").infer_batch(fam_audio))
    for tag, rec in rows.items():
        if "fired_eq" in rec:
            print(f"{tag:22s}: fired_eq={rec['fired_eq']} label_agreement={rec['label_agreement']:.4f} -> "
                  f"{'OK' if rec['ok'] else 'MISMATCH'}", flush=True)
        else:
            print(f"{tag:22s}: detected_eq={rec['detected_eq']} first_fire_eq={rec['first_fire_eq']} "
                  f"label_agreement={rec['label_agreement']:.4f} -> {'OK' if rec['ok'] else 'MISMATCH'}", flush=True)
    return rows


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, clip_seconds = CARD_SIZE if dev.type == "cuda" else CPU_SIZE[:2]
    rows = run(dev, batch, clip_seconds, args.seed)
    all_ok = all(rec["ok"] for rec in rows.values())
    print("ALL OK" if all_ok else "MISMATCHES FOUND", flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
