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
(the float32 products, ``csrc/frontend.cu`` on the card), where the JAX
tool's oracle is its float32 engine on the XLA chain at HIGHEST. The rows:

    res8+k1[bf16]+k2      the bf16 serving engine: the frontend kernel at
                          "bf16" ("tc", ``csrc/frontend_tc.cu``) and the
                          stem kernel ("tc", ``csrc/stem_tc.cu``);
    res8+k1[bf16x2]+k2    the same with the frontend at "bf16x2";
    res8+k1[bf16x3]+k2    the same with the frontend at the three-pass
                          grade, the JAX kernel's default (``precision=None``),
                          on the FMA kernel ("fma", ``csrc/frontend.cu``);
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

Rows the port cannot run yet print ``not ported (ROADMAP ...)`` and count
as neither OK nor a mismatch: the other model families (item 8).

It runs on the card: with ``--device cuda`` (the default) and no CUDA
device it raises. ``--device cpu`` runs the plain versions at 4 clips of
2 s. ``main`` returns the exit code: 0 when every row that ran is OK.
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


def margin_word_threshold(probs: np.ndarray, margin: float) -> dict:
    """A one-word sequence that fires on the first half of the streams and
    not on the second, from per-hop posteriors (T, N, L): the word and the
    threshold that keep every hop's decision at least ``margin`` from
    flipping (no top posterior within ``margin`` of the threshold, no two
    top labels within ``margin`` at or above it), the threshold as far from
    every top posterior as a grid of 199 between the halves allows.
    Returns {"word", "threshold", "distance"}; raises when none exists.
    Decision checks between two precisions or two engines use it so that
    an equality they find is not a coin toss on a near tie."""
    half = probs.shape[1] // 2
    top2 = np.sort(probs, -1)[..., -2:]
    peak, runner_up = top2[..., 1], top2[..., 0]
    tied = peak - runner_up < margin
    best = None
    for word in range(probs.shape[-1]):
        top = np.where(probs.argmax(-1) == word, peak, 0.0)  # (T, N)
        quiet, loud = float(top[:, half:].max()), float(top[:, :half].max(0).min())
        for thr in np.linspace(quiet, loud, 201)[1:-1] if loud > quiet else ():
            distance = float(np.abs(peak - thr).min())
            if distance >= margin and not tied[peak >= thr - margin].any():
                if best is None or distance > best["distance"]:
                    best = {"word": word, "threshold": float(thr), "distance": distance}
    if best is None:
        raise ValueError(f"no word and threshold split the streams with a margin of {margin}")
    return best


def not_ported(why: str) -> dict:
    return {"ok": None, "status": f"not ported ({why})"}


def run(dev: torch.device, batch: int, clip_seconds: float, seed: int = 0) -> dict:
    """{row tag: record}; a record that ran has ``ok`` True or False, one
    that did not has ``ok`` None and its ``status``."""
    from howl_tpu_torch.bench import res8_numpy_variables, serving_config
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    cfg = dataclasses.replace(serving_config(), inference_threshold=THRESHOLD)
    frontend = FrontendConfig(n_mels=40)
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        (rng.standard_normal((batch, int(clip_seconds * cfg.sample_rate))) * 0.1).astype(np.float32)).to(dev)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, cfg.num_labels))

    def engine(dtype=None, **kw):
        return StreamingEngine(create_model("res8", num_labels=cfg.num_labels), state, cfg, frontend,
                               compute_dtype=dtype, device=dev, **kw)

    bf16 = torch.bfloat16
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
        **{name: not_ported("ROADMAP Queue 1, item 8") for name in FAMILIES},
    }
    for tag, rec in rows.items():
        if rec["ok"] is None:
            print(f"{tag:22s}: {rec['status']}", flush=True)
        elif "fired_eq" in rec:
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
    all_ok = all(rec["ok"] for rec in rows.values() if rec["ok"] is not None)
    print("ALL OK" if all_ok else "MISMATCHES FOUND", flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
