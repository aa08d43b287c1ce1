"""Smoke run of the PyTorch + CUDA port (howl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them. In order it:

  1. prints the card's ``nvidia-smi`` name and power limit;
  2. builds the hand-written kernels from ``howl_tpu_torch/csrc`` (nvcc,
     sm_90a) and prints the build time;
  3. holds the log-mel frontend kernel against its plain PyTorch version at
     the main path's shape, B=512 x 128,000 samples, 40 mels, in every
     precision grade with float32 and bf16 output, plus one "fm" case;
  4. holds the res8 stem kernel against its plain version on (512, 641, 40)
     mels in bf16 and float32;
  5. drives the main path: ``StreamingEngine.infer_batch`` with a res8 made
     from seeded numpy weights, in bf16, on 512 clips of 8 s. The kernels'
     launch counts are zeroed just before and read just after; both must
     have grown. Its decisions must equal the float32 engine's on the same
     card, on a batch where some clips fire and some do not. Then it times
     a batch (CUDA events, after warm-up) and prints the realtime factor;
  6. prints one JSON line with each kernel's launches, error and times
     beside its plain version's, then the device line last.

Float32 matrix products and convolutions run in full float32 here (TF32 off)
so the plain versions are float32 references.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

BATCH = 512
CLIP_SECONDS = 8.0
SAMPLE_RATE = 16000
N_MELS = 40
SEED = 0


def _cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = _cuda_ms(plain, iters)
    k1 = _cuda_ms(kernel, iters)
    k2 = _cuda_ms(kernel, iters)
    p2 = _cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the magnitude of max |x| (8 significant bits)."""
    top = float(x.float().abs().max())
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def check_frontend(audio, cfg, zmuv) -> dict:
    """Kernel vs plain log-mel frontend in every grade; returns the record of
    the main path's case (grade "bf16", bf16 output, "tm")."""
    import torch

    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda, log_mel_spectrogram_plain

    mean, std = zmuv
    cases = [(g, d, "tm") for g in ("f32", "bf16x2", "bf16") for d in (torch.float32, torch.bfloat16)]
    cases.append(("bf16", torch.float32, "fm"))
    record = None
    for grade, out_dtype, layout in cases:
        kw = dict(precision=grade, out_dtype=out_dtype, layout=layout)
        got = log_mel_spectrogram_cuda(audio, cfg, mean, std, **kw)
        ref = log_mel_spectrogram_plain(audio, cfg, mean, std, **kw)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"K1 {grade}/{out_dtype}/{layout}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
        err = float((got.float() - ref.float()).abs().max())
        # the tests' bounds: f32 1e-3/std; bf16 operand grades 2e-2/std (a
        # float32 sum-order difference can flip one bf16 rounding of the
        # power); bf16 output adds one bf16 ulp of its magnitude for the
        # same reason at the final rounding
        tol = (1e-3 if grade == "f32" else 2e-2) / std
        if out_dtype == torch.bfloat16:
            tol += _bf16_ulp(ref)
        finite = bool(torch.isfinite(got.float()).all())
        print(f"K1 {grade:6s} out={str(out_dtype)[6:]:8s} {layout}: max_abs_err={err:.3e} tol={tol:.3e} finite={finite}")
        if not (finite and err <= tol):
            raise AssertionError(f"K1 {grade}/{out_dtype}/{layout} disagrees with its plain version")
        if (grade, out_dtype, layout) == ("bf16", torch.bfloat16, "tm"):
            kernel_ms, plain_ms = _ab_ms(
                lambda: log_mel_spectrogram_plain(audio, cfg, mean, std, **kw),
                lambda: log_mel_spectrogram_cuda(audio, cfg, mean, std, **kw),
                iters=5,
            )
            record = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "mel": got}
            print(f"K1 main-path case: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms per batch")
    return record


def check_stem(mel_bf16, taps) -> dict:
    """Kernel vs plain res8 stem in bf16 and float32; returns the bf16 record."""
    import torch

    from howl_tpu_torch.ops.frontend import round_bf16
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain

    record = None
    for dtype in (torch.bfloat16, torch.float32):
        mel = mel_bf16.to(dtype).contiguous()
        w = round_bf16(taps) if dtype == torch.bfloat16 else taps
        got = res8_stem_cuda(mel, w)
        ref = res8_stem_plain(mel, w)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"K2 {dtype}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
        err = float((got.float() - ref.float()).abs().max())
        tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5
        finite = bool(torch.isfinite(got.float()).all())
        print(f"K2 {str(dtype)[6:]:8s} {tuple(mel.shape)} -> {tuple(got.shape)}: max_abs_err={err:.3e} tol={tol:.3e} finite={finite}")
        if not (finite and err <= tol):
            raise AssertionError(f"K2 {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            kernel_ms, plain_ms = _ab_ms(lambda: res8_stem_plain(mel, w), lambda: res8_stem_cuda(mel, w), iters=10)
            record = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}
            print(f"K2 main-path case: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms per batch")
    return record


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


def smoke_audio(rng: np.random.Generator, batch: int, samples: int) -> np.ndarray:
    """Half loud tones over noise, half quiet noise: inputs far enough apart
    that a random res8 labels them differently, so some clips fire."""
    t = np.arange(samples) / SAMPLE_RATE
    freqs = rng.uniform(200.0, 4000.0, batch)[:, None]
    tones = 0.5 * np.sin(2 * np.pi * freqs * t[None, :])
    noise = rng.standard_normal((batch, samples))
    loud = np.arange(batch)[:, None] < batch // 2
    return np.where(loud, tones + 0.05 * noise, 0.002 * noise).astype(np.float32)


def firing_config(probs, base_cfg):
    """A one-word sequence on the loud half's most frequent top label, with
    the threshold midway between the quiet half's highest and the loud
    half's lowest peak posterior, so the batch splits."""
    half, num = probs.shape[0] // 2, probs.shape[-1]
    k = int(np.bincount(probs[:half].argmax(-1).ravel(), minlength=num).argmax())
    peak = probs.max(-1).max(-1)  # (B,) highest posterior of each clip
    quiet, loud = float(peak[half:].max()), float(peak[:half].min())
    if loud <= quiet:
        raise AssertionError(f"loud and quiet clips' peak posteriors overlap: {loud:.4f} <= {quiet:.4f}")
    print(f"firing config: word label {k}, threshold between peaks {quiet:.4f} and {loud:.4f}")
    return dataclasses.replace(
        base_cfg, inference_sequence=(k,), negative_label=(k + 1) % num,
        inference_threshold=(quiet + loud) / 2,
    )


def drive_main_path(dev, batch: int, clip_seconds: float) -> dict:
    import torch

    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    rng = np.random.default_rng(SEED + 1)
    num_labels = 4
    frontend = FrontendConfig(n_mels=N_MELS)
    base_cfg = EngineConfig(
        inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
        negative_label=3, num_labels=num_labels, sample_rate=SAMPLE_RATE,
    )
    model = create_model("res8", num_labels=num_labels)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, num_labels))
    samples = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy(smoke_audio(rng, batch, samples)).to(dev)

    def engine(cfg, dtype):
        return StreamingEngine(
            model, state, cfg, frontend, zmuv_mean=-6.0, zmuv_std=4.0, compute_dtype=dtype, device=dev
        )

    probe = engine(base_cfg, None).score_batch(audio)["probs"].cpu().numpy()
    cfg = firing_config(probe, base_cfg)
    f32, bf16 = engine(cfg, None), engine(cfg, torch.bfloat16)
    ref = f32.infer_batch(audio)

    log_mel_spectrogram_cuda.launches = 0
    res8_stem_cuda.launches = 0
    out = bf16.infer_batch(audio)
    torch.cuda.synchronize()
    launches = {"k1": log_mel_spectrogram_cuda.launches, "k2": res8_stem_cuda.launches}
    print(f"main path launches: frontend kernel {launches['k1']}, stem kernel {launches['k2']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")

    probs = out["probs"]
    n_win = bf16.n_windows(samples)
    if tuple(probs.shape) != (batch, n_win, num_labels) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"posteriors of shape {tuple(probs.shape)}, finite={bool(torch.isfinite(probs).all())}")
    if float((probs.sum(-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("posteriors do not sum to 1")
    fired = int(ref["detected"].sum())
    print(f"f32 engine: {fired}/{batch} clips fire on sequence {cfg.inference_sequence}")
    if not 0 < fired < batch:
        raise AssertionError("the decision check needs a batch where some clips fire and some do not")
    for key in ("detected", "first_fire_step", "labels"):
        if not torch.equal(out[key].cpu(), ref[key].cpu()):
            diff = int((out[key].cpu() != ref[key].cpu()).sum())
            raise AssertionError(f"bf16 {key} differ from the f32 engine's in {diff} places")
    prob_err = float((probs - ref["probs"]).abs().max())
    print(f"bf16 vs f32 engine: decisions equal; max |dprob| = {prob_err:.3e}")

    batch_ms = _cuda_ms(lambda: bf16.infer_batch(audio), iters=10)
    rtf = batch * clip_seconds / (batch_ms / 1000.0)
    print(f"main path: {batch_ms:.3f} ms per batch of {batch} x {clip_seconds:g} s; realtime factor {rtf:.1f}")
    return {"launches": launches, "batch_ms": batch_ms, "realtime_factor": rtf}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    from howl_tpu_torch.ops import _build
    from howl_tpu_torch.ops.frontend import FrontendConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.kernel_library()
    print(f"built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    samples = int(CLIP_SECONDS * SAMPLE_RATE)
    audio = torch.randn((BATCH, samples), generator=gen, device=dev) * 0.1
    cfg = FrontendConfig(n_mels=N_MELS)
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_plain

    ref = log_mel_spectrogram_plain(audio, cfg)
    zmuv = (float(ref.mean()), float(ref.std()))
    del ref
    k1 = check_frontend(audio, cfg, zmuv)
    taps = torch.randn((3, 3, 45), generator=gen, device=dev) / 3.0
    k2 = check_stem(k1.pop("mel"), taps)
    del audio
    main_path = drive_main_path(dev, BATCH, CLIP_SECONDS)

    kernels = [
        {
            "name": "log_mel_frontend", "route": "cuda", "source": "howl_tpu_torch/csrc/frontend.cu",
            "replaces": "howl_tpu/ops/frontend_pallas.py:119", "launches": main_path["launches"]["k1"], **k1,
        },
        {
            "name": "res8_stem", "route": "cuda", "source": "howl_tpu_torch/csrc/stem.cu",
            "replaces": "howl_tpu/ops/stem_pallas.py:89", "launches": main_path["launches"]["k2"], **k2,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
