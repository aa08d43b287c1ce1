"""mobilenet-hey-ff: the port's engines for this configuration, its plain
reference and its FLOP count (``mobilenet-hey-ff.json`` holds the sizes)."""

import torch

from benchmark import port
from benchmark.reference import logmel, mobilenet
from benchmark.reference.lower import fp8, identity

BLOCK = 1024  # windows the reference scores at once


def model(cfg: dict):
    """The program's MobileNetV2 classifier at the file's width."""
    from howl_tpu_torch.models import create_model

    return create_model(cfg["model"], num_labels=cfg["num_labels"], width_mult=cfg["width_mult"])


def calibration_audio(cfg: dict, first_batch: torch.Tensor):
    return None


def offline_engine(cfg: dict, weights: dict, calibration, device):
    """``StreamingEngine`` on the per-window scorer (K1 "fm" at the "bf16"
    grade, the model on every window in chunks), bf16."""
    from howl_tpu_torch.inference import StreamingEngine

    a = cfg["audio"]
    return StreamingEngine(model(cfg), weights, port.engine_config(cfg), port.frontend_config(cfg),
                           a["zmuv_mean"], a["zmuv_std"], compute_dtype=port.compute_dtype(cfg),
                           frontend_precision=cfg["precision"]["frontend_grade"], device=device)


def live_engine(cfg: dict, weights: dict, streams: int, device):
    """``OnlineEngine``: every stream's whole window through K1 and the model each hop, bf16."""
    from howl_tpu_torch.inference.online import OnlineEngine

    a = cfg["audio"]
    return OnlineEngine(model(cfg), weights, port.engine_config(cfg), port.frontend_config(cfg),
                        a["zmuv_mean"], a["zmuv_std"], num_streams=streams, compute_dtype=port.compute_dtype(cfg),
                        dft_precision=cfg["precision"]["frontend_grade"], device=device)


def live_posteriors(engine):
    """The last hop's posteriors on the device, read from the model's logits
    by a forward hook (the engine keeps none), and no lag."""
    seen = {}
    engine.model.register_forward_hook(lambda module, args, out: seen.__setitem__("logits", out))
    return (lambda: torch.softmax(seen["logits"].float(), dim=-1)), 0


def push(engine, audio) -> None:
    engine.ingest(audio)


def preroll_samples(cfg: dict) -> int:
    return 0


def _windows(mels: torch.Tensor, g: dict, n_windows: int) -> torch.Tensor:
    """(R, F, T) log-mels -> (R * n_windows, F, window frames): window k its frames [k * S, + window frames)."""
    idx = (torch.arange(n_windows, device=mels.device)[:, None] * g["stride_frames"]
           + torch.arange(g["window_frames"], device=mels.device)[None, :])
    return mels[:, :, idx].permute(0, 2, 1, 3).reshape(-1, mels.shape[1], g["window_frames"])


def _n_windows(cfg: dict, samples: int) -> int:
    g = cfg["geometry"]
    return max((samples // cfg["audio"]["hop_length"] + 1 - g["window_frames"]) // g["stride_frames"] + 1, 1)


@torch.no_grad()
def fit_weights(cfg: dict, weights: dict, audio: torch.Tensor) -> None:
    """Each depthwise kernel made the identity tap plus ``depthwise_random_share``
    of its random draw, then the BatchNorm statistics and the classifier
    fitted on the windows of ``audio`` (``reference.mobilenet.fit_weights``).
    Wholly random depthwise kernels make the random network chaotic: a
    rounding of its activations moves its posteriors nearly as far as fp8
    does, and no comparison could tell the two apart."""
    share = cfg["weights"]["depthwise_random_share"]
    for key, v in weights.items():
        if key.startswith("blocks.") and v.ndim == 4 and v.shape[1] == 1:  # a depthwise 3x3 kernel
            v.mul_(share)[:, 0, 1, 1] += 1.0
    mels = logmel.log_mels(audio, cfg["audio"])
    windows = _windows(mels, cfg["geometry"], _n_windows(cfg, audio.shape[1]))
    mobilenet.fit_weights(windows, weights, cfg["weights"]["logit_spread"])


@torch.no_grad()
def reference(cfg: dict, weights: dict, path: str, audio: torch.Tensor, n_windows: int, calibration=None,
              control: bool = False) -> torch.Tensor:
    """(R, samples) recordings or windows -> (R, n_windows, L) posteriors:
    log-mels of the whole recording, window k its frames [k * S, + window
    frames), each window through MobileNetV2 in float32. The control, one
    precision below the configuration's: every value the bf16 path stores
    rounded to fp8 (the audio, the power, the log-mels, each conv's input,
    weights and output, BatchNorm's parameters and output, the residual sums,
    the classifier's input and weights)."""
    g, rnd = cfg["geometry"], (fp8 if control else identity)
    windows = _windows(logmel.log_mels(audio, cfg["audio"], rnd), g, n_windows)
    logits = torch.cat([mobilenet.logits(windows[i : i + BLOCK], weights, rnd)
                        for i in range(0, windows.shape[0], BLOCK)])
    return torch.softmax(logits, dim=-1).reshape(audio.shape[0], n_windows, -1)


def frontend_flops(cfg: dict, frames: int) -> float:
    a = cfg["audio"]
    n_freqs = a["n_fft"] // 2 + 1
    return 2.0 * frames * (2 * a["n_fft"] * n_freqs + n_freqs * a["n_mels"])


def flops_per_window(cfg: dict) -> float:
    return float(mobilenet.flops_per_window(cfg["audio"]["n_mels"], cfg["geometry"]["window_frames"],
                                            cfg["num_labels"]))


def flops_per_recording(cfg: dict, samples: int, n_windows: int) -> float:
    """The frontend over the recording's frames and one forward pass per window (decision)."""
    return frontend_flops(cfg, samples // cfg["audio"]["hop_length"] + 1) + n_windows * flops_per_window(cfg)


def flops_per_hop(cfg: dict) -> float:
    """One stream's hop: the frontend over its whole window and one forward pass."""
    return frontend_flops(cfg, cfg["geometry"]["window_frames"]) + flops_per_window(cfg)
