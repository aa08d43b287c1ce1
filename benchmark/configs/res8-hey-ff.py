"""res8-hey-ff: the port's engines for this configuration, its plain
reference and its FLOP count (``res8-hey-ff.json`` holds the sizes)."""

import torch

from benchmark import port
from benchmark.reference import logmel, res8
from benchmark.reference.lower import fp8, identity

BLOCK = 8  # recordings the reference scores at once


def model(cfg: dict):
    """The program's res8 at the file's widths."""
    from howl_tpu_torch.models import create_model

    return create_model(cfg["model"], num_labels=cfg["num_labels"], num_maps=cfg["num_maps"],
                        pooling=tuple(cfg["pooling"]))


def calibration_audio(cfg: dict, first_batch: torch.Tensor):
    """The recordings the int8 trunk is calibrated on: the first batch's first ones."""
    return first_batch[: cfg["precision"]["int8_calibration_clips"]]


def offline_engine(cfg: dict, weights: dict, calibration: torch.Tensor, device):
    """``StreamingEngine`` on the fused-trunk scorer, bf16, K1 at the "bf16"
    grade, with the int8 residual trunk calibrated on ``calibration``."""
    from howl_tpu_torch.inference import StreamingEngine

    a, int8 = cfg["audio"], cfg["precision"]["offline_trunk"] == "int8"
    return StreamingEngine(model(cfg), weights, port.engine_config(cfg), port.frontend_config(cfg),
                           a["zmuv_mean"], a["zmuv_std"], compute_dtype=port.compute_dtype(cfg), fused_trunk=True,
                           frontend_precision=cfg["precision"]["frontend_grade"], use_int8_trunk=int8,
                           int8_calibration_audio=calibration if int8 else None, device=device)


def live_engine(cfg: dict, weights: dict, streams: int, device):
    """``FusedStreamingOnlineEngine``: per-layer trunk rings, bf16, one hop a push."""
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine

    a = cfg["audio"]
    return FusedStreamingOnlineEngine(model(cfg), weights, port.engine_config(cfg), port.frontend_config(cfg),
                                      a["zmuv_mean"], a["zmuv_std"], num_streams=streams,
                                      compute_dtype=port.compute_dtype(cfg), hop_block=cfg["live"]["hop_block"],
                                      dft_precision=cfg["precision"]["frontend_grade"], device=device)


def live_posteriors(engine):
    """The last push's posteriors on the device, (streams, labels), and the
    hops by which a window's decision trails its audio."""
    return (lambda: engine.last_probs), engine.schedule.lag


def push(engine, audio) -> None:
    engine.push(audio)


def preroll_samples(cfg: dict) -> int:
    """The silence a live stream starts from: one window of mel hops."""
    return cfg["geometry"]["window_frames"] * cfg["audio"]["hop_length"]


@torch.no_grad()
def fit_weights(cfg: dict, weights: dict, audio: torch.Tensor) -> None:
    """BatchNorm statistics and the head fitted on ``audio`` (``reference.res8.fit_weights``)."""
    res8.fit_weights(logmel.log_mels(audio, cfg["audio"]), weights, cfg, cfg["weights"]["logit_spread"])


def _blocks(audio: torch.Tensor):
    return [audio[i : i + BLOCK] for i in range(0, audio.shape[0], BLOCK)]


@torch.no_grad()
def reference(cfg: dict, weights: dict, path: str, audio: torch.Tensor, n_windows: int, calibration=None,
              control: bool = False) -> torch.Tensor:
    """(R, samples) recordings -> (R, n_windows, L) posteriors of the plain
    reference, float32. Offline with the int8 trunk its activation scales
    are calibrated again from ``calibration``. The control, one precision
    below the configuration's: every value the bf16 path stores rounded to
    fp8 (the audio, the power, the log-mels, each conv's input, weights and
    output, the residual sums, BatchNorm's statistics and output, the head's
    input and weights), and the int8 trunk in int4."""
    a = cfg["audio"]
    int8 = path == "offline" and cfg["precision"]["offline_trunk"] == "int8"
    levels = 7 if control else 127
    rnd = fp8 if control else identity
    scales = None
    if int8:
        stems = [res8.stem(logmel.log_mels(b, a), weights, cfg["pooling"]) for b in _blocks(calibration)]
        scales = res8.calibrate(stems, weights, levels, cfg["precision"]["int8_margin"])
        del stems
    return torch.cat([res8.score(logmel.log_mels(b, a, rnd), weights, cfg, n_windows, scales, levels, rnd)
                      for b in _blocks(audio)])


def _flops(cfg: dict, frames: float, pooled: float, windows: float) -> float:
    """res8's least work, term by term as the program's bench counts a clip
    (``path_flops_per_clip``): the windowed DFT and the mel product of every
    frame, conv0 on every mel, the six residual convs on every pooled
    position, the head of every window; 2 FLOPs a multiply-add."""
    a, maps = cfg["audio"], cfg["num_maps"]
    n_freqs = a["n_fft"] // 2 + 1
    frontend = frames * (2 * a["n_fft"] * n_freqs + n_freqs * a["n_mels"])
    conv0 = frames * a["n_mels"] * maps * 9
    trunk = pooled * (a["n_mels"] // cfg["pooling"][1]) * maps * maps * 9 * cfg["residual_layers"]
    return 2 * (frontend + conv0 + trunk + windows * maps * cfg["num_labels"])


def flops_per_recording(cfg: dict, samples: int, n_windows: int) -> float:
    frames = samples // cfg["audio"]["hop_length"] + 1
    return _flops(cfg, frames, frames // cfg["pooling"][0], n_windows)


def flops_per_audio_second(cfg: dict) -> float:
    frames = cfg["audio"]["sample_rate"] / cfg["audio"]["hop_length"]
    return _flops(cfg, frames, frames / cfg["pooling"][0], 1000.0 / cfg["geometry"]["stride_ms"])


def flops_per_hop(cfg: dict) -> float:
    """The least the streaming engine computes for one stream's hop: a hop's share of a second."""
    return flops_per_audio_second(cfg) * cfg["geometry"]["stride_ms"] / 1000.0
