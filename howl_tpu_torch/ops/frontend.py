"""Log-mel audio frontend: geometry, the numpy basis builders, and the plain
PyTorch log-mel chain (counterpart of ``howl_tpu/ops/frontend.py``).

The numpy builders (``mel_filterbank``, ``windowed_dft_matrix``,
``nyquist_crop_bins``, ``_hann_window``) are restated from the JAX package
line for line, so both packages project onto bit-identical bases
(tests/test_torch_frontend.py checks ``np.array_equal``).

``log_mel_spectrogram`` frames the audio and runs the windowed DFT as two
matrix products, power, then the mel product and the log: the twin of the
JAX chain's ``_mel_core`` in its f32 grade (``precision=None``) and its
``"bf16"`` grade (operands rounded to bf16, f32 accumulation). The fused
kernel of this chain lives in ``frontend_cuda.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def hz_to_mel(f):
    """HTK mel scale (torchaudio MelSpectrogram default)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max: float = None
) -> np.ndarray:
    """Triangular HTK-mel filterbank, shape (n_freqs, n_mels), no normalization."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _hann_window(n: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def nyquist_crop_bins(config: "FrontendConfig") -> int:
    """Number of DFT bins the mel projection actually reads.

    For even ``n_fft`` the top mel triangle ends exactly at the Nyquist
    frequency, so the Nyquist bin's filterbank weight is identically zero and
    bin ``n_fft // 2`` can be dropped: 256 bins at the default geometry. An
    ``f_max`` above Nyquist would drop real energy, so it keeps every bin.
    """
    if config.f_max is not None and config.f_max > config.sample_rate / 2:
        return config.n_freqs
    return config.n_fft // 2 if config.n_fft % 2 == 0 else config.n_freqs


def windowed_dft_matrix(n_fft: int, n_bins: int) -> np.ndarray:
    """Combined windowed real-DFT basis, shape (n_fft, 2*n_bins).

    Columns are [cos | -sin] pre-multiplied by the periodic Hann window
    (built in float64, cast once), so ``frames @ W`` yields [re | im] of the
    windowed rfft in one product.
    """
    t = np.arange(n_fft, dtype=np.float64)[:, None] * np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    m = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * win[:, None]
    return np.ascontiguousarray(m).astype(np.float32)


@dataclass(frozen=True)
class FrontendConfig:
    """Geometry of the log-mel frontend (the JAX package's defaults)."""

    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 200
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = None
    center: bool = True
    log_offset: float = 1e-7

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            return num_samples // self.hop_length + 1
        return max((num_samples - self.n_fft) // self.hop_length + 1, 0)

    def compute_lengths(self, lengths):
        """Frame-length formula sequential models use for packing:
        ``(len - n_fft) // hop + 1``."""
        return (torch.as_tensor(lengths) - self.n_fft) // self.hop_length + 1


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value (ties to even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def center_pad(audio: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """(B, S) -> (B, S + n_fft) reflect padding when ``config.center``."""
    if not config.center:
        return audio
    pad = config.n_fft // 2
    return torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]


def log_mel_spectrogram(audio: torch.Tensor, config: FrontendConfig = FrontendConfig(), precision=None):
    """(B, samples) float32 -> (B, n_mels, frames) log-mel spectrogram.

    ``precision=None`` computes in float32 throughout. ``"bf16"`` rounds the
    audio, the DFT basis, the power and the filterbank to bf16 and
    accumulates in float32, as the JAX chain's 1-pass mode does.
    """
    if precision not in (None, "bf16"):
        raise ValueError(f"unsupported frontend precision {precision!r}: expected None or 'bf16'")
    rnd = round_bf16 if precision == "bf16" else (lambda x: x)
    dev = audio.device
    audio = rnd(audio.to(torch.float32))
    frames = center_pad(audio, config).unfold(-1, config.n_fft, config.hop_length)  # (B, T, n_fft)
    n_bins = nyquist_crop_bins(config)
    w = rnd(torch.from_numpy(windowed_dft_matrix(config.n_fft, n_bins)).to(dev))
    fb = mel_filterbank(config.n_freqs, config.n_mels, config.sample_rate, config.f_min, config.f_max)
    fb = rnd(torch.from_numpy(fb[:n_bins]).to(dev))
    re = frames @ w[:, :n_bins]
    im = frames @ w[:, n_bins:]
    mel = rnd(re * re + im * im) @ fb  # (B, T, n_mels)
    return torch.log(mel + config.log_offset).transpose(-1, -2)
