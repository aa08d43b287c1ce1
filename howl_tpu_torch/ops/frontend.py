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

The train step's featurizer uses the rest: ``log_mel_spectrogram_vtlp``,
whose VTLP filterbank is built in torch from a warp that may be a device
tensor (so a random warp per batch never syncs the host), and
``stack_deltas``/``compute_deltas`` for ``stacked=True``.
"""

from __future__ import annotations

import functools
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


def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: (n_fft, n_freqs) cosine and sine matrices, float32, the
    JAX package's bit for bit. ``|rfft(x)|^2 == (x @ C)^2 + (x @ S)^2``."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None] * np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


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

    @classmethod
    def from_settings(cls) -> "FrontendConfig":
        """The geometry ``SETTINGS.audio_transform`` describes;
        ``use_meyda_spectrogram`` pins f_max at 8 kHz (the browser
        convention), as in the JAX package."""
        from howl_tpu_torch.settings import SETTINGS

        s = SETTINGS.audio_transform
        f_max = 8000.0 if s.use_meyda_spectrogram else None
        return cls(
            sample_rate=s.sample_rate, n_fft=s.num_fft, hop_length=s.hop_length, n_mels=s.num_mels,
            f_max=f_max,
        )

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


def frame_signal(audio: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """(..., samples) -> (..., frames, n_fft), materialised: the center
    reflect-pad when ``config.center``, then frame i = samples [i * hop,
    i * hop + n_fft), built as the JAX package builds it: overlapping row
    slices of the (rows, hop) view plus a remainder slice, concatenated.
    The view's tail is zero-padded up to whole hop rows; no frame reads
    the zeros."""
    hop, n_fft = config.hop_length, config.n_fft
    lead = audio.shape[:-1]
    if config.center:
        pad = n_fft // 2
        flat = audio.reshape(-1, 1, audio.shape[-1])  # reflect padding takes (N, C, L)
        audio = torch.nn.functional.pad(flat, (pad, pad), mode="reflect").reshape(*lead, -1)
    n_frames = (audio.shape[-1] - n_fft) // hop + 1
    k_full = n_fft // hop
    rem = n_fft - k_full * hop
    rows_needed = n_frames + k_full + (1 if rem else 0)
    total = rows_needed * hop
    if audio.shape[-1] < total:
        audio = torch.nn.functional.pad(audio, (0, total - audio.shape[-1]))
    view = audio[..., :total].reshape(*lead, rows_needed, hop)
    pieces = [view[..., j : j + n_frames, :] for j in range(k_full)]
    if rem:
        pieces.append(view[..., k_full : k_full + n_frames, :rem])
    return torch.cat(pieces, dim=-1)


def vtlp_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    alpha,
    f_min: float = 0.0,
    f_max: float = None,
    f_hi: float = 4800.0,
) -> torch.Tensor:
    """VTLP-warped (n_freqs, n_mels) float32 filterbank, built in torch from
    the warp ``alpha`` (a float or a 0-d tensor, whose device it takes), with
    the JAX package's breakpoint algebra: mel breakpoints below the
    crossover scale by alpha; above it they compress linearly so the Nyquist
    endpoint is kept."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    s2 = sample_rate / 2.0
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    dev = alpha.device
    all_freqs = torch.linspace(0.0, sample_rate // 2, n_freqs, device=dev)
    m_pts = torch.linspace(float(hz_to_mel(f_min)), float(hz_to_mel(f_max)), n_mels + 2, device=dev)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    alpha_1 = torch.clamp(alpha, max=1.0)
    cutoff = f_hi * alpha_1 / alpha
    low = f_pts * alpha
    high = s2 - ((s2 - f_hi * alpha_1) / (s2 - cutoff)) * (s2 - f_pts)
    f_pts = torch.where(f_pts <= cutoff, low, high)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return torch.clamp(torch.minimum(down, up), min=0.0)


def compute_deltas(x: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Regression deltas over the last (time) axis, torchaudio ComputeDeltas
    semantics: replicate padding, N = (win_length - 1) // 2, denominator
    2 * sum(n^2)."""
    n = (win_length - 1) // 2
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    t = x.shape[-1]
    padded = torch.cat([x[..., :1].expand(*x.shape[:-1], n), x, x[..., -1:].expand(*x.shape[:-1], n)], dim=-1)
    out = torch.zeros_like(x)
    for i in range(1, n + 1):
        out = out + i * (padded[..., n + i : n + i + t] - padded[..., n - i : n - i + t])
    return out / denom


def stack_deltas(log_mels: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) -> (B, 3, n_mels, T): log-mels, deltas, accels."""
    deltas = compute_deltas(log_mels)
    return torch.stack((log_mels, deltas, compute_deltas(deltas)), dim=1)


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, n_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(windowed_dft_matrix(n_fft, n_bins)).to(device)


@functools.lru_cache(maxsize=16)
def _mel_basis(config: FrontendConfig, device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(config.n_freqs, config.n_mels, config.sample_rate, config.f_min, config.f_max)
    return torch.from_numpy(fb).to(device)


def _mel_core(audio: torch.Tensor, fb: torch.Tensor, config: FrontendConfig, precision) -> torch.Tensor:
    """Frames, windowed DFT as two matrix products, power, mel product, log;
    ``fb`` is the (n_freqs, n_mels) filterbank on the audio's device."""
    if precision not in (None, "bf16"):
        raise ValueError(f"unsupported frontend precision {precision!r}: expected None or 'bf16'")
    rnd = round_bf16 if precision == "bf16" else (lambda x: x)
    audio = rnd(audio.to(torch.float32))
    frames = center_pad(audio, config).unfold(-1, config.n_fft, config.hop_length)  # (B, T, n_fft)
    n_bins = nyquist_crop_bins(config)
    w = rnd(_dft_basis(config.n_fft, n_bins, audio.device))
    re = frames @ w[:, :n_bins]
    im = frames @ w[:, n_bins:]
    mel = rnd(re * re + im * im) @ rnd(fb[:n_bins])  # (B, T, n_mels)
    return torch.log(mel + config.log_offset).transpose(-1, -2)


def log_mel_spectrogram(
    audio: torch.Tensor, config: FrontendConfig = FrontendConfig(), precision=None, stacked: bool = False
):
    """(B, samples) float32 -> (B, n_mels, frames) log-mel spectrogram, or
    (B, 3, n_mels, frames) with delta and accel channels for ``stacked=True``.

    ``precision=None`` computes in float32 throughout (the JAX chain's
    HIGHEST and, on this card with TF32 off, its HIGH). ``"bf16"`` rounds
    the audio, the DFT basis, the power and the filterbank to bf16 and
    accumulates in float32, as the JAX chain's 1-pass mode does.
    """
    out = _mel_core(audio, _mel_basis(config, audio.device), config, precision)
    return stack_deltas(out) if stacked else out


def log_mel_spectrogram_vtlp(
    audio: torch.Tensor, alpha, config: FrontendConfig = FrontendConfig(), precision=None, stacked: bool = False
):
    """The VTLP-augmented log-mel spectrogram: the filterbank warped by
    ``alpha`` (a float or a 0-d tensor on the audio's device)."""
    fb = vtlp_filterbank(
        config.n_freqs, config.n_mels, config.sample_rate, torch.as_tensor(alpha, device=audio.device),
        config.f_min, config.f_max,
    )
    out = _mel_core(audio, fb, config, precision)
    return stack_deltas(out) if stacked else out
