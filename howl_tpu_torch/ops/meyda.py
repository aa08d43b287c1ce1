"""Meyda.js-parity mel spectrogram, pure numpy (counterpart of
``howl_tpu/ops/meyda.py``; ref: howl/data/transform/meyda.py:8-87).

Honkling runs inference in the browser with Meyda.js features; this host-side
reference implementation reproduces that pipeline (radix-2 Cooley-Tukey FFT,
amplitude->power spectrum, HTK mel with f_max=8000) so exported models can be
validated against the browser's exact frontend. Toggled by
SETTINGS.audio_transform.use_meyda_spectrogram, which pins the device
frontend's f_max at 8 kHz (``FrontendConfig.from_settings``).

No librosa: the mel basis comes from our filterbank (identical HTK algebra) and
framing/windowing are implemented directly.
"""

from __future__ import annotations

import numpy as np

from howl_tpu_torch.ops.frontend import _hann_window, mel_filterbank


def cooley_tukey_fft(x: np.ndarray) -> np.ndarray:
    """Vectorized non-recursive radix-2 FFT (matches the Meyda.js evaluation
    order, which differs from numpy.fft in float rounding)."""
    x = np.asarray(x, dtype=float)
    n = x.shape[0]
    if np.log2(n) % 1 > 0:
        raise ValueError("size of x must be a power of 2")
    n_min = min(n, 32)
    k = np.arange(n_min)[:, None]
    m = np.exp(-2j * np.pi * np.arange(n_min) * k / n_min)
    X = np.dot(m, x.reshape((n_min, -1)))
    while X.shape[0] < n:
        x_even = X[:, : X.shape[1] // 2]
        x_odd = X[:, X.shape[1] // 2 :]
        factor = np.exp(-1j * np.pi * np.arange(X.shape[0]) / X.shape[0])[:, None]
        X = np.vstack([x_even + factor * x_odd, x_even - factor * x_odd])
    return X.ravel()


class MeydaMelSpectrogram:
    def __init__(
        self,
        n_fft: int = 512,
        n_mels: int = 80,
        sample_rate: int = 16000,
        hop_length: int = 200,
        f_max: float = 8000.0,
        f_min: float = 0.0,
        power: float = 2.0,
    ):
        self.n_fft = n_fft
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.power = power
        # (n_mels, n_freqs) like librosa's basis orientation
        self.mel_basis = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max).T
        self.fft_window = _hann_window(n_fft).astype(float)

    def spectrogram(self, audio_data: np.ndarray) -> np.ndarray:
        y = np.pad(np.asarray(audio_data, float), self.n_fft // 2, mode="reflect")
        n_frames = (len(y) - self.n_fft) // self.hop_length + 1
        rows = []
        for i in range(n_frames):
            frame = y[i * self.hop_length : i * self.hop_length + self.n_fft] * self.fft_window
            spectrum = cooley_tukey_fft(frame)
            amp = np.sqrt(spectrum.real**2 + spectrum.imag**2)[: self.n_fft // 2 + 1]
            rows.append(amp)
        return np.abs(np.stack(rows)) ** self.power

    def __call__(self, audio_data: np.ndarray) -> np.ndarray:
        """(B, samples) -> (B, n_mels, frames)."""
        audio_data = np.atleast_2d(np.asarray(audio_data))
        return np.stack([self.mel_basis @ self.spectrogram(sample).T for sample in audio_data]).astype(
            np.float32
        )
