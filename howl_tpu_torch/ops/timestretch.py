"""Host-side time-stretch augmentation (phase vocoder; counterpart of
``howl_tpu/ops/timestretch.py``, numpy as there, with the same draws in the
same order).

Re-implements the semantics of the reference's TimestretchTransform
(ref: howl/data/transform/transform.py:146-166): rate ~ N(1, magnitude)
clipped to [0.3, 1.7], audio stretched with a librosa-style phase vocoder
(librosa.effects.time_stretch: stft -> phase_vocoder -> istft with
n_fft=2048, hop=512), and label timestamps rescaled by 1/rate through the
``Sample.with_audio(scale=...)`` contract (ref example.py:98).

Stays on host because resampling changes lengths: the window sampler reads
label timestamps BEFORE windows are cut, so the stretch must happen on the
full clip ahead of batching (fixed shapes on device). numpy only: librosa
is not a dependency.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

from howl_tpu_torch.data.common.sample import Sample

_N_FFT = 2048
_HOP = 512


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _stft(y: np.ndarray) -> np.ndarray:
    """(samples,) -> (n_fft//2+1, frames) complex; center/reflect, hann."""
    pad = _N_FFT // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - _N_FFT) // _HOP
    idx = np.arange(_N_FFT)[None, :] + _HOP * np.arange(n_frames)[:, None]
    frames = y[idx] * _hann(_N_FFT)
    return np.fft.rfft(frames, axis=-1).T


def _istft(spec: np.ndarray, length: int) -> np.ndarray:
    """Inverse with hann overlap-add and squared-window normalization."""
    window = _hann(_N_FFT)
    frames = np.fft.irfft(spec.T, n=_N_FFT, axis=-1) * window
    n_frames = frames.shape[0]
    total = _N_FFT + _HOP * (n_frames - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    win_sq = window * window
    for i in range(n_frames):
        out[i * _HOP : i * _HOP + _N_FFT] += frames[i]
        norm[i * _HOP : i * _HOP + _N_FFT] += win_sq
    out = np.where(norm > 1e-10, out / np.maximum(norm, 1e-10), out)
    pad = _N_FFT // 2
    out = out[pad:]
    if len(out) < length:
        out = np.pad(out, (0, length - len(out)))
    return out[:length]


def _phase_vocoder(spec: np.ndarray, rate: float) -> np.ndarray:
    """Stretch an STFT in time by ``rate`` with phase accumulation."""
    n_freqs, n_frames = spec.shape
    time_steps = np.arange(0, n_frames, rate)
    # expected per-hop phase advance for each bin
    phi_advance = np.linspace(0, np.pi * _HOP, n_freqs)
    padded = np.concatenate([spec, np.zeros((n_freqs, 2), spec.dtype)], axis=1)
    lo = time_steps.astype(int)
    alpha = time_steps - lo
    col0 = padded[:, lo]  # (n_freqs, T')
    col1 = padded[:, lo + 1]
    mag = (1.0 - alpha)[None, :] * np.abs(col0) + alpha[None, :] * np.abs(col1)
    # accumulated phase: start from frame 0, advance by the wrapped deviation
    dphase = np.angle(col1) - np.angle(col0) - phi_advance[:, None]
    dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
    steps = phi_advance[:, None] + dphase
    phase = np.angle(spec[:, 0])[:, None] + np.concatenate(
        [np.zeros((n_freqs, 1)), np.cumsum(steps, axis=1)[:, :-1]], axis=1
    )
    return mag * np.exp(1j * phase)


def time_stretch(audio: np.ndarray, rate: float) -> np.ndarray:
    """Stretch ``audio`` by ``rate`` (>1 speeds up, <1 slows down).

    Output length is round(len/rate), matching librosa.effects.time_stretch.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    audio = np.asarray(audio, np.float32)
    out_len = int(round(audio.shape[-1] / rate))
    if audio.shape[-1] < _N_FFT // 2 + 1:
        # too short for the vocoder: fall back to linear resampling
        src = np.linspace(0.0, audio.shape[-1] - 1.0, max(out_len, 1))
        return np.interp(src, np.arange(audio.shape[-1]), audio).astype(np.float32)
    stretched = _phase_vocoder(_stft(audio), rate)
    return _istft(stretched, out_len).astype(np.float32)


class TimestretchSampleAugment:
    """Opt-in train-chain stage: stretch full clips before window sampling.

    Mirrors the reference defaults (transform.py:149-153): applied to a batch
    with probability ``prob`` (0.8), per-example rate ~ N(1, ``magnitude``)
    clipped to [0.3, 1.7]; label timestamps rescale by 1/rate.
    """

    def __init__(self, magnitude: float = 0.2, prob: float = 0.8, seed: int = None):
        self.magnitude = magnitude
        self.prob = prob
        self.rng = np.random.default_rng(seed)
        self._gate = random.Random(seed)

    def __call__(self, samples: Sequence[Sample]) -> List[Sample]:
        if self._gate.random() >= self.prob:
            return list(samples)
        out = []
        for sample in samples:
            rate = float(np.clip(self.rng.normal(1.0, self.magnitude), 0.3, 1.7))
            out.append(sample.with_audio(time_stretch(sample.audio_data, rate), scale=1.0 / rate))
        return out
