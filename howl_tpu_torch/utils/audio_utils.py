"""Host-side audio I/O and windowing.

Replaces the reference's librosa/soundfile usage (ref: howl/utils/audio_utils.py:8,26)
with a dependency-light implementation: stdlib ``wave`` + numpy for WAV decode and
encode, scipy polyphase resampling, and a strided window iterator. Device code
never touches this module — it only ever sees fixed-rate float32 PCM arrays.
"""

from __future__ import annotations

import functools
import wave
from pathlib import Path
from typing import Iterator, Union

import numpy as np

from howl_tpu_torch.settings import SETTINGS

PathLike = Union[str, Path]


def read_wav(path: PathLike) -> tuple[np.ndarray, int]:
    """Decode a WAV file to float32 in [-1, 1]. Returns (audio[channels, n], sr)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n_channels = f.getnchannels()
        sample_width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if sample_width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sample_width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sample_width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sample_width} in {path}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).T
    else:
        data = data[None, :]
    return data, sr


def write_wav(path: PathLike, audio: np.ndarray, sample_rate: int = None):
    """Encode float32 [-1, 1] mono/planar audio as 16-bit PCM WAV."""
    sample_rate = sample_rate or SETTINGS.audio.sample_rate
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.T.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _ffmpeg_path() -> str:
    import shutil

    return shutil.which("ffmpeg") or ""


def _ffmpeg_decode(path: str, sample_rate: int, mono: bool) -> tuple[np.ndarray, int]:
    """Decode any ffmpeg-supported container (mp3/ogg/flac/...) to float32 PCM
    by shelling out to the ffmpeg CLI — no Python codec dependencies. Gives
    `silent_load` the reference's ability to ingest raw Common Voice mp3
    dumps, which it decodes via librosa/libsndfile
    (ref: howl/utils/audio_utils.py:8)."""
    import subprocess

    ffmpeg = _ffmpeg_path()
    if not ffmpeg:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and no `ffmpeg` binary on "
            "PATH. Install ffmpeg or transcode the corpus to 16 kHz WAV."
        )
    channels = "1" if mono else "2"
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-nostdin", "-i", str(path),
         "-f", "f32le", "-acodec", "pcm_f32le", "-ac", channels,
         "-ar", str(int(sample_rate)), "pipe:1"],
        capture_output=True, check=True, timeout=120,
    ).stdout
    data = np.frombuffer(out, dtype="<f4").astype(np.float32)
    if not mono:
        data = data.reshape(-1, 2).T
    else:
        data = data[None, :]
    return data, int(sample_rate)


def _load_uncached(path: str, sample_rate: int, mono: bool) -> np.ndarray:
    suffix = Path(path).suffix.lower()
    if suffix in (".wav", ".wave"):
        data, sr = read_wav(path)
    else:
        data, sr = _ffmpeg_decode(path, sample_rate, mono)
    if mono and data.shape[0] > 1:
        data = data.mean(axis=0, keepdims=True)
    data = resample(data, sr, sample_rate)
    return np.ascontiguousarray(data[0] if mono else data, dtype=np.float32)


@functools.lru_cache(maxsize=SETTINGS.cache.cache_size)
def _cached_load(path: str, sample_rate: int, mono: bool) -> np.ndarray:
    arr = _load_uncached(path, sample_rate, mono)
    arr.setflags(write=False)
    return arr


def silent_load(path: PathLike, sample_rate: int = None, mono: bool = None) -> np.ndarray:
    """Load audio as float32 at the configured sample rate; errors return silence.

    Mirrors the reference contract (bad clips become empty arrays and are
    filtered downstream) while caching decodes (ref: howl/utils/audio_utils.py:8).
    """
    sample_rate = sample_rate or SETTINGS.audio.sample_rate
    mono = SETTINGS.audio.use_mono if mono is None else mono
    try:
        return _cached_load(str(path), int(sample_rate), bool(mono))
    except Exception:  # noqa: BLE001 — parity: any decode failure yields silence
        return np.zeros(0, dtype=np.float32)


def trim_silence(
    audio: np.ndarray, top_db: float = 40.0, frame_length: int = 2048, hop_length: int = 512
) -> np.ndarray:
    """Trim leading/trailing silence, matching librosa ``effects.trim``
    semantics: per-frame RMS in dB relative to the loudest frame, frames
    quieter than ``-top_db`` at both ends are dropped, and the kept span is
    ``[hop * first_loud, min(n, hop * (last_loud + 1))]``.

    The reference trims clips this way (top_db=40) before accumulating
    dataset audio-length statistics (ref: howl/data/dataset/dataset.py:146-171).
    All-silent input is returned unchanged (no loud frame to anchor on)."""
    audio = np.asarray(audio)
    n = audio.shape[-1]
    if n == 0:
        return audio
    # centered frames, zero-padded at the edges like librosa's rms(center=True)
    pad = frame_length // 2
    padded = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(pad, pad)])
    n_frames = 1 + n // hop_length
    starts = np.arange(n_frames) * hop_length
    rms = np.sqrt(
        np.stack(
            [np.mean(np.square(padded[..., s : s + frame_length]), axis=-1) for s in starts],
            axis=-1,
        )
    )
    if audio.ndim > 1:  # any-channel-loud counts as voiced
        rms = rms.max(axis=tuple(range(audio.ndim - 1)))
    peak = rms.max()
    if peak <= 0.0:
        return audio
    loud = np.flatnonzero(rms > peak * 10.0 ** (-top_db / 20.0))
    if loud.size == 0:
        return audio
    start = int(loud[0]) * hop_length
    end = min(n, (int(loud[-1]) + 1) * hop_length)
    return audio[..., start:end]


def stride(
    audio: np.ndarray, window_ms: float, stride_ms: float, sample_rate: int = None,
    drop_incomplete: bool = True,
) -> Iterator[np.ndarray]:
    """Yield sliding windows over the last axis (ref: howl/utils/audio_utils.py:26).

    Windows start every ``stride_ms``. ``drop_incomplete=True`` (the
    reference default) stops at the first window shorter than ``window_ms``;
    pass False to also yield the shorter tail windows.
    """
    sample_rate = sample_rate or SETTINGS.audio.sample_rate
    window = int(window_ms / 1000 * sample_rate)
    hop = int(stride_ms / 1000 * sample_rate)
    start = 0
    while start < audio.shape[-1]:
        sliced = audio[..., start : start + window]
        if sliced.shape[-1] != window and drop_incomplete:
            return
        yield sliced
        start += hop


def wav_num_samples(path: PathLike, target_sr: int = None) -> int:
    """Sample count of a WAV file (at ``target_sr`` if given) from the header
    alone — no decode. Falls back to a full decode for non-WAV inputs."""
    try:
        with wave.open(str(path), "rb") as f:
            n = f.getnframes()
            sr = f.getframerate()
        if target_sr and sr != target_sr:
            # ceil, matching scipy resample_poly's output length in
            # silent_load — round() would undercount by one for some ratios
            # and disagree with the decoded array
            n = -(-n * target_sr // sr)
        return n
    except Exception:  # noqa: BLE001
        return silent_load(path, target_sr).shape[-1]


def frame_count(num_samples: int, num_fft: int = None, hop_length: int = None, center: bool = True) -> int:
    """Number of STFT frames produced for ``num_samples`` of audio."""
    num_fft = num_fft or SETTINGS.audio_transform.num_fft
    hop_length = hop_length or SETTINGS.audio_transform.hop_length
    if center:
        return num_samples // hop_length + 1
    return max((num_samples - num_fft) // hop_length + 1, 0)
