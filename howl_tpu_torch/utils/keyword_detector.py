"""Pluggable keyword validation for stitched samples.

The reference validates stitched clips with PocketSphinx (a native C library,
ref: howl/utils/sphinx_keyword_detector.py:6). PocketSphinx isn't available
here; validation is a callable ``(wav_path, wakeword) -> bool`` so users can
plug any STT. The default validator uses a cheap energy heuristic: the clip
must contain as many voiced bursts as the wakeword has words — it catches the
common failure of silent/truncated cuts without an ASR dependency.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from howl_tpu_torch.utils import audio_utils


def count_voiced_bursts(audio: np.ndarray, sample_rate: int, frame_ms: int = 30, threshold_db: float = -35.0) -> int:
    frame_len = max(int(frame_ms / 1000 * sample_rate), 1)
    n_frames = len(audio) // frame_len
    if n_frames == 0:
        return 0
    frames = audio[: n_frames * frame_len].reshape(n_frames, frame_len)
    rms = np.sqrt(np.mean(np.square(frames), axis=1) + 1e-12)
    voiced = 20 * np.log10(rms + 1e-12) > threshold_db
    # count rising edges
    return int(np.sum(voiced[1:] & ~voiced[:-1]) + int(voiced[0]))


def energy_keyword_validator(wav_path: Path, wakeword: str) -> bool:
    audio = audio_utils.silent_load(wav_path)
    if audio.shape[-1] == 0:
        return False
    num_words = max(len(wakeword.split()), 1)
    from howl_tpu_torch.settings import SETTINGS

    # silent_load resamples to the configured rate; frame the bursts at that
    # same rate or the 30 ms frames are wrong for non-16k configs
    bursts = count_voiced_bursts(audio, SETTINGS.audio.sample_rate)
    # stitched clips concatenate word cuts directly; require at least one burst
    # and no more than a small multiple of the word count
    return 1 <= bursts <= 3 * num_words


def default_keyword_validator():
    return energy_keyword_validator
