"""Fixed-shape numpy batch containers fed to the train step.

(ref: howl/data/common/batch.py:13,36 — torch tensors there; here batches are
host numpy with static shapes, as in the JAX package, and the train loop
uploads them to the device.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ClassificationBatch:
    """(B, window_samples) audio + per-window scalar labels + true lengths."""

    audio_data: np.ndarray
    labels: Optional[np.ndarray]
    lengths: np.ndarray

    @classmethod
    def from_single(cls, audio_clip: np.ndarray, label: int) -> "ClassificationBatch":
        audio = np.asarray(audio_clip)[None, :]
        return cls(audio, np.array([label]), np.array([audio.shape[-1]]))


@dataclass
class SequenceBatch:
    """(B, max_audio) audio + (B, max_labels) label ids for the CTC objective."""

    audio_data: np.ndarray
    labels: np.ndarray
    audio_lengths: Optional[np.ndarray] = None
    label_lengths: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.audio_lengths is None:
            self.audio_lengths = np.full(self.audio_data.shape[0], self.audio_data.shape[-1])
        if self.label_lengths is None:
            self.label_lengths = np.full(self.labels.shape[0], self.labels.shape[-1])
