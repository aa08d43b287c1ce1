"""Unified audio sample: metadata + PCM + optional frame labels.

Replaces the reference's two-generation example hierarchy
(ref: howl/data/common/example.py:42-109 and sample.py:7) with one type.
The ``update_audio_data`` timestamp-rescaling contract from
``WakeWordClipExample`` (example.py:83-104) is preserved via ``with_audio``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from howl_tpu_torch.data.common.label import FrameLabelData
from howl_tpu_torch.data.common.metadata import AudioClipMetadata


@dataclass
class Sample:
    metadata: AudioClipMetadata
    audio_data: np.ndarray  # float32 mono PCM at SETTINGS.audio.sample_rate
    sample_rate: int
    label_data: Optional[FrameLabelData] = None
    label: Optional[int] = None  # classification-style scalar label

    @property
    def labelled(self) -> bool:
        return self.label_data is not None or self.label is not None

    @property
    def duration_ms(self) -> float:
        return self.audio_data.shape[-1] / self.sample_rate * 1000.0

    def with_audio(
        self, audio_data: np.ndarray, scale: float = 1.0, bias: float = 0.0, new: bool = False
    ) -> "Sample":
        """New sample with replaced audio; label timestamps rescaled by
        ``scale * t + bias`` (the augmentation contract, ref example.py:98).
        ``new=True`` drops transcription/labels (a synthesized clip)."""
        if new:
            metadata = replace(self.metadata, transcription="")
            label_data = FrameLabelData() if self.label_data is not None else None
            return Sample(metadata, audio_data, self.sample_rate, label_data, self.label)
        label_data = self.label_data.rescaled(scale, bias) if self.label_data is not None else None
        return Sample(self.metadata, audio_data, self.sample_rate, label_data, self.label)
