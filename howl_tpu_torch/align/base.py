"""Alignment data model (ref: training/align/base.py:9,14)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class AlignedTranscription:
    """Transcription with a per-character end timestamp (ms)."""

    transcription: str
    end_timestamps: List[float]


class Aligner:
    def align(self, sample) -> AlignedTranscription:
        """sample: howl_tpu_torch.data.common.sample.Sample."""
        raise NotImplementedError
