"""Stub aligner: evenly spread characters over the clip (ref: training/align/stub.py:6)."""

from __future__ import annotations

import numpy as np

from howl_tpu_torch.align.base import AlignedTranscription, Aligner


class StubAligner(Aligner):
    def align(self, sample) -> AlignedTranscription:
        end_ms = sample.audio_data.shape[-1] / sample.sample_rate * 1000
        return self.from_duration(sample.metadata.transcription, end_ms)

    @staticmethod
    def from_duration(transcription: str, duration_ms: float) -> AlignedTranscription:
        """Alignment from transcription + duration alone — lets callers skip
        the audio decode entirely (a WAV header read gives the duration)."""
        transcription = transcription.lower()
        return AlignedTranscription(
            transcription=transcription,
            end_timestamps=np.linspace(0, duration_ms, len(transcription)).tolist(),
        )
