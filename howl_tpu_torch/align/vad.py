"""Energy-VAD-trimmed stub aligner.

Capability parity with the reference's webrtcvad-based LeftRightVadAligner
(ref: training/align/vad.py:10-40): trim leading/trailing silence, spread
characters over the voiced region. webrtcvad (a native lib) is replaced with a
frame-energy VAD — adequate for trimming, dependency-free, and the same
contract.
"""

from __future__ import annotations

import numpy as np

from howl_tpu_torch.align.base import AlignedTranscription, Aligner


class LeftRightVadAligner(Aligner):
    def __init__(self, frame_ms: int = 30, threshold_db: float = -35.0):
        self.frame_ms = frame_ms
        self.threshold_db = threshold_db

    def _voiced(self, frame: np.ndarray) -> bool:
        rms = float(np.sqrt(np.mean(np.square(frame)) + 1e-12))
        return 20 * np.log10(rms + 1e-12) > self.threshold_db

    def align(self, sample) -> AlignedTranscription:
        transcription = sample.metadata.transcription.lower()
        audio = np.asarray(sample.audio_data)
        frame_len = int(self.frame_ms / 1000 * sample.sample_rate)
        length_ms = int(1000 * audio.shape[-1] / sample.sample_rate)

        def first_voiced_ms(data: np.ndarray) -> int:
            start = 0
            for i in range(0, len(data), frame_len):
                frame = data[i : i + frame_len]
                if len(frame) < frame_len or self._voiced(frame):
                    break
                start += self.frame_ms
            return start

        start = first_voiced_ms(audio)
        end = length_ms - first_voiced_ms(audio[::-1])
        if end <= start:
            start, end = 0, length_ms
        return AlignedTranscription(
            transcription=transcription,
            end_timestamps=np.linspace(start, end, len(transcription)).tolist(),
        )
