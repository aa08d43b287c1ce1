"""MFA TextGrid -> per-character end timestamps (ref: training/align/mfa.py:7-40).

Word (or phone) intervals become per-character end timestamps by linspace
within each interval; a repeated timestamp stands in for each separating space.
"""

from __future__ import annotations

import numpy as np

from howl_tpu_torch.align.base import AlignedTranscription
from howl_tpu_torch.align.textgrid import TextGrid


class MfaTextGridConverter:
    def __init__(self, split_by_char: bool = True, use_phones: bool = False):
        if not split_by_char:
            raise NotImplementedError("word-level timestamps not implemented")
        self.split_by_char = split_by_char
        self.use_phones = use_phones

    def convert(self, text_grid: TextGrid) -> AlignedTranscription:
        end_timestamps = []
        words = []
        key = "phones" if self.use_phones else "words"
        for interval in text_grid[key]:
            word_len = len(interval.text)
            if word_len == 0:
                continue
            start_ms, end_ms = 1000 * interval.xmin, 1000 * interval.xmax
            if word_len == 1:
                # np.linspace(start, end, 1) == [start]: the reference gives a
                # single-char word/phone an 'end' at the interval START, so
                # its labeled window would end before any of its audio
                # (ref training/align/mfa.py linspace). Use the true end; the
                # multi-char grid stays reference-identical for artifact
                # compatibility.
                end_timestamps.append(end_ms)
            else:
                end_timestamps.extend(np.linspace(start_ms, end_ms, word_len).tolist())
            words.append(interval.text)
            end_timestamps.append(end_ms)  # the following space
        if end_timestamps:
            end_timestamps.pop()  # drop the trailing space slot
        transcript = " ".join(words)
        if len(transcript) != len(end_timestamps):
            raise ValueError("unequal alignment between transcript and timestamps")
        return AlignedTranscription(transcription=transcript.lower(), end_timestamps=end_timestamps)
