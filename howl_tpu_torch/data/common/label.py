"""Frame-level label container (ref: howl/data/common/label.py:8)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class FrameLabelData:
    """Word/phone occurrences within a clip.

    timestamp_label_map: word-end timestamp (ms) -> label id
    start_timestamp:     (label id, word-start timestamp ms)
    char_indices:        (label id, character indices of the word in transcript)
    """

    timestamp_label_map: Dict[float, int] = field(default_factory=dict)
    start_timestamp: List[Tuple[int, float]] = field(default_factory=list)
    char_indices: List[Tuple[int, List[int]]] = field(default_factory=list)

    def rescaled(self, scale: float = 1.0, bias: float = 0.0) -> "FrameLabelData":
        """Label timestamps after an audio time-stretch/shift (ref: example.py:98)."""
        return FrameLabelData(
            {scale * k + bias: v for k, v in self.timestamp_label_map.items()},
            self.start_timestamp,
            self.char_indices,
        )
