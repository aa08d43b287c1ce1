"""Detection metrics (counterpart of ``howl_tpu/models/metric.py``; ref:
howl/model/metric.py:6-41)."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class ConfusionMatrix:
    tp: int = 0
    fp: int = 0
    tn: int = 0
    fn: int = 0

    def increment(self, pred: bool, label: bool):
        if pred and label:
            self.tp += 1
        elif pred and not label:
            self.fp += 1
        elif not pred and label:
            self.fn += 1
        else:
            self.tn += 1

    def increment_array(self, preds, labels):
        """Vectorized accumulation from boolean arrays."""
        import numpy as np

        preds = np.asarray(preds, bool)
        labels = np.asarray(labels, bool)
        self.tp += int(np.sum(preds & labels))
        self.fp += int(np.sum(preds & ~labels))
        self.fn += int(np.sum(~preds & labels))
        self.tn += int(np.sum(~preds & ~labels))

    @property
    def mcc(self) -> float:
        tp, tn, fp, fn = self.tp, self.tn, self.fp, self.fn
        num = tp * tn - fp * fn
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) or 1
        return num / denom

    def fp_per_hour(self, input_speech_length_ms: float) -> float:
        return self.fp / (input_speech_length_ms / 3.6e6) if input_speech_length_ms > 0 else 0.0

    def fn_per_hour(self, input_speech_length_ms: float) -> float:
        return self.fn / (input_speech_length_ms / 3.6e6) if input_speech_length_ms > 0 else 0.0

    @property
    def tp_rate(self) -> float:
        return self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0.0

    @property
    def fp_rate(self) -> float:
        return self.fp / (self.fp + self.tn) if (self.fp + self.tn) else 0.0

    def __str__(self):
        return f"ConfusionMatrix(tp={self.tp}, fp={self.fp}, tn={self.tn}, fn={self.fn})"
