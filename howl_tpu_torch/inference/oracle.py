"""Scalar Python oracle of the reference engine's decision logic
(counterpart of ``howl_tpu/inference/oracle.py``).

A direct, unvectorized implementation of the smoothing + FSM semantics
described by ref howl/model/inference.py:73-208, on the port's
``EngineConfig``, used to check the port's batched decisions
(``inference/detect.py``: ``fsm_scan``, ``detect_step``,
``smooth_and_detect``) without JAX. Operates on posterior frames so it is
model-free.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from howl_tpu_torch.inference.config import EngineConfig


class OracleEngine:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.reset()

    def reset(self):
        self.pred_history: List[Tuple[float, np.ndarray]] = []
        self.label_history: List[Tuple[float, int]] = []
        self.curr_time = 0.0

    def _drop_old(self, history, window_ms, now):
        # itertools.dropwhile semantics: drop the oldest entries while stale
        idx = 0
        while idx < len(history) and now - history[idx][0] > window_ms:
            idx += 1
        return history[idx:]

    def append_probs(self, probs: np.ndarray, curr_time: float) -> int:
        """Smoothing: max-pool posteriors in the trailing window, argmax,
        threshold to negative (ref :139-176)."""
        self.pred_history.append((curr_time, np.asarray(probs)))
        self.pred_history = self._drop_old(self.pred_history, self.cfg.smoothing_window_ms, curr_time)
        lattice = np.stack([p for _, p in self.pred_history])
        lattice_max = lattice.max(axis=0)
        max_label = int(lattice_max.argmax())
        max_prob = lattice_max[max_label]
        if self.cfg.label_color_map is not None:
            # phone mode: phone argmax -> word color (ref inference.py:156-157)
            max_label = self.cfg.label_color_map[max_label]
        if max_prob < self.cfg.inference_threshold:
            max_label = self.cfg.negative_label
        self.label_history.append((curr_time, max_label))
        return max_label

    def sequence_present(self, curr_time: float) -> bool:
        """FSM over label history within the inference window (ref :91-137)."""
        seq = list(self.cfg.inference_sequence)
        if not seq:
            return False
        self.label_history = self._drop_old(self.label_history, self.cfg.inference_window_ms, curr_time)
        curr_label: Optional[int] = None
        target_state = 0
        last_valid_timestamp = 0.0
        for timestamp, label in self.label_history:
            target_label = seq[target_state]
            if label == target_label:
                target_state += 1
                if target_state == len(seq):
                    return True
                curr_label = seq[target_state - 1]
                last_valid_timestamp = timestamp
            elif label == curr_label:
                last_valid_timestamp = timestamp
            elif last_valid_timestamp + self.cfg.tolerance_window_ms < timestamp:
                curr_label = None
                target_state = 0
                last_valid_timestamp = 0.0
        return False

    def run(self, probs_seq: np.ndarray, times: Sequence[float], valid: np.ndarray = None, check_offset_is_stride: bool = True):
        """Feed a (T, L) posterior sequence; returns (labels, fired) arrays."""
        t_total = probs_seq.shape[0]
        stride = times[1] - times[0] if t_total > 1 else self.cfg.eval_stride_size_ms
        labels = np.full(t_total, -1, np.int64)
        fired = np.zeros(t_total, bool)
        detected = False
        for i in range(t_total):
            if valid is not None and not valid[i]:
                continue
            probs = probs_seq[i]
            if self.cfg.blank_label >= 0 and int(probs.argmax()) == self.cfg.blank_label:
                continue
            labels[i] = self.append_probs(probs, times[i])
            check_time = times[i] + (stride if check_offset_is_stride else 0.0)
            if not detected and self.sequence_present(check_time):
                fired[i] = True
                detected = True  # sticky, matching the batched engine's fired flag
        return labels, fired
