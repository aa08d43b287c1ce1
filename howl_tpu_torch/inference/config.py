"""Engine configuration (counterpart of ``howl_tpu/inference/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class EngineConfig:
    inference_sequence: Tuple[int, ...] = (0,)
    inference_window_ms: float = 2000.0
    smoothing_window_ms: float = 50.0
    tolerance_window_ms: float = 500.0
    inference_threshold: float = 0.0
    inference_weights: Optional[Tuple[float, ...]] = None
    max_window_size_ms: float = 500.0
    eval_stride_size_ms: float = 62.5
    sample_rate: int = 16000
    negative_label: int = 1
    blank_label: int = -1
    num_labels: int = 2
    # phone mode: dense label -> word-color lookup applied to the smoothed
    # argmax before the FSM; None for word mode
    label_color_map: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_settings(cls, context=None, **overrides) -> "EngineConfig":
        """The configuration ``SETTINGS`` describes, as the JAX package's
        ``EngineConfig.from_settings`` reads it: the inference-engine
        section, the training window and eval stride, the sample rate and,
        with an ``InferenceContext``, its label space (phone mode colors
        the labels into words)."""
        from howl_tpu_torch.settings import SETTINGS

        eng = SETTINGS.inference_engine
        tr = SETTINGS.training
        kwargs = dict(
            inference_sequence=tuple(eng.inference_sequence),
            inference_window_ms=eng.inference_window_ms,
            smoothing_window_ms=eng.smoothing_window_ms,
            tolerance_window_ms=eng.tolerance_window_ms,
            inference_threshold=eng.inference_threshold,
            inference_weights=tuple(eng.inference_weights) if eng.inference_weights else None,
            max_window_size_ms=tr.max_window_size_seconds * 1000,
            eval_stride_size_ms=tr.eval_stride_size_seconds * 1000,
            sample_rate=SETTINGS.audio.sample_rate,
        )
        if context is not None:
            negative_label = context.negative_label
            coloring = getattr(context, "coloring", None)
            if coloring is not None:
                # phone mode: the negative label is colored too, and its color
                # is the fallback of unmapped and below-threshold labels
                negative_label = coloring.color_map[negative_label]
                kwargs["label_color_map"] = tuple(
                    coloring.color_map.get(i, negative_label) for i in range(context.num_labels)
                )
            kwargs.update(
                negative_label=negative_label,
                blank_label=context.blank_label,
                num_labels=context.num_labels,
            )
        kwargs.update(overrides)
        return cls(**kwargs)

    def padded_weights(self):
        """inference_weights padded with ones to num_labels."""
        if not self.inference_weights:
            return None
        w = np.ones(self.num_labels, np.float32)
        w[: len(self.inference_weights)] = self.inference_weights
        return w


def hop_geometry(cfg: EngineConfig, frontend) -> tuple:
    """(window_frames, stride_frames, stride_ms): the window and stride
    quantized to whole mel hops; stride_ms is the quantized step (62.5 ms at
    the 63 ms / 12.5 ms defaults)."""
    hop, sr = frontend.hop_length, cfg.sample_rate
    window_frames = frontend.num_frames(int(cfg.max_window_size_ms / 1000 * sr))
    stride_frames = max(1, round(cfg.eval_stride_size_ms / 1000 * sr / hop))
    stride_ms = stride_frames * hop / sr * 1000.0
    return window_frames, stride_frames, stride_ms


def ring_steps(cfg: EngineConfig, stride_ms: float) -> tuple:
    """(s_steps, w_steps): smoothing/label ring depths for a given step size."""
    stride_ms = max(stride_ms, 1e-6)
    s_steps = max(int(cfg.smoothing_window_ms // stride_ms) + 1, 1)
    w_steps = max(int(cfg.inference_window_ms // stride_ms) + 1, 1)
    return s_steps, w_steps


def serving_dft_precision(compute_dtype, override="auto"):
    """The frontend precision an engine serves at: ``override`` unless it is
    ``"auto"``, which picks the exact float32 grade (``"f32"``) for float32
    serving and the 1-pass ``"bf16"`` grade once bf16 scoring is asked for."""
    if override != "auto":
        return override
    return "f32" if compute_dtype in (None, torch.float32) else "bf16"


def cast_compute_dtype(state_dict, compute_dtype):
    """Round every float32 tensor of a state dict to the serving compute
    dtype (conv weights, BatchNorm running mean and var, the head's weight
    and bias); other tensors, such as the BatchNorm counters, are left
    alone."""
    if compute_dtype is None:
        return state_dict
    return type(state_dict)(
        (k, v.to(compute_dtype) if torch.is_tensor(v) and v.dtype == torch.float32 else v)
        for k, v in state_dict.items()
    )
