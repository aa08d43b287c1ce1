"""Zero-mean unit-variance normalization, fit once over the train set
(counterpart of ``howl_tpu/ops/zmuv.py``).

The state is three float64 host scalars (mean, mean of squares, count),
accumulated with numpy as the JAX package accumulates them, so both
packages fit the same numbers from the same features.
"""

from __future__ import annotations

import numpy as np
import torch

from howl_tpu_torch.ops.frontend import log_mel_spectrogram


class ZmuvTransform:
    """Accumulates a global scalar mean and variance, then normalizes."""

    def __init__(self, mean: float = 0.0, mean2: float = 0.0, total: float = 0.0):
        self.mean = float(mean)
        self.mean2 = float(mean2)
        self.total = float(total)

    def update(self, data, mask=None):
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, dtype=np.float64)
        if mask is not None:
            mask = mask.detach().cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)
            data = data * mask
            size = float(np.sum(mask))
        else:
            size = float(data.size)
        self.mean = (data.sum() + self.mean * self.total) / (self.total + size)
        self.mean2 = ((data**2).sum() + self.mean2 * self.total) / (self.total + size)
        self.total += size

    @property
    def std(self) -> float:
        return float(np.sqrt(max(self.mean2 - self.mean**2, 1e-12)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - float(np.float32(self.mean))) / float(np.float32(self.std))

    def state_dict(self) -> dict:
        return {"mean": self.mean, "mean2": self.mean2, "total": self.total}

    @classmethod
    def from_state_dict(cls, state: dict) -> "ZmuvTransform":
        return cls(state["mean"], state["mean2"], state["total"])


@torch.no_grad()
def fit_zmuv(audio_batches, frontend_cfg, max_batches: int = None) -> ZmuvTransform:
    """Fit a ZmuvTransform over the stacked (log-mel, delta, accel) features
    of audio batches, each (B, samples) numpy or tensor, computed where each
    batch lies."""
    zmuv = ZmuvTransform()
    for idx, audio in enumerate(audio_batches):
        if max_batches is not None and idx >= max_batches:
            break
        audio = torch.as_tensor(audio, dtype=torch.float32)
        zmuv.update(log_mel_spectrogram(audio, frontend_cfg, stacked=True))
    return zmuv
