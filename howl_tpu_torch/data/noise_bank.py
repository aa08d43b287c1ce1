"""Full-corpus noise-bank sampling with between-epoch refresh.

The reference's ``DatasetMixer`` draws a random window from ANY clip of the
whole noise corpus per example (ref howl/data/transform/transform.py:199-229 —
MUSAN/MS-SNSD are hours of audio). The train step mixes from a device-resident
bank instead (``ops/augment.mix_noise_bank``, the kernel of ``ops/augment_cuda.py``); a fixed bank cut once at startup
sees only its first few minutes of corpus. This module restores the full-
corpus distribution:

  * the bank is sized by a device-memory BUDGET (``--noise-bank-mb``), not a
    hard window count;
  * every refresh draws ``num_windows`` fresh (clip, offset) pairs uniformly
    over clips — the reference's sampling scheme — decoding on a worker pool;
  * ``NoiseBankPrefetcher`` builds the next epoch's bank on a background
    thread while the device trains, so the refresh costs one upload and
    ``NoiseBankTrainStep.set_bank`` at the epoch boundary, on the main thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


def windows_for_budget(budget_mb: float, window_samples: int) -> int:
    """f32 windows fitting a device-memory budget (>= 1)."""
    return max(int(budget_mb * 2**20) // (int(window_samples) * 4), 1)


class NoiseBankSampler:
    """Draws fresh (N, window) noise banks from the FULL corpus per refresh.

    Deterministic per (seed, refresh_index); clip choice is uniform over the
    corpus and the window offset uniform within the clip, matching the
    reference mixer's per-example draw. Clips shorter than the window are
    tiled (the device mixer treats bank rows as circular anyway)."""

    def __init__(
        self,
        noise_ds,
        window_samples: int,
        num_windows: int,
        seed: int = 0,
        num_workers: Optional[int] = None,
    ):
        self.ds = noise_ds
        self.window = int(window_samples)
        self.num_windows = int(num_windows)
        self.seed = int(seed)
        self.num_workers = num_workers
        if not len(noise_ds.metadata_list):
            raise ValueError("noise dataset is empty")

    def sample(self, refresh_index: int) -> np.ndarray:
        from howl_tpu_torch.utils.parallel import parallel_map

        rng = np.random.default_rng((self.seed, int(refresh_index)))
        idxs = rng.integers(0, len(self.ds.metadata_list), self.num_windows)
        unique = sorted({int(i) for i in idxs})
        audios = parallel_map(
            lambda i: self.ds.load_audio(self.ds.metadata_list[i]), unique, num_workers=self.num_workers
        )
        by_idx = dict(zip(unique, audios))
        out = np.zeros((self.num_windows, self.window), np.float32)
        for row, i in enumerate(idxs):
            clip = by_idx[int(i)]
            if len(clip) <= self.window:
                if len(clip):
                    out[row] = np.tile(clip, -(-self.window // len(clip)))[: self.window]
            else:
                off = int(rng.integers(0, len(clip) - self.window + 1))
                out[row] = clip[off : off + self.window]
        return out


class NoiseBankPrefetcher:
    """Overlaps the next refresh's host-side decode with device training."""

    def __init__(self, sampler: NoiseBankSampler):
        self.sampler = sampler
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def start(self, refresh_index: int):
        if self._thread is not None:
            raise RuntimeError("previous prefetch not collected")

        def work():
            try:
                self._result = self.sampler.sample(refresh_index)
            except BaseException as e:  # noqa: BLE001 — surfaced on get()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True, name="noise-bank-prefetch")
        self._thread.start()

    def get(self) -> np.ndarray:
        if self._thread is None:
            raise RuntimeError("no prefetch in flight")
        self._thread.join()
        self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        result, self._result = self._result, None
        return result
