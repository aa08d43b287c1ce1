"""Label-aware window sampling -> fixed-shape batches.

The reference does this per-batch inside torch DataLoader workers
(ref: howl/data/transform/batchifier.py:14-118, operator.py:77-117). Here the
sampler runs on host with numpy RNG and always emits a canonical
(B, window_samples) array, as in the JAX package, while waveform-level
augmentation happens afterwards on the device (``ops/augment``). Random left/right placement of short clips
(tensorize_audio_data's ``rand_append``, operator.py:104) is preserved here
because it interacts with label windows.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence

import numpy as np

from howl_tpu_torch.data.common.batch import ClassificationBatch, SequenceBatch
from howl_tpu_torch.data.common.sample import Sample
from howl_tpu_torch.data.common.tokenizer import TranscriptTokenizer


def _place_in_window(audio: np.ndarray, window: int, rng: random.Random, rand_append: bool) -> tuple:
    """Pad/truncate a clip into a fixed window; returns (array, true_length)."""
    audio = np.asarray(audio, np.float32)[..., :window]
    length = audio.shape[-1]
    out = np.zeros(window, np.float32)
    if rand_append and rng.random() < 0.5:
        out[window - length :] = audio
    else:
        out[:length] = audio
    return out, length


class WakeWordFrameBatchifier:
    """Window sampler for the frame objective (ref batchifier.py:37-118).

    For each labeled sample: with probability ``positive_sample_prob`` cut a
    window ending just after a random vocab-word end timestamp (+eps<=20ms,
    labeled with that word); otherwise cut from the complement of positive
    intervals (+-positive_delta_ms guard band, labeled negative).
    """

    def __init__(
        self,
        negative_label: int,
        positive_sample_prob: float = 0.5,
        window_size_ms: int = 500,
        sample_rate: int = 16000,
        positive_delta_ms: int = 150,
        eps_ms: int = 20,
        pad_to_window: bool = True,
        seed: int = None,
        context_samples: int = 0,
    ):
        """``context_samples > 0`` emits trunk-mode CONTEXT segments: each
        example is window + margin audio on both sides (real clip audio where
        available, zeros past the clip edge), with the labeled window pinned
        at offset ``context_samples``. The fused-trunk res8 training forward
        pools exactly that central span (Res8.windowed_logits), matching the
        engine's clip-level serving computation."""
        self.negative_label = negative_label
        self.positive_sample_prob = positive_sample_prob
        self.window_size_ms = window_size_ms
        self.sample_rate = sample_rate
        self.positive_delta_ms = positive_delta_ms
        self.eps_ms = eps_ms
        if not pad_to_window:
            # the train step takes fixed-shape windows (module docstring); the
            # reference's variable-length mode has no equivalent here
            raise NotImplementedError("pad_to_window=False is not supported (the train step takes fixed shapes)")
        self.pad_to_window = pad_to_window
        self.context_samples = int(context_samples)
        self.rng = random.Random(seed) if seed is not None else random

    @property
    def window_samples(self) -> int:
        return int(self.window_size_ms / 1000 * self.sample_rate)

    def __call__(self, samples: Sequence[Sample]) -> ClassificationBatch:
        rng = self.rng
        cut: List[tuple] = []  # (label, clip_audio, a, b)
        for sample in samples:
            ts_map = sample.label_data.timestamp_label_map if sample.label_data else {}
            clip = sample.audio_data
            if not ts_map:
                # unlabeled/negative clip: random slice up to one window
                a = 0
                if clip.shape[-1] > self.window_samples:
                    a = rng.randint(0, clip.shape[-1] - self.window_samples)
                cut.append((self.negative_label, clip, a, min(a + self.window_samples, clip.shape[-1])))
                continue

            select_negative = rng.random() > self.positive_sample_prob
            if not select_negative:
                end_ms, label = rng.choice(list(ts_map.items()))
                end_ms_rand = end_ms + rng.random() * self.eps_ms
                b = int(end_ms_rand / 1000 * self.sample_rate)
                a = max(b - self.window_samples, 0)
                if min(b, clip.shape[-1]) - a <= 0:
                    # degenerate zero-length span (end_ms at clip start, OR
                    # label timestamps past a truncated/empty decode): an
                    # all-zeros window must not carry a positive label
                    select_negative = True
                else:
                    cut.append((label, clip, a, min(b, clip.shape[-1])))

            if select_negative:
                positive_intervals = sorted(
                    (v - self.positive_delta_ms, v + self.positive_delta_ms) for v in ts_map.keys()
                )
                negative_intervals = []
                last_positive = 0.0
                for a_ms, b_ms in positive_intervals:
                    if last_positive < a_ms:
                        negative_intervals.append((last_positive, a_ms))
                    last_positive = b_ms
                negative_intervals.append((last_positive, sample.duration_ms))
                a_ms, b_ms = rng.choice(negative_intervals)
                if b_ms - a_ms > self.window_size_ms:
                    # sample within the interval (the reference samples from 0,
                    # which can slide the 'negative' window back over a
                    # positive word - a mislabeling bug we don't keep)
                    a_ms = rng.randint(int(a_ms), int(b_ms - self.window_size_ms))
                    b_ms = a_ms + self.window_size_ms
                a = int(max(a_ms, 0) / 1000 * self.sample_rate)
                b = int(max(b_ms, 0) / 1000 * self.sample_rate)
                a = min(a, clip.shape[-1])
                b = min(max(b, a), min(a + self.window_samples, clip.shape[-1]))
                cut.append((self.negative_label, clip, a, b))

        labels = np.array([c[0] for c in cut], np.int32)
        if self.context_samples > 0:
            placed = [self._place_with_context(clip, a, b) for _, clip, a, b in cut]
        else:
            placed = [
                _place_in_window(clip[..., a:b], self.window_samples, rng, rand_append=True)
                for _, clip, a, b in cut
            ]
        audio = np.stack([p[0] for p in placed])
        lengths = np.array([p[1] for p in placed], np.int32)
        return ClassificationBatch(audio, labels, lengths)

    def _place_with_context(self, clip: np.ndarray, a: int, b: int) -> tuple:
        """Window [a, b) pinned at offset ctx inside a (window + 2*ctx) segment,
        surrounded by real clip audio where the clip extends that far."""
        ctx = self.context_samples
        seg = np.zeros(self.window_samples + 2 * ctx, np.float32)
        src_lo = max(a - ctx, 0)
        src_hi = min(b + ctx, clip.shape[-1])
        seg[src_lo - a + ctx : src_hi - a + ctx] = clip[..., src_lo:src_hi]
        return seg, b - a


class AudioSequenceBatchifier:
    """Full-utterance batches for the CTC objective (ref batchifier.py:14-35).

    Pads audio to ``max_audio_samples`` and labels to ``max_label_length`` so
    shapes stay static across batches (bucket eval clips by length upstream).
    """

    def __init__(
        self,
        negative_label: int,
        tokenizer: TranscriptTokenizer,
        sample_rate: int = 16000,
        max_audio_samples: Optional[int] = None,
        max_label_length: int = 64,
    ):
        self.negative_label = negative_label
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.max_audio_samples = max_audio_samples
        self.max_label_length = max_label_length
        self._warned_truncation = False

    def __call__(self, samples: Sequence[Sample]) -> SequenceBatch:
        label_lists = [self.tokenizer.encode(s.metadata.transcription) for s in samples]
        if not self._warned_truncation and any(len(l) > self.max_label_length for l in label_lists):
            # dropping transcript tails silently would train CTC toward a
            # truncated target (possibly cutting the wakeword itself)
            from howl_tpu_torch.utils.logger import Logger

            Logger.warning(
                f"label sequence longer than max_label_length={self.max_label_length} "
                "truncated; raise max_label_length to keep full transcripts"
            )
            self._warned_truncation = True
        audio_lengths = np.array(
            [min(s.audio_data.shape[-1], self.max_audio_samples or 10**12) for s in samples], np.int32
        )
        max_audio = self.max_audio_samples or int(audio_lengths.max())
        audio = np.zeros((len(samples), max_audio), np.float32)
        for i, s in enumerate(samples):
            audio[i, : audio_lengths[i]] = s.audio_data[..., : audio_lengths[i]]
        label_lengths = np.array([min(len(l), self.max_label_length) for l in label_lists], np.int32)
        labels = np.full((len(samples), self.max_label_length), self.negative_label, np.int32)
        for i, l in enumerate(label_lists):
            labels[i, : label_lengths[i]] = l[: label_lengths[i]]
        return SequenceBatch(audio, labels, audio_lengths, label_lengths)


class ClassificationBatchSampler:
    """Shuffled minibatch iterator over a classification dataset -> fixed-shape
    ClassificationBatch (replaces DataLoader+collate; ref dataloader.py:8-27).

    Drops the last partial batch during training (static shapes); for eval pads
    the final batch by cycling the epoch order from its start (repeating as
    many times as needed for datasets smaller than the shortfall) and reports
    the ``valid`` count.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        window_samples: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.window_samples = window_samples
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self._place_rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[ClassificationBatch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    return
                # np.resize tiles the order cyclically, so datasets smaller
                # than the shortfall still fill every row (no zero-audio
                # rows silently labeled class 0)
                idx = np.concatenate([idx, np.resize(order, self.batch_size - len(idx))])
                valid = len(order) - start
            else:
                valid = self.batch_size
            audio = np.zeros((self.batch_size, self.window_samples), np.float32)
            labels = np.zeros(self.batch_size, np.int32)
            lengths = np.zeros(self.batch_size, np.int32)
            for row, i in enumerate(idx):
                sample = self.dataset[int(i)]
                placed, length = _place_in_window(
                    sample.audio_data, self.window_samples, self._place_rng, rand_append=False
                )
                audio[row] = placed
                if sample.label is None:
                    # coercing to 0 would silently train unknowns as the
                    # first vocab class (the reference maps unknowns to a
                    # dedicated class via defaultdict, ref dataset.py)
                    raise ValueError(
                        f"sample {int(i)} has no label: transcription "
                        f"{sample.metadata.transcription!r} is not in label_map and no "
                        "'__default__' fallback is set"
                    )
                labels[row] = sample.label
                lengths[row] = length
            batch = ClassificationBatch(audio, labels, lengths)
            batch.valid = valid  # type: ignore[attr-defined]
            yield batch
