"""Audio dataset containers (ref: howl/data/dataset/dataset.py:52-320).

A dataset is a list of ``AudioClipMetadata`` plus decode-on-access audio.
No torch Dataset machinery: batching/augmentation happen in the host sampler
(``data/transform``) and on the device (``ops/augment``); these
containers only answer "give me sample i" and set algebra (filter/split/extend).
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional, Tuple

import numpy as np

from howl_tpu_torch.data.common.label import FrameLabelData
from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.common.sample import Sample
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils import audio_utils
from howl_tpu_torch.utils.logger import Logger


class DatasetType(enum.Enum):
    TRAINING = enum.auto()
    DEV = enum.auto()
    TEST = enum.auto()
    UNSPECIFIED = enum.auto()


class DatasetSplit(str, enum.Enum):
    TRAINING = "training"
    DEV = "dev"
    TEST = "test"
    UNSPECIFIED = "unspecified"


class AudioDataset:
    """Metadata container with filter/split/extend and statistics."""

    def __init__(
        self,
        metadata_list: List[AudioClipMetadata],
        set_type: DatasetType = DatasetType.UNSPECIFIED,
        sample_rate: int = None,
        mono: bool = None,
        dataset_split: DatasetSplit = DatasetSplit.UNSPECIFIED,
    ):
        self.metadata_list = list(metadata_list)
        self.set_type = set_type
        self.sample_rate = sample_rate or SETTINGS.audio.sample_rate
        self.mono = SETTINGS.audio.use_mono if mono is None else mono
        if dataset_split == DatasetSplit.UNSPECIFIED and set_type != DatasetType.UNSPECIFIED:
            dataset_split = {
                DatasetType.TRAINING: DatasetSplit.TRAINING,
                DatasetType.DEV: DatasetSplit.DEV,
                DatasetType.TEST: DatasetSplit.TEST,
            }[set_type]
        self.dataset_split = dataset_split

    def __len__(self):
        return len(self.metadata_list)

    @property
    def is_training(self) -> bool:
        return self.set_type == DatasetType.TRAINING

    def filter(self, predicate_fn: Callable[[AudioClipMetadata], bool], clone: bool = False):
        """Keep metadata matching the predicate (in place unless clone)."""
        data = list(filter(predicate_fn, self.metadata_list))
        if clone:
            other = self._shallow_clone()
            other.metadata_list = data
            return other
        self.metadata_list = data
        return self

    def split(self, predicate_fn: Callable[[AudioClipMetadata], bool]) -> Tuple["AudioDataset", "AudioDataset"]:
        """Two datasets: (predicate false, predicate true) — matches the
        reference's (data1, data2) convention used with Sha256Splitter."""
        data1, data2 = [], []
        for metadata in self.metadata_list:
            (data2 if predicate_fn(metadata) else data1).append(metadata)
        ds1, ds2 = self._shallow_clone(), self._shallow_clone()
        ds1.metadata_list, ds2.metadata_list = data1, data2
        return ds1, ds2

    def extend(self, other: "AudioDataset"):
        self.metadata_list.extend(other.metadata_list)
        return self

    def _shallow_clone(self):
        import copy

        other = copy.copy(self)
        other.metadata_list = list(self.metadata_list)
        return other

    def load_audio(self, metadata: AudioClipMetadata) -> np.ndarray:
        return audio_utils.silent_load(metadata.path, self.sample_rate, self.mono)

    def audio_length_seconds(
        self,
        sample_limit: Optional[int] = None,
        num_workers: Optional[int] = None,
        use_trim: bool = False,
        top_db: float = 40.0,
    ) -> float:
        """Total decoded audio seconds; ``use_trim`` drops leading/trailing
        silence per clip before accumulating, like the reference's
        statistics pass (ref: howl/data/dataset/dataset.py:146-171)."""
        from howl_tpu_torch.utils.audio_utils import trim_silence
        from howl_tpu_torch.utils.parallel import parallel_map

        def clip_seconds(metadata) -> float:
            audio = self.load_audio(metadata)
            if use_trim:
                audio = trim_silence(audio, top_db=top_db)
            return audio.shape[-1] / self.sample_rate

        durations = parallel_map(
            clip_seconds, self.metadata_list[:sample_limit], num_workers=num_workers
        )
        return float(sum(durations))

    def compute_statistics(
        self,
        word_searcher=None,
        compute_length: bool = True,
        num_workers: Optional[int] = None,
        use_trim: bool = True,
        top_db: float = 40.0,
    ) -> dict:
        """Dataset stats: clip count, audio hours, vocab occurrence counts.
        Per-clip work runs on a worker pool sized by ``num_workers`` (None ->
        SETTINGS.resource.cpu_count), matching the reference's pooled
        ``_compute_sample_statistic`` (ref dataset.py:175-194); the reduction
        over ordered per-clip results is identical to a sequential run.
        ``use_trim`` (the reference default too, ref dataset.py:211-214)
        silence-trims each clip at ``top_db`` before accumulating length."""
        from howl_tpu_torch.utils.parallel import parallel_map

        stats = {"num_examples": len(self.metadata_list)}
        if compute_length:
            stats["audio_length_seconds"] = self.audio_length_seconds(
                num_workers=num_workers, use_trim=use_trim, top_db=top_db
            )
        if word_searcher is not None:
            per_clip = parallel_map(
                lambda metadata: word_searcher.count_vocab(metadata.transcription),
                self.metadata_list,
                num_workers=num_workers,
            )
            counts: dict = {}
            for clip_counts in per_clip:
                for word, count in clip_counts.items():
                    counts[word] = counts.get(word, 0) + count
            stats["vocab_counts"] = counts
        return stats

    def print_stats(self, header: str = "", word_searcher=None, compute_length: bool = True, num_workers=None):
        stats = self.compute_statistics(word_searcher, compute_length, num_workers=num_workers)
        Logger.info(f"{header} dataset stats: {stats}")
        return stats


class AudioClipDataset(AudioDataset):
    """Returns unlabeled samples; audio decoded (and LRU-cached) on access."""

    def __getitem__(self, idx: int) -> Sample:
        metadata = self.metadata_list[idx]
        return Sample(metadata, self.load_audio(metadata), self.sample_rate)


class WakeWordDataset(AudioDataset):
    """Attaches frame labels from a labeler on access (ref dataset.py:253-272)."""

    def __init__(self, *args, frame_labeler=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.frame_labeler = frame_labeler

    def __getitem__(self, idx: int) -> Sample:
        metadata = self.metadata_list[idx]
        label_data = (
            self.frame_labeler.compute_frame_labels(metadata)
            if self.frame_labeler is not None
            else FrameLabelData()
        )
        return Sample(metadata, self.load_audio(metadata), self.sample_rate, label_data=label_data)


class AudioClassificationDataset(AudioDataset):
    """Scalar label from a transcription->label map (ref dataset.py:274-295)."""

    def __init__(self, *args, label_map=None, silence_proportion: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.label_map = label_map or {}
        self.silence_proportion = silence_proportion

    def label_of(self, metadata: AudioClipMetadata) -> int:
        default = self.label_map.get("__default__")
        return self.label_map.get(metadata.transcription, default)

    @property
    def _num_silence(self) -> int:
        # derived from the CURRENT size (ref dataset.py:318-320) so
        # filter()/extend() keep the silence fraction honest
        return int(len(self.metadata_list) * self.silence_proportion)

    def __len__(self):
        return len(self.metadata_list) + self._num_silence

    def __getitem__(self, idx: int) -> Sample:
        if idx >= len(self.metadata_list):
            # synthetic silence sample (ref HonkSpeechCommandsDataset:297-320)
            silence = np.zeros(self.sample_rate, dtype=np.float32)
            meta = AudioClipMetadata(path="__silence__.wav", transcription="__silence__")
            # silence falls back to the unknown/default class, never to
            # vocab word 0 (ref: defaultdict label_map, dataset.py:304)
            silence_label = self.label_map.get("__silence__", self.label_map.get("__default__", 0))
            return Sample(meta, silence, self.sample_rate, label=silence_label)
        metadata = self.metadata_list[idx]
        return Sample(metadata, self.load_audio(metadata), self.sample_rate, label=self.label_of(metadata))
