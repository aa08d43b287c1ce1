"""Dataset-type constants (ref: howl/dataset/audio_dataset_constants.py:5-31)."""

from __future__ import annotations

from enum import Enum, unique


@unique
class SampleType(str, Enum):
    POSITIVE = "positive"
    NEGATIVE = "negative"


@unique
class AudioDatasetType(str, Enum):
    COMMON_VOICE = "common-voice"
    RAW = "raw"
    ALIGNED = "aligned"
    STITCHED = "stitched"


METADATA_FILE_PREFIX = {
    AudioDatasetType.RAW: "",
    AudioDatasetType.ALIGNED: "aligned-",
    AudioDatasetType.STITCHED: "stitched-",
}

METADATA_FILE_NAME_TEMPLATES = {
    AudioDatasetType.RAW: "metadata-{dataset_split}.jsonl",
    AudioDatasetType.ALIGNED: "aligned-metadata-{dataset_split}.jsonl",
    AudioDatasetType.STITCHED: "stitched-metadata-{dataset_split}.jsonl",
}

DIR_AUDIO = "audio"
DIR_ALIGNMENT = "alignment"
