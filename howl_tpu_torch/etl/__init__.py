"""Offline dataset-generation ETL: mine corpora, attach alignments, stitch wakewords."""

from howl_tpu_torch.etl.aligned_generator import AlignedAudioDatasetGenerator, AlignmentType
from howl_tpu_torch.etl.raw_generator import RawAudioDatasetGenerator
from howl_tpu_torch.etl.stitched_generator import StitchedAudioDatasetGenerator
from howl_tpu_torch.etl.stitcher import WordStitcher

__all__ = [
    "AlignedAudioDatasetGenerator",
    "AlignmentType",
    "RawAudioDatasetGenerator",
    "StitchedAudioDatasetGenerator",
    "WordStitcher",
]
