"""Device-agnostic data model: metadata, labels, vocab, tokenizers, searchers."""

from howl_tpu_torch.data.common.batch import ClassificationBatch, SequenceBatch
from howl_tpu_torch.data.common.label import FrameLabelData
from howl_tpu_torch.data.common.metadata import NEGATIVE_CLASS, UNKNOWN_TRANSCRIPTION, AudioClipMetadata
from howl_tpu_torch.data.common.sample import Sample
from howl_tpu_torch.data.common.tokenizer import TokenType, WakeWordTokenizer
from howl_tpu_torch.data.common.vocab import Vocab, VocabTrie

__all__ = [
    "AudioClipMetadata",
    "ClassificationBatch",
    "FrameLabelData",
    "NEGATIVE_CLASS",
    "Sample",
    "SequenceBatch",
    "TokenType",
    "UNKNOWN_TRANSCRIPTION",
    "Vocab",
    "VocabTrie",
    "WakeWordTokenizer",
]
