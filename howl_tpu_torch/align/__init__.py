"""Forced-alignment providers (ref: training/align/)."""

from howl_tpu_torch.align.base import AlignedTranscription, Aligner
from howl_tpu_torch.align.mfa import MfaTextGridConverter
from howl_tpu_torch.align.stub import StubAligner
from howl_tpu_torch.align.textgrid import TextGrid, TextGridInterval
from howl_tpu_torch.align.vad import LeftRightVadAligner

__all__ = [
    "AlignedTranscription",
    "Aligner",
    "LeftRightVadAligner",
    "MfaTextGridConverter",
    "StubAligner",
    "TextGrid",
    "TextGridInterval",
]
