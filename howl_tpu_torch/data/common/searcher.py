"""Transcript searchers: does a transcript contain the wakeword / any vocab word.

Behavioral parity with ref howl/data/common/searcher.py:20,74,122 (verified by
the differential tests in tests/test_reference_parity.py), restructured around
a shared color-grouping helper rather than the reference's statement flow.

One deliberate fix over the reference: ``WordTranscriptSearcher.search``
matches the encoded label *sequence* as a contiguous sublist. The reference
joins label ids into a digit string and substring-matches, which false-fires
for vocabularies with >=10 labels (e.g. sequence [0,1] "01" matches encoded
[0,12] "012"). Identical behavior for every realistic wakeword vocab.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

from howl_tpu_torch.data.common.phone import PhonePhrase
from howl_tpu_torch.data.common.tokenizer import WakeWordTokenizer
from howl_tpu_torch.data.common.vocab import Vocab
from howl_tpu_torch.utils.logger import Logger


class LabelColoring:
    """Groups labels into word-level 'colors' (ref: searcher.py:20-57).

    Every paint operation claims a color at least as large as any seen so far
    and advances the counter past it, so auto-assigned colors never collide
    with explicit ones.
    """

    def __init__(self):
        self.color_map: Dict[int, int] = {}
        self.color_counter = 0
        self.label_counter = 0

    def _paint(self, labels: Iterable[int], color: Optional[int]) -> int:
        chosen = self.color_counter if color is None else color
        self.color_counter = max(self.color_counter, chosen) + 1
        for label in labels:
            self.color_map[label] = chosen
            self.label_counter = max(self.label_counter, label + 1)
        return chosen

    def append_label(self, label: int, color: int = None):
        """Color a single label; re-appending is a no-op unless the color conflicts."""
        if label in self.color_map:
            registered = self.color_map[label]
            if color is not None and color != registered:
                raise RuntimeError(f"label {label} already registered with color {registered}, got {color}")
            return
        self._paint((label,), color)

    def extend_sequence(self, size: int, color: int = None):
        """Color the next ``size`` fresh labels with one shared color."""
        self._paint(range(self.label_counter, self.label_counter + size), color)

    @classmethod
    def sequential_coloring(cls, num_labels: int) -> "LabelColoring":
        coloring = cls()
        for label in range(num_labels):
            coloring.append_label(label)
        return coloring


class TranscriptSearcher:
    def __init__(self, inference_sequence: List[int] = None):
        if inference_sequence is None:
            from howl_tpu_torch.settings import SETTINGS

            inference_sequence = SETTINGS.inference_engine.inference_sequence
        self.inference_sequence = list(inference_sequence)

    def search(self, item: str) -> bool:
        raise NotImplementedError

    def contains_any(self, item: str) -> bool:
        raise NotImplementedError


class WordTranscriptSearcher(TranscriptSearcher):
    """Wakeword-subsequence search over encoded transcripts (ref: searcher.py:74-120)."""

    def __init__(self, vocab: Vocab, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab
        self.tokenizer = WakeWordTokenizer(self.vocab, ignore_oov=False)

    def search(self, item: str) -> bool:
        """True when the inference sequence appears as consecutive encoded labels."""
        encoded = self.tokenizer.encode(item)
        seq, k = self.inference_sequence, len(self.inference_sequence)
        return any(encoded[i : i + k] == seq for i in range(len(encoded) - k + 1))

    def contains_any(self, item: str) -> bool:
        return any(e != self.vocab.oov_token_id for e in self.tokenizer.encode(item))

    def count_vocab(self, item: str, ignore_oov: bool = True) -> dict:
        counter = {self.vocab[i]: 0 for i in range(len(self.vocab))}
        for encoding in self.tokenizer.encode(item):
            if not (ignore_oov and encoding == self.vocab.oov_token_id):
                counter[self.vocab[encoding]] += 1
        return counter


class PhoneticTranscriptSearcher(TranscriptSearcher):
    """Regex search over audible phone transcripts (ref: searcher.py:122-144).

    The wakeword pattern is one alternation group per color (phrases sharing a
    color are alternatives for the same word), arranged in inference-sequence
    order, separated by single spaces, anywhere in the transcript.
    """

    def __init__(self, phrases: List[PhonePhrase], coloring: LabelColoring, **kwargs):
        super().__init__(**kwargs)
        self.phrases = phrases
        groups = self._alternations_by_color_rank(phrases, coloring)
        body = " ".join(groups[rank] for rank in self.inference_sequence)
        pattern = f"^.*{body}.*$"
        Logger.debug(f"phonetic search pattern: {pattern}")
        self.pattern = re.compile(pattern)

    @staticmethod
    def _alternations_by_color_rank(phrases: List[PhonePhrase], coloring: LabelColoring) -> List[str]:
        """One regex alternation per color, ordered by ascending color value."""
        transcripts = [p.audible_transcript for p in phrases]
        colors = [coloring.color_map[idx] for idx in range(len(phrases))]
        return [
            "(" + "|".join(f"({t})" for t, c in zip(transcripts, colors) if c == color) + ")"
            for color in sorted(set(colors))
        ]

    def search(self, item: str) -> bool:
        transcript = PhonePhrase.from_string(item).audible_transcript
        return self.pattern.match(transcript) is not None

    def contains_any(self, item: str) -> bool:
        transcript = PhonePhrase.from_string(item).audible_transcript
        return any(word.audible_transcript in transcript for word in self.phrases)
