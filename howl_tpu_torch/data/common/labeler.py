"""Frame labelers: transcript + char timestamps -> FrameLabelData.

(ref: howl/data/common/labeler.py:14,29,156)
"""

from __future__ import annotations

import string
from pathlib import Path
from typing import List

from howl_tpu_torch.data.common.label import FrameLabelData
from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.common.phone import PhoneEnum, PhonePhrase, PronunciationDictionary
from howl_tpu_torch.data.common.vocab import Vocab
from howl_tpu_torch.utils.logger import Logger


class FrameLabeler:
    def compute_frame_labels(self, metadata: AudioClipMetadata) -> FrameLabelData:
        raise NotImplementedError


class WordFrameLabeler(FrameLabeler):
    """Walks transcript words; vocab hits emit (word-end timestamp -> label).

    Uses the per-character ``end_timestamps`` attached by alignment
    (ref: labeler.py:156-182).
    """

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def compute_frame_labels(self, metadata: AudioClipMetadata) -> FrameLabelData:
        frame_labels = {}
        start_timestamp = []
        char_indices = []
        char_idx = 0
        end_ts = metadata.end_timestamps or []
        for word in metadata.transcription.split():
            matched, rest = self.vocab.trie.max_split(word)
            word_size = len(word.rstrip())
            if matched and rest == "":
                if char_idx + word_size - 1 >= len(end_ts):
                    # silently skipping would label a clip that CONTAINS the
                    # wakeword as all-negative and train the model not to
                    # fire; the reference fails loudly here too (IndexError/
                    # TypeError at labeler.py:175)
                    raise ValueError(
                        f"word {word!r} matched the vocab but end_timestamps "
                        f"({len(end_ts)} entries) do not cover its characters in "
                        f"{metadata.path}: attach alignments (attach_alignment) "
                        "before labeling"
                    )
                label = self.vocab[word]
                frame_labels[end_ts[char_idx + word_size - 1]] = label
                char_indices.append((label, list(range(char_idx, char_idx + word_size))))
                start_timestamp.append((label, end_ts[char_idx - 1] if char_idx > 0 else 0.0))
            char_idx += word_size + 1  # +1 for the space
        return FrameLabelData(frame_labels, start_timestamp, char_indices)


class PhoneticFrameLabeler(FrameLabeler):
    """Greedy longest-match decomposition of transcript words into phones,
    then sub-phrase search for each target phrase (ref: labeler.py:29-150)."""

    def __init__(self, phrases: List[PhonePhrase], pronounce_dict: PronunciationDictionary):
        self.phrases = phrases
        self.pronounce_dict = pronounce_dict
        punctuation_to_replace = str.maketrans(
            {"‘": "'", "’": "'", "”": '"', "“": '"', "—": "-", "ä": "a", "ö": "o", "ō": "o", "é": "e", "à": "a"}
        )
        punctuation_to_remove = str.maketrans({key: None for key in string.punctuation})
        self.punctuation_transforms = [None, punctuation_to_replace, punctuation_to_remove]

    def transform(self, original_word: str) -> PhonePhrase:
        """Greedy longest dictionary-prefix decomposition of a word into phones."""
        phrases = PhonePhrase([])
        word = original_word
        idx = len(word)
        while idx > 0:
            while idx > 0 and word[:idx] not in self.pronounce_dict:
                idx -= 1
            if idx == 0:
                if word == "<unk>":
                    phrases.extend(PhonePhrase.from_string(PhoneEnum.SPEECH_UNKNOWN.value))
                    break
                raise ValueError(f"cannot break {original_word!r} into phonemes")
            phrases.extend(self.pronounce_dict.encode(word[:idx])[0])
            word = word[idx:]
            idx = len(word)
        return phrases

    def compute_frame_labels(self, metadata: AudioClipMetadata) -> FrameLabelData:
        frame_labels = {}
        phonetic_transcription = PhonePhrase([])
        for original_word in metadata.transcription.split():
            phrase = None
            for punct_transform in self.punctuation_transforms:
                if punct_transform is not None:
                    original_word = original_word.translate(punct_transform)
                    if not original_word:
                        break
                try:
                    phrase = self.transform(original_word)
                    break
                except ValueError:
                    pass
            if phrase:
                phonetic_transcription.extend(phrase)
            elif original_word:
                Logger.debug(f"failed to find phonemes for {original_word!r}")

        # KNOWN APPROXIMATION (reference-identical, ref labeler.py:140-148
        # with its own TODOs): ``start`` is an audible-PHONE index but
        # end_timestamps are per-CHARACTER, so the chosen timestamp lands
        # early/mid-word rather than at the phrase end. Kept for behavior
        # parity; out-of-range indices warn instead of the reference's
        # IndexError so partially-aligned corpora still process.
        end_ts = metadata.end_timestamps or []
        for idx, phrase in enumerate(self.phrases):
            start = 0
            while True:
                try:
                    start = phonetic_transcription.audible_index(phrase, start)
                except ValueError:
                    break
                if start < len(end_ts):
                    frame_labels[end_ts[start]] = idx
                else:
                    Logger.warning(
                        f"phone phrase {idx} found at audible index {start} but "
                        f"end_timestamps has {len(end_ts)} entries ({metadata.path}); "
                        "label dropped — re-align the clip"
                    )
                start += 1
        return FrameLabelData(frame_labels, [], [])


def labeler_from_pronunciation_file(phrases: List[PhonePhrase], path: Path) -> PhoneticFrameLabeler:
    return PhoneticFrameLabeler(phrases, PronunciationDictionary.from_file(path))
