"""Transcript tokenizers (ref: howl/data/common/tokenizer.py:10,29)."""

from __future__ import annotations

from enum import Enum, unique
from typing import List

from howl_tpu_torch.data.common.vocab import Vocab


@unique
class TokenType(str, Enum):
    PHONE = "phone"
    WORD = "word"


class TranscriptTokenizer:
    def encode(self, transcript: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError


class WakeWordTokenizer(TranscriptTokenizer):
    """Word-level transcript -> label id sequence via longest-prefix trie.

    ``ignore_oov=False`` emits the OOV id for non-vocab words (used by the CTC
    objective and the transcript searcher; ref tokenizer.py:29-55).
    """

    def __init__(self, vocab: Vocab, ignore_oov: bool = True):
        self.vocab = vocab
        self.ignore_oov = ignore_oov

    def encode(self, transcript: str) -> List[int]:
        encoded = []
        for word in transcript.lower().split():
            matched, rest = self.vocab.trie.max_split(word)
            if matched and rest == "":
                encoded.append(self.vocab[word])
            elif not self.ignore_oov:
                if self.vocab.oov_token_id is None:
                    raise ValueError("label for oov word is not specified")
                encoded.append(self.vocab.oov_token_id)
        return encoded

    def decode(self, ids: List[int]) -> str:
        return " ".join(str(self.vocab[i]) for i in ids)
