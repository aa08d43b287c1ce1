"""Phoneme data model + CMUdict parsing (ref: howl/data/common/phone.py:20,39,145)."""

from __future__ import annotations

import enum
from collections import defaultdict
from pathlib import Path
from typing import List, Mapping


class PhoneEnum(enum.Enum):
    SILENCE = "sil"
    SILENCE_OPTIONAL = "sp"
    SPEECH_UNKNOWN = "spn"


_NON_SPEECH = {PhoneEnum.SILENCE.value, PhoneEnum.SILENCE_OPTIONAL.value, PhoneEnum.SPEECH_UNKNOWN.value}


class Phone:
    """A single (lower-cased) phone; silence/sp/spn are non-speech."""

    __slots__ = ("text", "is_speech")

    def __init__(self, text: str):
        self.text = text.lower().strip()
        self.is_speech = self.text not in _NON_SPEECH

    def __str__(self):
        return self.text

    def __repr__(self):
        return f"Phone({self.text!r})"

    def __eq__(self, other):
        return isinstance(other, Phone) and other.text == self.text

    def __hash__(self):
        return hash(self.text)


class PhonePhrase:
    """A sequence of phones with audible-index arithmetic (ref: phone.py:39-143)."""

    def __init__(self, phones: List[Phone]):
        self.phones = phones

    @property
    def text(self) -> str:
        return str(self)

    @property
    def audible_phones(self) -> List[Phone]:
        return [x for x in self.phones if x.is_speech]

    @property
    def audible_transcript(self) -> str:
        return " ".join(x.text for x in self.audible_phones)

    @property
    def sil_indices(self) -> List[int]:
        return [idx for idx, x in enumerate(self.phones) if not x.is_speech]

    @classmethod
    def from_string(cls, string: str) -> "PhonePhrase":
        return cls([Phone(x) for x in string.split()])

    def extend(self, other: "PhonePhrase"):
        self.phones.extend(other.phones)

    def __str__(self):
        return " ".join(x.text for x in self.phones)

    def __len__(self):
        return len(self.phones)

    def all_idx_to_transcript_idx(self, phone_idx: int) -> int:
        """Character index in ``str(self)`` where phone ``phone_idx`` ends."""
        if phone_idx >= len(self.phones):
            raise ValueError(f"phone idx {phone_idx} out of bounds ({len(self.phones)} phones)")
        chars = sum(len(p.text) for p in self.phones[: phone_idx + 1])
        return chars + phone_idx  # account for separating spaces

    def audible_idx_to_all_idx(self, audible_idx: int) -> int:
        """Map an index over audible phones to an index over all phones."""
        if audible_idx >= len(self.audible_phones):
            raise ValueError(
                f"audible idx {audible_idx} out of bounds ({len(self.audible_phones)} audible phones)"
            )
        offset = 0
        for sil_idx in self.sil_indices:
            if sil_idx <= audible_idx + offset:
                offset += 1
        return offset + audible_idx

    def audible_index(self, query: "PhonePhrase", start: int = 0) -> int:
        """First audible index >= start where ``query``'s audible phones occur."""
        query_phones = query.audible_phones
        if not query_phones:
            raise ValueError(f"query phrase has empty audible_phones: {query.audible_transcript}")
        mine = self.audible_phones
        for idx in range(start, len(mine) - len(query_phones) + 1):
            if all(a == b for a, b in zip(query_phones, mine[idx : idx + len(query_phones)])):
                return idx
        raise ValueError(f"query phrase is not found: {query.audible_transcript}")


class PronunciationDictionary:
    """CMUdict-style word -> pronunciations mapping (ref: phone.py:145-171)."""

    def __init__(self, data_dict: Mapping[str, List[PhonePhrase]]):
        self.word2phone = dict(data_dict)

    def __contains__(self, key: str) -> bool:
        return key.strip().lower() in self.word2phone

    def encode(self, word: str) -> List[PhonePhrase]:
        word = word.strip().lower()
        if word not in self.word2phone:
            raise ValueError(f"word is not in the dictionary: {word}")
        return self.word2phone[word]

    @classmethod
    def from_file(cls, filename: Path) -> "PronunciationDictionary":
        data = defaultdict(list)
        with Path(filename).open(encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith(";") or not line.strip():
                    continue
                parts = line.split(maxsplit=1)
                if len(parts) != 2:
                    continue
                word, pronunciation = parts
                data[word.lower()].append(PhonePhrase.from_string(pronunciation.strip().lower()))
        return cls(data)
