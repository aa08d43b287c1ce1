"""Audio clip metadata record (ref: howl/data/common/metadata.py:15).

The jsonl on-disk schema is kept byte-compatible with the reference
(`path`, `transcription`, `end_timestamps`, `phone_strings`, ...) so datasets
generated by either implementation interoperate.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import List, Optional

UNKNOWN_TRANSCRIPTION = "[UNKNOWN]"
NEGATIVE_CLASS = "[NEGATIVE]"


@dataclass
class AudioClipMetadata:
    path: Path = Path(".")
    transcription: str = ""
    end_timestamps: Optional[List[float]] = None  # per-character word-end times (ms)
    phone_strings: Optional[List[str]] = None
    words: Optional[List[str]] = None
    phone_end_timestamps: Optional[List[float]] = None
    extra: dict = field(default_factory=dict)  # forward-compat passthrough

    def __post_init__(self):
        self.path = Path(self.path)
        if self.transcription is None:
            self.transcription = ""

    @property
    def audio_id(self) -> str:
        return self.path.name.split(".", 1)[0]

    @property
    def phone_phrase(self):
        from howl_tpu_torch.data.common.phone import Phone, PhonePhrase

        return PhonePhrase([Phone(x) for x in self.phone_strings]) if self.phone_strings else None

    def to_json(self) -> str:
        data = asdict(self)
        data["path"] = str(self.path)
        extra = data.pop("extra", None) or {}
        data = {k: v for k, v in data.items() if v is not None}
        data.update(extra)
        return json.dumps(data)

    @classmethod
    def from_json(cls, line: str) -> "AudioClipMetadata":
        raw = json.loads(line)
        known = {f for f in cls.__dataclass_fields__ if f != "extra"}  # noqa: SLF001
        kwargs = {k: v for k, v in raw.items() if k in known}
        extra = {k: v for k, v in raw.items() if k not in known}
        return cls(extra=extra, **kwargs)
