"""Minimal Praat TextGrid parser (long text format, as emitted by the Montreal
Forced Aligner). Replaces the third-party ``praat-textgrids`` dependency the
reference uses (ref: training/align/mfa.py imports textgrids.TextGrid).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List


@dataclass
class TextGridInterval:
    xmin: float
    xmax: float
    text: str


@dataclass
class TextGrid:
    """Maps tier name -> list of intervals. ``grid["words"]`` like the lib."""

    tiers: Dict[str, List[TextGridInterval]] = field(default_factory=dict)

    def __getitem__(self, name: str) -> List[TextGridInterval]:
        return self.tiers[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tiers

    @classmethod
    def parse(cls, text: str) -> "TextGrid":
        grid = cls()
        tier_name = None
        current: dict = {}

        def flush_interval():
            nonlocal current
            if tier_name is not None and {"xmin", "xmax", "text"} <= set(current):
                grid.tiers[tier_name].append(
                    TextGridInterval(float(current["xmin"]), float(current["xmax"]), current["text"])
                )
            current = {}

        in_intervals = False
        for raw in text.splitlines():
            line = raw.strip()
            m = re.match(r'name\s*=\s*"(.*)"', line)
            if m:
                flush_interval()
                tier_name = m.group(1)
                grid.tiers.setdefault(tier_name, [])
                in_intervals = False
                continue
            if re.match(r"intervals\s*\[\d+\]", line) or re.match(r"points\s*\[\d+\]", line):
                flush_interval()
                in_intervals = True
                continue
            if in_intervals:
                m = re.match(r"(xmin|xmax|number)\s*=\s*([-\d.eE]+)", line)
                if m:
                    key = "xmin" if m.group(1) == "number" else m.group(1)
                    current[key] = m.group(2)
                    if m.group(1) == "number":
                        current["xmax"] = m.group(2)
                    continue
                m = re.match(r'(text|mark)\s*=\s*"(.*)"', line)
                if m:
                    current["text"] = m.group(2)
                    continue
        flush_interval()
        return grid

    @classmethod
    def from_file(cls, path: Path) -> "TextGrid":
        return cls.parse(Path(path).read_text(encoding="utf-8", errors="replace"))
