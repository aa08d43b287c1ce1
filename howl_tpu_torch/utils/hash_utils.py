"""Deterministic hashing for dataset bucketing (ref: howl/utils/hash_utils.py:6,20)."""

from __future__ import annotations

import hashlib


def sha256_int(value: str) -> int:
    """Stable integer hash of a string (used for percentage bucketing)."""
    return int(hashlib.sha256(str(value).encode()).hexdigest(), 16)


class Sha256Splitter:
    """Predicate: ``sha256(x) % 100 < target_pct`` — stable dataset splits.

    Matches the reference semantics so datasets regenerated here land in the
    same train/dev/test buckets as the reference pipeline.
    """

    def __init__(self, target_pct: int):
        self.target_pct = target_pct

    def __call__(self, x) -> bool:
        # dataset.split passes AudioClipMetadata objects; bucket by the clip
        # path so the bucket is stable across metadata changes (transcription,
        # alignments) and matches path-keyed reference bucketing
        return (sha256_int(str(getattr(x, "path", x))) % 100) < self.target_pct
