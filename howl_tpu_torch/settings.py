"""Environment-overridable global settings (counterpart of ``howl_tpu/settings.py``).

Capability parity with the reference's lazy settings singleton
(ref: howl/settings.py:80-170): every field can be overridden through an
environment variable named after the upper-cased field name, so the canonical
hyperparameter recipes in the reference's ``envs/*.env`` files keep working
(e.g. ``NUM_MELS=40 VOCAB='["hey","fire","fox"]' INFERENCE_SEQUENCE=[0,1,2]``).

Unlike the reference we do not depend on pydantic BaseSettings; a small
dataclass-based loader coerces env strings (JSON for containers, literal for
scalars) which keeps import time trivial and the dependency surface to stdlib.

The fields, their environment variables and defaults are the JAX package's,
but for ``TrainingSettings.device``: ``"cuda"`` here, the card the port
trains on (the JAX package's default is ``"tpu"``). ``"cpu"`` is the only
other device the port's entry points take.
"""

from __future__ import annotations

import dataclasses
import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field, fields
from typing import Any, List, Optional


def _coerce(raw: str, ty: Any) -> Any:
    """Coerce an environment-variable string to the annotated field type."""
    origin = getattr(ty, "__origin__", None)
    if ty is bool or ty == Optional[bool]:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if ty is int or ty == Optional[int]:
        return int(raw)
    if ty is float or ty == Optional[float]:
        return float(raw)
    if ty is str or ty == Optional[str]:
        return raw
    if origin in (list, tuple) or "List" in str(ty) or "Tuple" in str(ty):
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            # bare comma/space separated fallback: VOCAB=hey,fire,fox
            val = [x for x in raw.replace(",", " ").split() if x]
        return list(val) if origin is not tuple else tuple(val)
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


class EnvSettings:
    """Mixin: dataclass whose fields read ``UPPER_SNAKE`` env-var overrides."""

    @classmethod
    def from_env(cls, **overrides):
        import typing

        hints = typing.get_type_hints(cls)
        kwargs = dict(overrides)
        for f in fields(cls):
            env_name = f.name.upper()
            if f.name not in kwargs and env_name in os.environ:
                kwargs[f.name] = _coerce(os.environ[env_name], hints.get(f.name, str))
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ResourceSettings(EnvSettings):
    """Host-side parallelism knobs (ref: howl/settings.py:9)."""

    cpu_count: int = max((os.cpu_count() or 1) // 2, 1)


@dataclass
class CacheSettings(EnvSettings):
    """Decoded-audio LRU cache entries (ref: howl/settings.py:15)."""

    cache_size: int = 128144


@dataclass
class AudioSettings(EnvSettings):
    """PCM format contract for the whole system (ref: howl/settings.py:21)."""

    sample_rate: int = 16000
    use_mono: bool = True


@dataclass
class AudioTransformSettings(EnvSettings):
    """Log-mel frontend geometry (ref: howl/settings.py:28).

    ``num_fft=512, hop_length=200`` at 16 kHz -> 80 frames/second.
    """

    num_fft: int = 512
    num_mels: int = 80
    sample_rate: int = 16000
    hop_length: int = 200
    use_meyda_spectrogram: bool = False


@dataclass
class InferenceEngineSettings(EnvSettings):
    """Posterior smoothing + FSM sequence-matching knobs (ref: howl/settings.py:38)."""

    inference_weights: Optional[List[float]] = None
    inference_sequence: List[int] = field(default_factory=lambda: [0])
    inference_window_ms: float = 2000.0  # FSM looks at labels within this window
    smoothing_window_ms: float = 50.0  # posteriors max-pooled over this window
    tolerance_window_ms: float = 500.0  # non-sequence labels tolerated this long
    inference_threshold: float = 0.0  # posterior must exceed this to emit a label


@dataclass
class TrainingSettings(EnvSettings):
    """Training hyperparameters (ref: howl/settings.py:49)."""

    seed: int = 0
    vocab: List[str] = field(default_factory=lambda: ["fire"])
    num_epochs: int = 10
    num_labels: int = 2
    learning_rate: float = 1e-3
    device: str = "cuda"  # "cuda" or "cpu"; the reference used cuda:0
    batch_size: int = 16
    lr_decay: float = 0.955
    max_window_size_seconds: float = 0.75
    eval_window_size_seconds: float = 0.75
    eval_stride_size_seconds: float = 0.063
    weight_decay: float = 0.0
    convert_static: bool = False
    objective: str = "frame"  # 'frame' (CE over window labels) or 'ctc'
    token_type: str = "word"  # 'word' or 'phone'
    phone_dictionary: Optional[str] = None
    use_noise_dataset: bool = False
    noise_dataset_path: Optional[str] = None


@dataclass
class DatasetSettings(EnvSettings):
    """Default dataset path (ref: howl/settings.py:75)."""

    dataset_path: Optional[str] = None


_KEY_TO_SETTINGS_CLASS = {
    "_resource": ResourceSettings,
    "_cache": CacheSettings,
    "_audio": AudioSettings,
    "_audio_transform": AudioTransformSettings,
    "_inference_engine": InferenceEngineSettings,
    "_training": TrainingSettings,
    "_dataset": DatasetSettings,
}


class HowlSettings:
    """Lazy global settings container (ref: howl/settings.py:80).

    Sections are constructed on first access so env vars set after import
    (e.g. by test fixtures or ``envs/*.env`` sourcing) are still honored.
    """

    def __init__(self):
        for key in _KEY_TO_SETTINGS_CLASS:
            setattr(self, key, None)

    def _get(self, key: str):
        val = getattr(self, key)
        if val is None:
            val = _KEY_TO_SETTINGS_CLASS[key].from_env()
            setattr(self, key, val)
        return val

    @property
    def resource(self) -> ResourceSettings:
        return self._get("_resource")

    @property
    def cache(self) -> CacheSettings:
        return self._get("_cache")

    @property
    def audio(self) -> AudioSettings:
        return self._get("_audio")

    @property
    def audio_transform(self) -> AudioTransformSettings:
        return self._get("_audio_transform")

    @property
    def inference_engine(self) -> InferenceEngineSettings:
        return self._get("_inference_engine")

    @property
    def training(self) -> TrainingSettings:
        return self._get("_training")

    @property
    def dataset(self) -> DatasetSettings:
        return self._get("_dataset")

    def reset(self):
        """Re-read every section from the environment (ref: howl/settings.py:140)."""
        for key in _KEY_TO_SETTINGS_CLASS:
            setattr(self, key, None)

    @contextmanager
    def scoped(self, **section_overrides):
        """Apply explicit per-section field overrides for a ``with`` block.

        The in-process replacement for the reference harnesses' pattern of
        exporting env vars per child process (ref: training/run/
        eval_wake_word_detection.py:187-207) — overrides are plain typed
        values, nothing touches ``os.environ``, and the previous sections are
        restored on exit (even on error)::

            with SETTINGS.scoped(training={"seed": 3, "num_epochs": 20}):
                ...
        """
        saved = {}
        for name, over in section_overrides.items():
            key = "_" + name
            if key not in _KEY_TO_SETTINGS_CLASS:
                raise KeyError(f"unknown settings section: {name!r}")
            saved[key] = getattr(self, key)
            setattr(self, key, dataclasses.replace(self._get(key), **dict(over)))
        try:
            yield self
        finally:
            for key, val in saved.items():
                setattr(self, key, val)

    def to_dict(self) -> dict:
        return {key.lstrip("_"): self._get(key).to_dict() for key in _KEY_TO_SETTINGS_CLASS}

    def load_dict(self, data: dict):
        """Restore a settings snapshot previously produced by ``to_dict``."""
        for key, cls in _KEY_TO_SETTINGS_CLASS.items():
            section = data.get(key.lstrip("_"))
            if section is not None:
                known = {f.name for f in fields(cls)}
                setattr(self, key, cls(**{k: v for k, v in section.items() if k in known}))

    def __repr__(self):
        rep = "Howl Settings:\n"
        for key in _KEY_TO_SETTINGS_CLASS:
            rep += f"  {key.lstrip('_')}: {getattr(self, key)}\n"
        return rep


SETTINGS = HowlSettings()
