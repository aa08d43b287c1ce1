"""Structured config tree (counterpart of ``howl_tpu/config.py``; ref:
howl/config.py).

JSON-serializable dataclasses for the config-driven path. The env-var
``SETTINGS`` remain the canonical runtime knobs;
``TrainingConfig.apply_to_settings()`` materializes a config into them so
both paths share one implementation. The classes, their fields and their
JSON are the JAX package's: a config written by either package parses in
the other. ``SETTINGS.training.device`` has no field here, as in the JAX
package: the device is the entry point's ``--device``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


def _from_dict(cls, data: dict):
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints.get(f.name)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = _from_dict(ftype, value)
        elif f.name.endswith("datasets") and isinstance(value, list):
            value = [_from_dict(DatasetConfig, v) if isinstance(v, dict) else v for v in value]
        kwargs[f.name] = value
    return cls(**kwargs)


class _JsonMixin:
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, data: dict):
        return _from_dict(cls, data)

    @classmethod
    def parse_file(cls, path):
        return cls.from_dict(json.loads(Path(path).read_text()))


@dataclass
class CacheConfig(_JsonMixin):
    cache_size: int = 128144


@dataclass
class AudioConfig(_JsonMixin):
    sample_rate: int = 16000
    use_mono: bool = True


@dataclass
class ContextConfig(_JsonMixin):
    seed: int = 0
    vocab: Optional[List[str]] = None
    sequence: Optional[List[int]] = None
    token_type: str = "word"
    phone_dictionary_path: Optional[str] = None


@dataclass
class InferenceEngineConfig(_JsonMixin):
    # NOTE: the reference declares a ``per_frame`` flag here (ref
    # howl/config.py:36) that nothing reads — engine cadence is decided by the
    # model family (per-window for static models, whole-clip for sequential
    # ones; inference/engine.py score_batch). We drop the decorative flag;
    # tests/test_torch_config.py enforces that every remaining field has a
    # real consumer. ``from_dict`` ignores unknown keys, so reference JSON
    # configs containing ``per_frame`` still parse.
    inference_weights: Optional[List[float]] = None
    inference_window_ms: float = 2000.0
    smoothing_window_ms: float = 50.0
    tolerance_window_ms: float = 500.0
    inference_threshold: float = 0.0


@dataclass
class AudioTransformConfig(_JsonMixin):
    num_fft: int = 512
    num_mels: int = 40
    hop_length: int = 200
    use_meyda_spectrogram: bool = False


@dataclass
class DatasetConfig(_JsonMixin):
    path: Optional[str] = None
    audio_config: AudioConfig = field(default_factory=AudioConfig)
    audio_transform_config: AudioTransformConfig = field(default_factory=AudioTransformConfig)


@dataclass
class ModelConfig(_JsonMixin):
    architecture: str = "res8"


@dataclass
class TrainingConfig(_JsonMixin):
    batch_size: int = 16
    learning_rate: float = 0.01
    num_epochs: int = 10
    lr_decay: float = 0.955
    weight_decay: float = 0.00001
    objective: str = "frame"
    max_window_size_seconds: float = 0.5
    eval_window_size_seconds: float = 0.5
    eval_stride_size_seconds: float = 0.063
    use_noise_dataset: bool = False
    noise_datasets: List[DatasetConfig] = field(default_factory=list)
    train_datasets: List[DatasetConfig] = field(default_factory=list)
    val_datasets: List[DatasetConfig] = field(default_factory=list)
    test_datasets: List[DatasetConfig] = field(default_factory=list)
    inference_engine_config: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    cache_config: CacheConfig = field(default_factory=CacheConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    context_config: ContextConfig = field(default_factory=ContextConfig)
    workspace_path: Optional[str] = None
    seed: int = 0

    def apply_to_settings(self, settings=None):
        """Materialize this config into the global SETTINGS sections so the
        env-var and config-driven paths share one training implementation."""
        from howl_tpu_torch.settings import SETTINGS as GLOBAL

        settings = settings or GLOBAL
        settings.reset()
        tr = settings.training
        tr.batch_size = self.batch_size
        tr.learning_rate = self.learning_rate
        tr.num_epochs = self.num_epochs
        tr.lr_decay = self.lr_decay
        tr.weight_decay = self.weight_decay
        tr.objective = self.objective
        tr.max_window_size_seconds = self.max_window_size_seconds
        tr.eval_window_size_seconds = self.eval_window_size_seconds
        tr.eval_stride_size_seconds = self.eval_stride_size_seconds
        tr.use_noise_dataset = self.use_noise_dataset
        tr.seed = self.seed
        settings.cache.cache_size = self.cache_config.cache_size
        if self.context_config.vocab:
            tr.vocab = list(self.context_config.vocab)
        tr.token_type = self.context_config.token_type
        tr.phone_dictionary = self.context_config.phone_dictionary_path
        if self.noise_datasets and self.noise_datasets[0].path:
            tr.noise_dataset_path = self.noise_datasets[0].path
        eng = settings.inference_engine
        cfg = self.inference_engine_config
        eng.inference_weights = cfg.inference_weights
        eng.inference_window_ms = cfg.inference_window_ms
        eng.smoothing_window_ms = cfg.smoothing_window_ms
        eng.tolerance_window_ms = cfg.tolerance_window_ms
        eng.inference_threshold = cfg.inference_threshold
        if self.context_config.sequence:
            eng.inference_sequence = list(self.context_config.sequence)
        at = settings.audio_transform
        if self.train_datasets:
            ds = self.train_datasets[0]
            at.num_fft = ds.audio_transform_config.num_fft
            at.num_mels = ds.audio_transform_config.num_mels
            at.hop_length = ds.audio_transform_config.hop_length
            at.use_meyda_spectrogram = ds.audio_transform_config.use_meyda_spectrogram
            settings.audio.sample_rate = ds.audio_config.sample_rate
            # the mel frontend builds its filterbank from
            # audio_transform.sample_rate (FrontendConfig.from_settings) —
            # keep it in lockstep or non-16k configs get a 16k filterbank
            at.sample_rate = ds.audio_config.sample_rate
            settings.audio.use_mono = ds.audio_config.use_mono
        return settings


@dataclass
class InferenceConfig(_JsonMixin):
    inference_engine_config: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    context_config: ContextConfig = field(default_factory=ContextConfig)
