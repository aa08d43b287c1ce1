"""The port's config tree (howl_tpu_torch/config.py) and the workspace's
config snapshot against howl_tpu's.

* JSON round trips both ways across the packages: a config either package
  writes parses in the other into the same dict.
* ``apply_to_settings`` leaves the port's ``SETTINGS`` equal to JAX's,
  section by section (``training.device`` aside: the JAX default names its
  platform, the port's the card, and neither config carries it).
* Every field of the port's config dataclasses is read somewhere in the
  port, as tests/test_config_consumption.py holds the JAX package to it.
* ``Workspace.save_config`` / ``load_config``, on a file the port writes and
  on one JAX's workspace writes.
All comparisons are exact: the values are the configs' own.
"""

import json
from pathlib import Path

import pytest

from howl_tpu import config as jconfig
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu.workspace import Workspace as JWorkspace
from howl_tpu_torch import config as tconfig
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.workspace import Workspace as TWorkspace
from tests.test_config_consumption import _attribute_reads, _dataclass_fields

PORT = Path(__file__).resolve().parent.parent / "howl_tpu_torch"


def _full(mod):
    """A config with every section away from its defaults."""
    return mod.TrainingConfig(
        batch_size=8, learning_rate=0.02, num_epochs=3, lr_decay=0.98, weight_decay=1e-4, objective="ctc",
        max_window_size_seconds=0.75, eval_window_size_seconds=0.6, eval_stride_size_seconds=0.05,
        use_noise_dataset=True,
        noise_datasets=[mod.DatasetConfig(path="/data/noise")],
        train_datasets=[mod.DatasetConfig(
            path="/data/ww", audio_config=mod.AudioConfig(sample_rate=8000, use_mono=False),
            audio_transform_config=mod.AudioTransformConfig(num_fft=256, num_mels=80, hop_length=100,
                                                            use_meyda_spectrogram=True))],
        val_datasets=[mod.DatasetConfig(path="/data/ww")], test_datasets=[mod.DatasetConfig(path="/data/other")],
        inference_engine_config=mod.InferenceEngineConfig(inference_weights=[1.0, 2.0], inference_window_ms=1500.0,
                                                          smoothing_window_ms=40.0, tolerance_window_ms=400.0,
                                                          inference_threshold=0.6),
        cache_config=mod.CacheConfig(cache_size=77),
        model_config=mod.ModelConfig(architecture="seq-lstm"),
        context_config=mod.ContextConfig(seed=3, vocab=["hey", "fire", "fox"], sequence=[0, 1, 2], token_type="phone",
                                         phone_dictionary_path="/data/dict.txt"),
        workspace_path="/tmp/ws", seed=5,
    )


@pytest.fixture(autouse=True)
def _reset_settings():
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    yield
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.mark.parametrize("which", ["default", "full"])
def test_json_round_trips_both_ways(which):
    jcfg = jconfig.TrainingConfig() if which == "default" else _full(jconfig)
    tcfg = tconfig.TrainingConfig() if which == "default" else _full(tconfig)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.json(indent=2) == jcfg.json(indent=2)
    from_jax = tconfig.TrainingConfig.from_dict(json.loads(jcfg.json()))
    assert from_jax == tcfg and type(from_jax.inference_engine_config) is tconfig.InferenceEngineConfig
    assert all(type(d) is tconfig.DatasetConfig for d in from_jax.train_datasets + from_jax.noise_datasets)
    assert jconfig.TrainingConfig.from_dict(json.loads(tcfg.json())) == jcfg
    # the inference config and a reference JSON with the dropped ``per_frame`` flag
    jinf = jconfig.InferenceConfig(context_config=jconfig.ContextConfig(vocab=["a"], sequence=[0]))
    assert tconfig.InferenceConfig.from_dict(jinf.to_dict()).to_dict() == jinf.to_dict()
    data = tcfg.to_dict()
    data["inference_engine_config"]["per_frame"] = True
    assert tconfig.TrainingConfig.from_dict(data).to_dict() == jconfig.TrainingConfig.from_dict(data).to_dict()


@pytest.mark.parametrize("which", ["default", "full", "no-datasets"])
def test_apply_to_settings_gives_the_jax_settings(which, monkeypatch):
    monkeypatch.setenv("NUM_MELS", "40")  # the env var is overwritten where the config names the transform
    make = {"default": lambda m: m.TrainingConfig(), "full": _full,
            "no-datasets": lambda m: m.TrainingConfig(context_config=m.ContextConfig(vocab=["a", "b"], sequence=[1]),
                                                      batch_size=4)}[which]
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    jout = make(jconfig).apply_to_settings()
    tout = make(tconfig).apply_to_settings()
    assert jout is J_SETTINGS and tout is T_SETTINGS
    want, got = J_SETTINGS.to_dict(), T_SETTINGS.to_dict()
    want["training"].pop("device")
    assert got["training"].pop("device") == "cuda"  # the port's own default, which no config sets
    assert got == want
    # into settings of the caller's own
    from howl_tpu_torch.settings import HowlSettings

    own = HowlSettings()
    make(tconfig).apply_to_settings(own)
    assert own.to_dict() == T_SETTINGS.to_dict()


def test_config_fields_all_consumed():
    fields = _dataclass_fields(PORT / "config.py")
    assert fields == _dataclass_fields(PORT.parent / "howl_tpu" / "config.py")
    reads = _attribute_reads(sorted(PORT.rglob("*.py")))
    assert not fields - reads, f"config fields the port never reads: {sorted(fields - reads)}"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workspace_save_and_load_config(tmp_path, writer):
    ws_path = tmp_path / "ws"
    cfg = _full(tconfig if writer == "port" else jconfig)
    ws = (TWorkspace if writer == "port" else JWorkspace)(ws_path)
    ws.save_config(cfg)
    assert cfg.workspace_path == str(ws_path)  # the snapshot names the workspace it lies in
    assert (ws_path / "training_config.json").exists()
    back = TWorkspace(ws_path, delete_existing=False).load_config()
    assert isinstance(back, tconfig.TrainingConfig) and back.to_dict() == cfg.to_dict()
    assert JWorkspace(ws_path, delete_existing=False).load_config().to_dict() == cfg.to_dict()
    # an explicit path
    other = tmp_path / "elsewhere.json"
    TWorkspace(ws_path, delete_existing=False).save_config(back, other)
    assert tconfig.TrainingConfig.parse_file(other) == back
    assert (ws_path / "training_config.json").read_text() == other.read_text()  # both write indent 4
