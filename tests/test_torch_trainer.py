"""The port's config-driven ``Trainer`` (howl_tpu_torch/trainer.py) and the
``refactored_train`` CLI on the synthetic-tone corpus, on the CPU.

* ``Trainer.train`` from a ``TrainingConfig`` gives what the env-driven
  entry point gives from the same settings: per-epoch losses equal (the
  same code on the same inputs, so exactly), the same final confusion
  matrices, and ``training_config.json`` beside the checkpoints, a file
  the JAX package's ``TrainingConfig`` parses into the same config.
* ``Trainer.evaluate`` reproduces the trained run's results from
  ``model-best.pt``; the workspace defaults to ``workspaces/<wake word>``,
  as JAX's ``Trainer`` defaults it.
* ``refactored_train --config`` trains and ``--eval`` evaluates; without a
  card and without ``--device cpu`` it raises before reading anything.
"""

import json

import numpy as np
import pytest
import torch

from howl_tpu_torch.config import ContextConfig, DatasetConfig, ModelConfig, TrainingConfig
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.trainer import Trainer
from howl_tpu_torch.training.run import refactored_train
from howl_tpu_torch.training.run import train as ttrain
from tests.fixtures import make_wakeword_corpus

torch.set_num_threads(2)
RUN = ["--no-augment", "--steps-per-epoch", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_wakeword_corpus(tmp_path_factory.mktemp("trainer") / "ww", n_positive=8, n_negative=8)


@pytest.fixture(autouse=True)
def _reset_settings():
    SETTINGS.reset()
    yield
    SETTINGS.reset()


def _config(corpus, workspace=None) -> TrainingConfig:
    return TrainingConfig(
        batch_size=8, learning_rate=0.02, num_epochs=2, lr_decay=0.98, max_window_size_seconds=0.5,
        eval_stride_size_seconds=0.0625,
        context_config=ContextConfig(vocab=["hey", "fire", "fox"], sequence=[0, 1, 2]),
        model_config=ModelConfig(architecture="res8"),
        train_datasets=[DatasetConfig(path=str(corpus))], val_datasets=[DatasetConfig(path=str(corpus))],
        workspace_path=None if workspace is None else str(workspace),
    )


def _losses(ws) -> list:
    rows = [json.loads(line) for line in (ws / "metrics.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["name"] == "Training/Loss"]


def test_trainer_trains_as_the_entry_point_and_evaluates(corpus, tmp_path, monkeypatch):
    cfg = _config(corpus, tmp_path / "cfg_ws")
    stats = ttrain.LoopStats()
    results = Trainer(cfg).train(RUN, stats)
    assert stats.steps == 4 and "test_pos" in results
    ws = tmp_path / "cfg_ws"
    for name in ("model-best.pt", "model.pt", "training_config.json", "settings.json", "zmuv.json"):
        assert (ws / name).exists(), name
    from howl_tpu.config import TrainingConfig as JTrainingConfig

    assert JTrainingConfig.parse_file(ws / "training_config.json").to_dict() == cfg.to_dict()
    assert TrainingConfig.parse_file(ws / "training_config.json") == cfg

    # the same settings by environment, through the entry point itself
    for k, v in {"BATCH_SIZE": "8", "LEARNING_RATE": "0.02", "NUM_EPOCHS": "2", "LR_DECAY": "0.98",
                 "MAX_WINDOW_SIZE_SECONDS": "0.5", "EVAL_STRIDE_SIZE_SECONDS": "0.0625", "VOCAB": '["hey","fire","fox"]',
                 "INFERENCE_SEQUENCE": "[0,1,2]", "WEIGHT_DECAY": "0.00001", "NUM_MELS": "40"}.items():
        monkeypatch.setenv(k, v)
    SETTINGS.reset()
    env_results = ttrain.run(["--model", "res8", "--workspace", str(tmp_path / "env_ws"), "-i", str(corpus),
                              "--eval-freq", "0", *RUN])
    assert _losses(ws) == _losses(tmp_path / "env_ws") and len(_losses(ws)) == 2
    assert results == env_results

    # evaluate: model-best.pt gives the run's final matrices again
    monkeypatch.delenv("BATCH_SIZE")
    assert Trainer(cfg).evaluate(["--device", "cpu"]) == results


def test_workspace_defaults_to_the_wake_word(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(_config(corpus))
    assert trainer.training_cfg.workspace_path == "workspaces/hey_fire_fox"
    with pytest.raises(ValueError, match="no dataset paths"):
        Trainer(TrainingConfig(context_config=ContextConfig(vocab=["a"], sequence=[0]))).train(RUN)


def test_refactored_train_cli(corpus, tmp_path, monkeypatch):
    cfg = _config(corpus, tmp_path / "ws")
    path = tmp_path / "config.json"
    path.write_text(cfg.json(indent=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        refactored_train.run(["--config", str(path), "--no-augment"])
    assert not (tmp_path / "ws").exists()  # refused before anything was read or written
    results = refactored_train.run(["--training_config", str(path), *RUN])
    assert (tmp_path / "ws" / "model-best.pt").exists() and (tmp_path / "ws" / "training_config.json").exists()
    assert refactored_train.run(["--config", str(path), "--eval", "--device", "cpu"]) == results
    assert np.isfinite(_losses(tmp_path / "ws")).all()
