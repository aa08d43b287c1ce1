"""Workspace: checkpoints, settings snapshots, metrics (counterpart of
``howl_tpu/workspace.py``; ref: howl/workspace.py:16-110).

Layout inside a workspace directory:
  model.pt / model-best.pt       — ``torch.save`` of the model's state dict
                                   (parameters and BatchNorm buffers, float32,
                                   on the CPU)
  train_state.pt                 — the model's state dict, the AdamW state and
                                   the step counter, so a resumed run continues
                                   the learning-rate decay where it stopped
  zmuv.json                      — fitted ZMUV statistics
  settings.json                  — settings snapshot
  cmd-args.json                  — CLI invocation record
  training_config.json           — ``TrainingConfig`` snapshot (config-driven runs)
  metrics.jsonl                  — append-only scalar log (time, step, name, value)
  logs/                          — the same scalars as TensorBoard event files
  errors.tsv                     — the evaluator's misclassified clips

``zmuv.json``, ``settings.json``, ``cmd-args.json``,
``training_config.json``, ``metrics.jsonl``, ``logs/`` and ``errors.tsv``
have the JAX workspace's names and formats. The checkpoints do not: the JAX
package writes flax msgpack (``.flax``), which this package does not read.
Weights trained by the JAX package come across through
``howl_tpu_torch.compat``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import torch

from howl_tpu_torch.ops.zmuv import ZmuvTransform
from howl_tpu_torch.settings import SETTINGS, HowlSettings
from howl_tpu_torch.utils.logger import Logger


def _host_state_dict(state_dict) -> dict:
    """A detached CPU copy of a state dict, float32 where it was floating."""
    return {
        k: (v.detach().to("cpu", torch.float32) if v.is_floating_point() else v.detach().cpu()).clone()
        for k, v in state_dict.items()
    }


class Workspace:
    writes = True  # False for a ``ReadOnlyWorkspace``

    def __init__(self, path: Path, best_quality: float = float("-inf"), delete_existing: bool = True):
        self.path = Path(path)
        self.best_quality = best_quality
        self.path.mkdir(parents=True, exist_ok=True)
        self._metrics_file = None
        self._tb_writer = None
        if delete_existing:
            metrics = self.path / "metrics.jsonl"
            if metrics.exists():
                metrics.unlink()
            # stale TensorBoard event files would render dead runs' curves
            # overlaid on the new run (ref howl/workspace.py:26-28 rmtree)
            logs = self.path / "logs"
            if logs.exists():
                import shutil

                shutil.rmtree(logs)

    # ---- model checkpoints ----

    def model_path(self, best: bool = False) -> Path:
        return self.path / f"model{'-best' if best else ''}.pt"

    def save_model(self, state_dict, best: bool = False):
        torch.save(_host_state_dict(state_dict), self.model_path(best))

    def load_model(self, best: bool = True) -> dict:
        """The saved state dict, on the CPU; ``model.load_state_dict`` copies
        it to wherever the model lies."""
        return torch.load(self.model_path(best), map_location="cpu", weights_only=True)

    def increment_model(self, state_dict, quality: float):
        """Save latest; keep best by quality (ref workspace.py:44-54)."""
        if quality > self.best_quality:
            self.save_model(state_dict, best=True)
            self.best_quality = quality
        self.save_model(state_dict, best=False)

    @property
    def train_state_path(self) -> Path:
        return self.path / "train_state.pt"

    def save_train_state(self, state):
        """The whole train state: model, AdamW state and step counter."""
        torch.save(
            {"model": _host_state_dict(state.model.state_dict()), "optimizer": state.optimizer.state_dict(),
             "step": int(state.step)},
            self.train_state_path,
        )

    def load_train_state(self, state):
        """Restore a saved train state into ``state`` (built for the same
        model and optimizer) in place, and return it."""
        data = torch.load(self.train_state_path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(data["model"], strict=True)
        state.optimizer.load_state_dict(data["optimizer"])
        state.step = int(data["step"])
        return state

    def has_train_state(self) -> bool:
        return self.train_state_path.exists()

    # ---- zmuv ----

    def save_zmuv(self, zmuv: ZmuvTransform):
        (self.path / "zmuv.json").write_text(json.dumps(zmuv.state_dict()))

    def load_zmuv(self) -> Optional[ZmuvTransform]:
        path = self.path / "zmuv.json"
        if not path.exists():
            return None
        return ZmuvTransform.from_state_dict(json.loads(path.read_text()))

    # ---- settings / args ----

    def save_settings(self, settings: HowlSettings = SETTINGS):
        data = settings.to_dict()
        for key in ("dataset", "resource"):
            data.pop(key, None)
        (self.path / "settings.json").write_text(json.dumps(data, indent=2))

    def load_settings(self, settings: HowlSettings = SETTINGS) -> HowlSettings:
        data = json.loads((self.path / "settings.json").read_text())
        settings.load_dict(data)
        return settings

    def save_config(self, training_config, training_config_path: Optional[Path] = None):
        """Persist a TrainingConfig snapshot (ref workspace.py:83-96); the
        config's ``workspace_path`` becomes this workspace."""
        path = Path(training_config_path) if training_config_path else self.path / "training_config.json"
        training_config.workspace_path = str(self.path)
        path.write_text(training_config.json(indent=4))

    def load_config(self, training_config_path: Optional[Path] = None):
        from howl_tpu_torch.config import TrainingConfig

        path = Path(training_config_path) if training_config_path else self.path / "training_config.json"
        return TrainingConfig.parse_file(path)

    def write_args(self, args):
        data = {k: v for k, v in vars(args).items() if not k.startswith("_")}
        (self.path / "cmd-args.json").write_text(json.dumps(data, indent=2, default=str))

    # ---- metrics ----

    def log_scalar(self, name: str, value: float, step: int = 0):
        if self._metrics_file is None:
            self._metrics_file = (self.path / "metrics.jsonl").open("a")
        self._metrics_file.write(
            json.dumps({"time": time.time(), "step": int(step), "name": name, "value": float(value)}) + "\n"
        )
        self._metrics_file.flush()
        # TensorBoard-readable mirror in logs/ (ref workspace.py:29 SummaryWriter)
        if self._tb_writer is None:
            from howl_tpu_torch.utils.tb_events import EventFileWriter

            self._tb_writer = EventFileWriter(self.path / "logs")
        self._tb_writer.add_scalar(name, value, step)

    def close(self):
        """Release the metrics jsonl and TensorBoard event file handles."""
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None

    def summary(self) -> dict:
        """Latest value per metric name."""
        out = {}
        path = self.path / "metrics.jsonl"
        if path.exists():
            for line in path.read_text().splitlines():
                rec = json.loads(line)
                out[rec["name"]] = rec["value"]
        return out

    def heading(self, msg: str):
        Logger.heading(msg)


class ReadOnlyWorkspace(Workspace):
    """A workspace that another process writes: it reads checkpoints, the
    train state and ``zmuv.json`` and writes nothing (``writes`` False).
    The data-parallel ranks other than rank 0 hold one."""

    writes = False

    def __init__(self, path: Path):
        self.path = Path(path)
        self.best_quality = float("-inf")
        self._metrics_file = None
        self._tb_writer = None

    def save_model(self, state_dict, best: bool = False):
        pass

    def save_train_state(self, state):
        pass

    def save_zmuv(self, zmuv: ZmuvTransform):
        pass

    def save_settings(self, settings: HowlSettings = SETTINGS):
        pass

    def write_args(self, args):
        pass

    def log_scalar(self, name: str, value: float, step: int = 0):
        pass

    def close(self):
        pass

