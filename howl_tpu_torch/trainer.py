"""Config-driven Trainer (counterpart of ``howl_tpu/trainer.py``; ref:
howl/trainer.py). Wraps the env-driven training implementation: the config
is materialized into ``SETTINGS`` and delegated to ``training.run.train``,
so both entry paths run the same code.

The run trains on the card (``SETTINGS.training.device``, "cuda") unless
``extra_args`` holds ``--device cpu``; without a card it raises. Its
workspace is ``training_cfg.workspace_path``, by default
``workspaces/<wake word>``; the config is written beside the checkpoints as
``training_config.json``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from howl_tpu_torch.config import TrainingConfig
from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.utils.logger import Logger
from howl_tpu_torch.workspace import Workspace


class Trainer:
    def __init__(self, training_cfg: TrainingConfig):
        self.training_cfg = training_cfg
        self.context_cfg = training_cfg.context_config
        self.context = InferenceContext.load_from_config(self.context_cfg)
        if self.training_cfg.workspace_path is None:
            wake_word = self.context.wake_word.replace(" ", "_")
            self.training_cfg.workspace_path = str(Path("workspaces") / wake_word)
            Logger.info(f"workspace defaulted to {self.training_cfg.workspace_path}")

    def _all_dataset_paths(self) -> list:
        """Deduped union of the train, val and test dataset paths. Each howl
        dataset directory carries all three split jsonls and the loader reads
        them all, so the reference's canonical config points every list at
        the same directory (ref test/test_data/test_training_config.json)."""
        seen: dict = {}
        for cfgs in (self.training_cfg.train_datasets, self.training_cfg.val_datasets, self.training_cfg.test_datasets):
            for cfg in cfgs:
                if cfg.path:
                    seen.setdefault(cfg.path, None)
        return list(seen)

    def _args(self, mode: list, extra_args: Optional[list]) -> list:
        args = ["--model", self.training_cfg.model_config.architecture, "--workspace", self.training_cfg.workspace_path,
                *mode]
        for path in self._all_dataset_paths():
            args += ["-i", path]
        return args + list(extra_args or [])

    def train(self, extra_args: Optional[list] = None, stats=None) -> dict:
        """Train on the configured datasets; returns the final evaluation's
        results (``training.run.train.run``'s). ``stats``, a
        ``LoopStats``, is filled with where the run spent its time."""
        from howl_tpu_torch.training.run.train import run as train_run

        self.training_cfg.apply_to_settings()
        if not self._all_dataset_paths():
            raise ValueError("training_cfg.train_datasets has no dataset paths")
        results = train_run(self._args(["--eval-freq", "0"], extra_args), stats)
        # the config snapshot beside the checkpoints
        ws = Workspace(Path(self.training_cfg.workspace_path), delete_existing=False)
        (ws.path / "training_config.json").write_text(self.training_cfg.json(indent=2))
        return results

    def evaluate(self, extra_args: Optional[list] = None) -> dict:
        from howl_tpu_torch.training.run.train import run as train_run

        self.training_cfg.apply_to_settings()
        return train_run(self._args(["--eval"], extra_args))
