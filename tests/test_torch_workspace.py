"""The port's ``Workspace`` (howl_tpu_torch/workspace.py) against
howl_tpu's: checkpoints as torch state dicts, the best-checkpoint logic,
``zmuv.json`` and ``settings.json`` byte for byte the JAX workspace's for the
same settings, metrics and TensorBoard logs in the same format, and a resume
that restores the model, AdamW and the step counter exactly."""

import json

import numpy as np
import pytest
import torch

from howl_tpu.ops.zmuv import ZmuvTransform as JZmuv
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu.utils.tb_events import read_scalars
from howl_tpu.workspace import Workspace as JWorkspace
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.zmuv import ZmuvTransform as TZmuv
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.training.objectives import frame_ce_loss
from howl_tpu_torch.training.state import create_train_state
from howl_tpu_torch.workspace import Workspace

torch.set_num_threads(1)

RECIPE = {
    "WEIGHT_DECAY": "0.00001", "NUM_EPOCHS": "70", "LEARNING_RATE": "0.01", "LR_DECAY": "0.955",
    "BATCH_SIZE": "16", "MAX_WINDOW_SIZE_SECONDS": "0.5", "USE_NOISE_DATASET": "True", "NUM_MELS": "40",
    "INFERENCE_SEQUENCE": "[0,1,2]", "VOCAB": '["hey","fire","fox"]', "NOISE_DATASET_PATH": "/data/noise",
}


@pytest.fixture(autouse=True)
def _reset_port_settings():
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


def _state(seed: int = 0, steps_per_epoch: int = 2):
    model = create_model("res8", num_labels=4)
    return create_train_state(model, 0.01, weight_decay=1e-5, lr_decay=0.9, steps_per_epoch=steps_per_epoch,
                              generator=torch.Generator().manual_seed(seed), device="cpu")


def _step(state, seed: int):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((4, 1, 40, 41), generator=g)
    labels = torch.randint(0, 4, (4,), generator=g)
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    frame_ce_loss(state.model(feats), labels).backward()
    state.apply_gradients()


def _equal_state_dicts(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def test_checkpoint_round_trip(tmp_path):
    state = _state()
    _step(state, 1)
    ws = Workspace(tmp_path)
    ws.save_model(state.model.state_dict(), best=False)
    assert ws.model_path().name == "model.pt" and ws.model_path(best=True).name == "model-best.pt"
    loaded = ws.load_model(best=False)
    assert _equal_state_dicts(loaded, state.model.state_dict())
    assert all(not v.requires_grad and v.device.type == "cpu" for v in loaded.values())
    fresh = create_model("res8", num_labels=4)
    fresh.load_state_dict(loaded, strict=True)
    assert _equal_state_dicts(fresh.state_dict(), state.model.state_dict())
    # a bf16 model keeps float32 masters, and so does its checkpoint
    bf16 = _state()
    bf16.model.dtype = torch.bfloat16
    ws.save_model(bf16.model.state_dict(), best=True)
    assert {v.dtype for k, v in ws.load_model().items() if "num_batches" not in k} == {torch.float32}


def test_increment_model_keeps_the_best(tmp_path):
    ws = Workspace(tmp_path)
    states = []
    for seed, quality in ((0, 1.0), (1, 0.5), (2, 2.0), (3, 2.0)):
        states.append(_state(seed).model.state_dict())
        ws.increment_model(states[-1], quality)
    assert ws.best_quality == 2.0
    assert _equal_state_dicts(ws.load_model(best=True), states[2])  # a tie does not replace the best
    assert _equal_state_dicts(ws.load_model(best=False), states[3])  # the latest is always written
    ws2 = Workspace(tmp_path, delete_existing=False)
    ws2.increment_model(states[1], 0.0)  # a fresh workspace object starts from -inf, as in the JAX package
    assert _equal_state_dicts(ws2.load_model(best=True), states[1])


def test_zmuv_and_settings_files_are_the_jax_workspaces_bytes(tmp_path, monkeypatch):
    for k, v in {**RECIPE, "DEVICE": "cuda"}.items():
        monkeypatch.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    rng = np.random.default_rng(0)
    tz, jz = TZmuv(), JZmuv()
    for _ in range(3):
        batch = rng.standard_normal((4, 40, 41)) * 3.0 - 7.0
        tz.update(batch)
        jz.update(batch)
    jax_ws, port_ws = JWorkspace(tmp_path / "jax"), Workspace(tmp_path / "port")
    jax_ws.save_zmuv(jz)
    port_ws.save_zmuv(tz)
    jax_ws.save_settings(J_SETTINGS)
    port_ws.save_settings(T_SETTINGS)
    for name in ("zmuv.json", "settings.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert json.loads((tmp_path / "port" / "settings.json").read_text())["training"]["device"] == "cuda"
    # each reads the other's files
    assert JWorkspace(tmp_path / "port", delete_existing=False).load_zmuv().state_dict() == tz.state_dict()
    assert Workspace(tmp_path / "jax", delete_existing=False).load_zmuv().std == jz.std
    monkeypatch.setenv("NUM_MELS", "80")
    T_SETTINGS.reset()
    Workspace(tmp_path / "jax", delete_existing=False).load_settings(T_SETTINGS)
    assert T_SETTINGS.audio_transform.num_mels == 40 and T_SETTINGS.training.vocab == ["hey", "fire", "fox"]


def test_metrics_args_and_logs_in_the_jax_format(tmp_path):
    import argparse

    ws = Workspace(tmp_path)
    for step, value in enumerate((0.9, 0.4)):
        ws.log_scalar("Training/Loss", value, step)
    ws.write_args(argparse.Namespace(model="res8", eval_freq=10, dataset_paths=[tmp_path]))
    ws.close()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [set(r) for r in records] == [{"time", "step", "name", "value"}] * 2
    assert [(r["step"], r["name"], r["value"]) for r in records] == [(0, "Training/Loss", 0.9), (1, "Training/Loss", 0.4)]
    assert ws.summary() == JWorkspace(tmp_path, delete_existing=False).summary() == {"Training/Loss": 0.4}
    (events,) = (tmp_path / "logs").iterdir()
    assert [(s, t) for s, t, _ in read_scalars(events)] == [(0, "Training/Loss"), (1, "Training/Loss")]
    assert json.loads((tmp_path / "cmd-args.json").read_text())["dataset_paths"] == [str(tmp_path)]
    Workspace(tmp_path)  # a new run clears the old metrics and logs
    assert not (tmp_path / "metrics.jsonl").exists() and not (tmp_path / "logs").exists()
    # the config snapshot (tests/test_torch_config.py holds it against the JAX workspace's)
    from howl_tpu_torch.config import TrainingConfig

    ws.save_config(TrainingConfig(batch_size=4))
    assert ws.load_config() == TrainingConfig(batch_size=4, workspace_path=str(tmp_path))


def test_train_state_resume_is_exact(tmp_path):
    """Two steps, save, two more: equal to four uninterrupted steps, with the
    learning-rate schedule continuing from the restored step count."""
    ref = _state(5)
    for i in range(4):
        _step(ref, 10 + i)
    first = _state(5)
    for i in range(2):
        _step(first, 10 + i)
    Workspace(tmp_path).save_train_state(first)
    resumed = _state(99)  # other initial weights: the file must replace all of them
    ws = Workspace(tmp_path, delete_existing=False)
    assert ws.has_train_state() and ws.train_state_path.name == "train_state.pt"
    resumed = ws.load_train_state(resumed)
    assert resumed.step == 2 and resumed.learning_rate == pytest.approx(0.01 * 0.9)
    assert _equal_state_dicts(resumed.model.state_dict(), first.model.state_dict())
    opt_a, opt_b = resumed.optimizer.state_dict()["state"], first.optimizer.state_dict()["state"]
    assert opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[k][f], opt_b[k][f]) for k in opt_a for f in ("exp_avg", "exp_avg_sq", "step"))
    for i in range(2, 4):
        _step(resumed, 10 + i)
    assert resumed.step == ref.step == 4
    assert _equal_state_dicts(resumed.model.state_dict(), ref.model.state_dict())
