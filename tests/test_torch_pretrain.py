"""The port's vision pretraining (howl_tpu_torch/training/run/pretrain.py)
against howl_tpu's, on the CPU.

* ``load_cifar10`` on a CIFAR-10 python-pickle corpus the test writes, and
  ``synthetic_dataset``, give JAX's arrays bit for bit.
* One train step of res8 on (B, 3, 32, 32) images from JAX's initial
  weights (carried by ``compat.variables_to_state_dict``) equals JAX's step:
  the loss within rtol 1e-5, the parameters within rtol 1e-3 / atol 1e-5
  and the BatchNorm running stats within rtol 2e-4 / atol 1e-6
  (``tests/test_train_dp.py``'s tolerances). Both steps take plain SGD, so
  the update is the gradient itself (AdamW's first update is ~lr * sign(g)
  and turns float32 noise in near-zero gradients into +-lr moves). The eval
  step's logits on the initial weights (res8's stem through the stem
  kernel's plain version at 32 mel rows) equal JAX's eval forward within
  1e-5.
* ``pretrain --synthetic --device cpu`` learns (above chance on 10 classes)
  and writes ``model-best.pt``; a CIFAR directory is read with ``-i``; the
  card is asked for unless ``--device cpu``.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import state_dict_to_variables, variables_to_state_dict
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_port_settings():
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


def write_cifar10(root, n_train: int = 20, n_test: int = 10, seed: int = 0):
    """A CIFAR-10 python-format directory: five ``data_batch_i`` and a
    ``test_batch`` pickle of uint8 (N, 3072) rows and int labels."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for name, n in [(f"data_batch_{i}", n_train) for i in range(1, 6)] + [("test_batch", n_test)]:
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, n).tolist(), b"batch_label": name.encode()}
        with (root / name).open("wb") as f:
            pickle.dump(d, f)
    return root


def test_load_cifar10_and_synthetic_dataset_are_jaxs_bit_for_bit(tmp_path):
    from howl_tpu.training.run import pretrain as jpre
    from howl_tpu_torch.training.run import pretrain as tpre

    root = write_cifar10(tmp_path / "cifar")
    (jtr, jte), (ttr, tte) = jpre.load_cifar10(root), tpre.load_cifar10(root)
    assert ttr[0].shape == (100, 3, 32, 32) and tte[0].shape == (10, 3, 32, 32)
    for j, t in zip(jtr + jte, ttr + tte):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    for kw in ({}, {"num_classes": 4, "n": 64, "seed": 3}):
        for j, t in zip(sum(jpre.synthetic_dataset(**kw), ()), sum(tpre.synthetic_dataset(**kw), ())):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)


def _jax_step(batch: int = 16):
    """JAX's res8 at PRNGKey(0) on images, one SGD step of the pretrain
    train step's body, and its eval forward."""
    import optax

    from howl_tpu.models import create_model
    from howl_tpu.training.objectives import frame_ce_loss
    from howl_tpu.training.run.pretrain import synthetic_dataset
    from howl_tpu.training.state import TrainState

    (train_x, train_y), (test_x, _) = synthetic_dataset(10, n=80)
    model = create_model("res8", num_labels=10)
    variables = model.init({"params": jax.random.PRNGKey(0)}, train_x[:1], train=False)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"], tx=optax.sgd(1e-2),
                              batch_stats=variables["batch_stats"])
    x, y = train_x[:batch], train_y[:batch]

    def loss_fn(params):
        out, mutated = state.apply_fn({"params": params, "batch_stats": state.batch_stats}, x, train=True,
                                      rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return frame_ce_loss(out, y), mutated["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    new = state.apply_gradients(grads=grads, batch_stats=stats)
    logits = model.apply(variables, test_x[:batch], train=False)
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return (to_np(variables), float(loss), {"params": to_np(new.params), "batch_stats": to_np(new.batch_stats)},
            np.asarray(logits), (x, y, test_x[:batch]))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def test_one_pretrain_step_equals_jaxs_step():
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.training.run.pretrain import make_vision_steps
    from howl_tpu_torch.training.state import create_train_state

    init, jax_loss, jax_after, jax_logits, (x, y, test_x) = _jax_step()
    state = create_train_state(create_model("res8", num_labels=10), learning_rate=1e-2, variables=init,
                               device="cpu")
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=1e-2)
    train_step, eval_step = make_vision_steps()
    loss = train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(), 1)
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5)
    after = state_dict_to_variables("res8", state.model.state_dict())
    for (path, got), (_, want) in zip(_leaves(after["params"]), _leaves(jax_after["params"])):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=path)
    for (path, got), (_, want) in zip(_leaves(after["batch_stats"]), _leaves(jax_after["batch_stats"])):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6, err_msg=path)
    fresh = create_train_state(create_model("res8", num_labels=10), learning_rate=1e-2, variables=init, device="cpu")
    logits = eval_step(fresh, torch.from_numpy(test_x))
    assert not fresh.model.training and logits.shape == (16, 10)
    np.testing.assert_allclose(logits.numpy(), jax_logits, rtol=1e-5, atol=1e-5)


def test_pretrain_entry_point_learns_and_writes_its_workspace(tmp_path, monkeypatch):
    from howl_tpu_torch.training.run.pretrain import run

    for k, v in {"NUM_EPOCHS": "3", "BATCH_SIZE": "32", "LEARNING_RATE": "0.01"}.items():
        monkeypatch.setenv(k, v)
    T_SETTINGS.reset()
    result = run(["--model", "res8", "--workspace", str(tmp_path / "ws"), "--synthetic", "--device", "cpu"])
    assert result["test_acc"] > 0.15  # better than chance on 10 classes, as the JAX test holds
    state_dict = torch.load(tmp_path / "ws" / "model-best.pt", weights_only=True)
    assert state_dict["output.weight"].shape == (10, 45)
    variables_to_state_dict("res8", state_dict_to_variables("res8", state_dict))  # JAX's layout both ways


def test_pretrain_reads_a_cifar_directory_and_asks_for_the_card(tmp_path, monkeypatch):
    from howl_tpu_torch.training.run.pretrain import run

    root = write_cifar10(tmp_path / "cifar", n_train=8, n_test=16)
    for k, v in {"NUM_EPOCHS": "1", "BATCH_SIZE": "16"}.items():
        monkeypatch.setenv(k, v)
    T_SETTINGS.reset()
    J_SETTINGS.reset()
    result = run(["--workspace", str(tmp_path / "ws"), "-i", str(root), "--device", "cpu"])
    assert 0.0 <= result["test_acc"] <= 1.0 and (tmp_path / "ws" / "model-best.pt").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--workspace", str(tmp_path / "ws2"), "--synthetic"])
    assert not (tmp_path / "ws2").exists()
