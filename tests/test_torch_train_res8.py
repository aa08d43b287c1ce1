"""res8 in training (howl_tpu_torch/models/cnn.py), its objectives, its
train state and the two-way weight bridge, vs howl_tpu on the same weights.

Tolerances: float32 logits 1e-4 (tests/test_torch_res8.py's); gradients rtol 1e-3 /
atol 1e-6 against ``jax.grad`` (float32 sums in another order through six
convs and BatchNorm); BatchNorm running stats 1e-6 (one momentum step of
float32 batch statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from howl_tpu.models import create_model as jax_create_model
from howl_tpu.training.objectives import ctc_loss as jax_ctc_loss
from howl_tpu.training.objectives import frame_ce_loss as jax_frame_ce_loss
from howl_tpu.training.state import create_train_state as jax_create_train_state
from howl_tpu.training.state import param_count as jax_param_count
from howl_tpu_torch.compat import res8_state_dict_to_variables, res8_variables_to_state_dict
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda
from howl_tpu_torch.training import objectives
from howl_tpu_torch.training.state import create_train_state, param_count
from howl_tpu_torch.training.step import StepConfig, make_ctc_train_step

torch.set_num_threads(1)


def jax_res8_variables(seed: int, num_labels: int = 4) -> dict:
    """flax-initialized res8 variables as numpy, with nonzero running stats
    and output bias so every mapping is exercised."""
    rng = np.random.default_rng(seed)
    variables = jax_create_model("res8", num_labels=num_labels).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 1, 40, 41)), train=False
    )
    variables = jax.tree.map(lambda x: np.array(x, np.float32), variables)
    for i in range(1, 7):
        variables["batch_stats"][f"bn{i}"] = {
            "mean": rng.normal(0.0, 0.2, 45).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 45).astype(np.float32),
        }
    variables["params"]["output"]["bias"] = rng.normal(0.0, 0.1, num_labels).astype(np.float32)
    return variables


def port_grads(model) -> dict:
    """The port's parameter gradients in the JAX layout."""
    g = {f"conv{i}": {"kernel": getattr(model, f"conv{i}").weight.grad.permute(2, 3, 1, 0).numpy()} for i in range(7)}
    g["output"] = {"kernel": model.output.weight.grad.T.numpy(), "bias": model.output.bias.grad.numpy()}
    return g


def assert_grads_close(got: dict, want, rtol=1e-3, atol=1e-6):
    want = jax.tree.map(np.asarray, want)
    assert set(got) == set(want)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, rtol=rtol, atol=atol, err_msg=f"{layer}.{leaf}")


def assert_stats_close(model, want_stats, atol=1e-6):
    got = res8_state_dict_to_variables(model.state_dict())["batch_stats"]
    for i in range(1, 7):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[f"bn{i}"][k], np.asarray(want_stats[f"bn{i}"][k]), atol=atol, rtol=0)


def _train_model(variables, **kw):
    model = create_model("res8", num_labels=4, **kw)
    model.load_state_dict(res8_variables_to_state_dict(variables), strict=True)
    return model.train()


def _jax_train_forward(variables, feats, labels, method=None, args=()):
    model = jax_create_model("res8", num_labels=4)

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(feats), *args,
            train=True, mutable=["batch_stats"], **({"method": method} if method else {}),
        )
        return jax_frame_ce_loss(out, jnp.asarray(labels)), (out, mutated["batch_stats"])

    (loss, (logits, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(logits), stats, grads


@pytest.mark.parametrize("method", [None, "windowed_logits"])
def test_train_mode_logits_grads_and_stats_match_jax(method):
    variables = jax_res8_variables(3)
    rng = np.random.default_rng(4)
    feats = (rng.standard_normal((4, 1, 40, 41)) * 0.8).astype(np.float32)
    labels = np.array([0, 1, 2, 3])
    span = (2, 11)
    loss, logits, stats, grads = _jax_train_forward(
        variables, feats, labels, method, span if method else ()
    )
    model = _train_model(variables)
    x = torch.from_numpy(feats)
    out = model.windowed_logits(x, *span) if method else model(x)
    got_loss = objectives.frame_ce_loss(out, torch.from_numpy(labels))
    got_loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=1e-4)
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
    got = port_grads(model)
    assert_grads_close(got, grads)
    assert np.abs(got["conv0"]["kernel"]).max() > 0  # the stem trains
    assert_stats_close(model, stats)


def test_batchnorm_moves_running_stats_with_the_biased_variance():
    """One train forward on a batch with 10 values per channel (1 clip, one
    pooled frame, 10 pooled bins): flax's update uses the biased batch
    variance; torch's BatchNorm2d would use the unbiased one (10/9 x)."""
    variables = jax_res8_variables(5)
    feats = (np.random.default_rng(6).standard_normal((1, 1, 40, 3)) * 0.8).astype(np.float32)
    _, _, stats, _ = _jax_train_forward(variables, feats, np.array([1]))
    model = _train_model(variables)
    model(torch.from_numpy(feats)).sum().backward()
    assert_stats_close(model, stats)
    assert int(model.bn1.num_batches_tracked) == 1


def test_bf16_train_forward_matches_jax_bf16():
    variables = jax_res8_variables(7)
    feats = (np.random.default_rng(8).standard_normal((4, 1, 40, 41)) * 0.8).astype(np.float32)
    labels = np.array([3, 2, 1, 0])
    jmodel = jax_create_model("res8", num_labels=4, dtype=jnp.bfloat16)
    out, _ = jmodel.apply(variables, jnp.asarray(feats), train=True, mutable=["batch_stats"])
    want = float(jax_frame_ce_loss(out, jnp.asarray(labels)))
    model = _train_model(variables, dtype=torch.bfloat16)
    logits = model(torch.from_numpy(feats))
    assert logits.dtype == torch.float32 and model.conv3.weight.dtype == torch.float32
    got = objectives.frame_ce_loss(logits, torch.from_numpy(labels))
    got.backward()
    assert abs(got.item() - want) <= 2e-2 * abs(want)
    assert model.conv0.weight.grad.dtype == torch.float32 and model.conv0.weight.grad.abs().max() > 0


def test_stem_kernel_refuses_inputs_that_require_grad():
    """The K2 wrapper has no backward: with grad mode on it refuses inputs
    that require grad, so a trained stem can never pass through it."""
    mel = torch.randn(2, 9, 40, requires_grad=True)
    taps = torch.randn(3, 3, 45)
    with pytest.raises(RuntimeError, match="no backward"):
        res8_stem_cuda(mel, taps)
    with pytest.raises(RuntimeError, match="no backward"):
        res8_stem_cuda(mel.detach(), taps.requires_grad_())
    with torch.no_grad():
        assert res8_stem_cuda(mel, taps).shape == (2, 3, 10, 45)
    # eval mode with grad on: conv0 requires grad, so the stem is the conv chain
    model = create_model("res8", num_labels=4).eval()
    model(torch.randn(2, 1, 40, 9)).sum().backward()
    assert model.conv0.weight.grad.abs().max() > 0


def test_frame_ce_loss_matches_optax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 6)
    weights = np.array([1.0, 0.0, 2.0, 0.5, 1.0, 0.0], np.float32)
    for w in (None, weights):
        want = float(jax_frame_ce_loss(jnp.asarray(logits), jnp.asarray(labels), None if w is None else jnp.asarray(w)))
        got = float(objectives.frame_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), w))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # CTC is ported (tests/test_torch_train_families.py holds it against JAX's on every case): one case here
    logits = rng.standard_normal((8, 2, 4)).astype(np.float32)
    lengths, targets, target_lengths = np.array([8, 6], np.int32), np.array([[1, 2], [3, 3]], np.int32), np.array([2, 2])
    want = float(jax_ctc_loss(jnp.asarray(logits), jnp.asarray(lengths), jnp.asarray(targets),
                              jnp.asarray(target_lengths), 0))
    got = float(objectives.ctc_loss(torch.from_numpy(logits), torch.from_numpy(lengths), torch.from_numpy(targets),
                                    torch.from_numpy(target_lengths), 0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert callable(make_ctc_train_step(None, StepConfig(None, 0.0, 1.0)))


def test_state_dict_to_variables_is_the_bridge_inverse_and_flax_loads_it():
    variables = jax_res8_variables(10)
    back = res8_state_dict_to_variables(res8_variables_to_state_dict(variables))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    # a port-trained res8 carried back serves the same logits in flax
    model = _train_model(variables)
    model(torch.randn(3, 1, 40, 41)).sum().backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.01 * p.grad
    feats = np.random.default_rng(11).standard_normal((2, 1, 40, 41)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    want = jax_create_model("res8", num_labels=4).apply(
        res8_state_dict_to_variables(model.state_dict()), jnp.asarray(feats), train=False
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_create_train_state_schedule_init_and_count():
    jax_state = jax_create_train_state(
        jax_create_model("res8", num_labels=4), jax.random.PRNGKey(0), np.zeros((1, 1, 40, 41), np.float32),
        learning_rate=0.01, lr_decay=0.99, steps_per_epoch=100,
    )
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(create_model("res8", num_labels=4), 0.01, lr_decay=0.99, steps_per_epoch=100, generator=gen, device="cpu")
    assert param_count(state) == jax_param_count(jax_state) == 109939
    schedule = optax.exponential_decay(0.01, 100, 0.99, staircase=True)
    for step in (0, 99, 100, 250, 1000):
        state.step = step
        np.testing.assert_allclose(state.learning_rate, float(schedule(step)), rtol=1e-6)
    # flax's lecun-normal init: truncated at 2 sigma, std 1/sqrt(fan_in)
    w = state.model.conv3.weight.detach()
    assert abs(float(w.std()) * (9 * 45) ** 0.5 - 1.0) < 0.05 and float(w.abs().max()) <= 2.0 / 0.8796 / (9 * 45) ** 0.5
    assert not state.model.output.bias.any() and float(state.model.bn2.running_var.min()) == 1.0
    again = create_train_state(
        create_model("res8", num_labels=4), 0.01, generator=torch.Generator().manual_seed(0), device="cpu"
    )
    assert torch.equal(again.model.conv3.weight, state.model.conv3.weight)
    with pytest.raises(ValueError, match="Generator"):
        create_train_state(create_model("res8", num_labels=4), 0.01, device="cpu")
