"""The port's res8 (howl_tpu_torch/models/cnn.py) vs the flax Res8 on the
same weights, bridged by compat.res8_variables_to_state_dict.

BatchNorm running stats are nonzero, so the stats mapping is exercised.
Tolerances: float32 1e-4; bf16 logits 5e-2 (both sides round weights and
activations to bf16, at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference.config import cast_compute_dtype as jax_cast_compute_dtype
from howl_tpu.models import create_model as jax_create_model
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.inference.config import cast_compute_dtype
from howl_tpu_torch.models import create_model, model_spec
from howl_tpu_torch.models.cnn import Res8

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(11)
    flax_model = jax_create_model("res8", num_labels=4)
    variables = flax_model.init({"params": jax.random.PRNGKey(5)}, jnp.zeros((1, 1, 40, 41)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    for i in range(1, 7):
        variables["batch_stats"][f"bn{i}"] = {
            "mean": rng.normal(0.0, 0.2, 45).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 45).astype(np.float32),
        }
    variables["params"]["output"]["bias"] = rng.normal(0.0, 0.1, 4).astype(np.float32)
    feats = (rng.standard_normal((2, 1, 40, 101)) * 0.8).astype(np.float32)
    return variables, feats


def _torch_res8(variables, dtype=torch.float32):
    model = Res8(num_labels=4).to(dtype).eval()
    model.load_state_dict(cast_compute_dtype(res8_variables_to_state_dict(variables), dtype), strict=True)
    return model


def test_state_dict_loads_strictly_and_round_trips(weights):
    variables, _ = weights
    state = res8_variables_to_state_dict(variables)
    model = Res8(num_labels=4)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        model.conv3.weight.detach().numpy(), variables["params"]["conv3"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(model.bn4.running_var.numpy(), variables["batch_stats"]["bn4"]["var"])
    np.testing.assert_array_equal(model.output.weight.detach().numpy(), variables["params"]["output"]["kernel"].T)


@pytest.mark.parametrize("method", ["stem_features", "trunk_features", "__call__"])
def test_res8_matches_flax_f32(weights, method):
    variables, feats = weights
    flax_model = jax_create_model("res8", num_labels=4)
    kw = {} if method == "stem_features" else {"train": False}
    want = np.asarray(flax_model.apply(variables, jnp.asarray(feats), method=method, **kw))
    model = _torch_res8(variables)
    with torch.no_grad():
        x = torch.from_numpy(feats)
        got = (model if method == "__call__" else getattr(model, method))(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_residual_features_and_head_match_flax_f32(weights):
    variables, feats = weights
    flax_model = jax_create_model("res8", num_labels=4)
    s0 = np.array(flax_model.apply(variables, jnp.asarray(feats), method="stem_features"))
    want = np.array(flax_model.apply(variables, jnp.asarray(s0), train=False, method="residual_features"))
    pooled = want.mean(axis=(1, 2))
    want_logits = np.asarray(flax_model.apply(variables, jnp.asarray(pooled), method="head"))
    model = _torch_res8(variables)
    with torch.no_grad():
        got = model.residual_features(torch.from_numpy(s0)).numpy()
        got_logits = model.head(torch.from_numpy(pooled)).numpy()
    assert got.shape == want.shape == s0.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4)


def test_res8_matches_flax_bf16_logits(weights):
    variables, feats = weights
    flax_model = jax_create_model("res8", num_labels=4, dtype=jnp.bfloat16)
    want = np.asarray(
        flax_model.apply(jax_cast_compute_dtype(variables, jnp.bfloat16), jnp.asarray(feats), train=False)
    )
    model = _torch_res8(variables, torch.bfloat16)
    assert model.conv0.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert got.dtype == torch.float32  # the head runs in float32 on rounded weights
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


def test_cast_compute_dtype_rounds_every_float_leaf(weights):
    state = cast_compute_dtype(res8_variables_to_state_dict(weights[0]), torch.bfloat16)
    for name, value in state.items():
        want = torch.long if name.endswith("num_batches_tracked") else torch.bfloat16
        assert value.dtype == want, name
    assert cast_compute_dtype(state, None) is state


def test_registry_has_res8_and_names_unported_models():
    """res8 and, since the zoo was ported, the other families build; an
    unknown name raises."""
    from howl_tpu_torch.models.rnn import SimpleLstm

    assert model_spec("res8").supports_trunk
    assert isinstance(create_model("res8", num_labels=3), Res8)
    assert isinstance(create_model("lstm", num_labels=3), SimpleLstm) and model_spec("lstm").is_recurrent
    with pytest.raises(ValueError, match="unknown model"):
        model_spec("res9")
