"""The port's model zoo (howl_tpu_torch/models) against the JAX package's
modules on the same weights, bridged by howl_tpu_torch.compat.

Weights come from each flax module's own initializer, with nonzero
BatchNorm running stats and biases drawn from a numpy seed; the inputs too.
The families run at narrow widths (``FAMILY_KW``) on 40 mels. Tolerances:
float32 logits atol 1e-4, rtol 1e-5; the weight bridges exact; logits of
the JAX module on weights read back through ``howl_tpu.compat`` (the
reference howl names) atol 1e-5; bf16 logits (weights cast on both sides)
atol 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu import compat as jax_compat
from howl_tpu.inference.config import cast_compute_dtype as jax_cast_compute_dtype
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.models.base import MODEL_REGISTRY as JAX_REGISTRY
from howl_tpu.models.base import ConvertedStaticModel as JaxConvertedStaticModel
from howl_tpu_torch import compat
from howl_tpu_torch.inference.config import cast_compute_dtype
from howl_tpu_torch.models import ConvertedStaticModel, create_model, model_spec
from howl_tpu_torch.models.cnn import SequentialCnn, SmallCnn
from howl_tpu_torch.models.mobilenet import MobileNetClassifier, same_pads
from howl_tpu_torch.models.rnn import LASClassifier, SequentialLstm, SimpleGru, SimpleLstm, recurrence_backend

torch.set_num_threads(1)

FAMILIES = ("small-cnn", "seq-cnn", "mobilenet", "lstm", "seq-lstm", "gru", "las")
CLASSES = {"small-cnn": SmallCnn, "seq-cnn": SequentialCnn, "mobilenet": MobileNetClassifier, "lstm": SimpleLstm,
           "seq-lstm": SequentialLstm, "gru": SimpleGru, "las": LASClassifier}
# narrow widths; small-cnn's fc1 input is (2 time x 3 frequency x 16 maps) of a 41-frame window
FAMILY_KW = {
    "small-cnn": dict(num_maps1=8, num_maps2=16, hidden_size=32),
    "seq-cnn": dict(num_maps1=8, num_maps2=16, hidden_size=32),
    "mobilenet": dict(width_mult=0.25),
    "lstm": dict(hidden_size=16),
    "seq-lstm": dict(hidden_size=16),
    "gru": dict(hidden_size=16, num_latent_channels=4),
    "las": dict(hidden_size=16, num_latent_channels=4, dnn_size=32),
}
PORT_KW = {"small-cnn": dict(num_hidden_input=96)}
REFERENCE_NAMED = ("lstm", "seq-lstm", "gru", "las")  # the families howl_tpu.compat reads
N_LABELS = 4


def jax_family_variables(name: str, seed: int) -> dict:
    """The flax module's initial variables (numpy), with BatchNorm running
    stats, scales and biases drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    model = jax_create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 3, 40, 41)), train=False)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)

    def vary(path, leaf):
        key = path[-1].key
        if key == "mean":
            return rng.normal(0.0, 0.2, leaf.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if key == "scale":
            return (1.0 + rng.normal(0.0, 0.2, leaf.shape)).astype(np.float32)
        if key == "bias":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(vary, variables)


def port_model(name: str, variables, dtype=torch.float32) -> torch.nn.Module:
    model = create_model(name, num_labels=N_LABELS, **FAMILY_KW[name], **PORT_KW.get(name, {})).to(dtype).eval()
    model.load_state_dict(cast_compute_dtype(compat.variables_to_state_dict(name, variables), dtype), strict=True)
    return model


def features(seed: int, batch: int = 2, frames: int = 41) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, 3, 40, frames)) * 0.8).astype(np.float32)


def jax_logits(name, variables, x, **kw):
    model = jax_create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False, **kw))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    return name, jax_family_variables(name, 3 + FAMILIES.index(name))


def test_every_jax_model_name_builds_with_the_jax_flags_and_defaults():
    assert set(JAX_REGISTRY) == {"res8", *FAMILIES}
    for name in FAMILIES:
        spec, jax_spec = model_spec(name), JAX_REGISTRY[name]
        assert isinstance(create_model(name, num_labels=3), CLASSES[name])
        for flag in ("is_sequential", "is_recurrent", "uses_deltas", "supports_trunk"):
            assert getattr(spec, flag) == getattr(jax_spec, flag), (name, flag)
        assert spec.defaults == jax_spec.defaults and CLASSES[name].registered_name == name


@pytest.mark.parametrize("frames", [41, 101])
def test_float32_logits_match_the_jax_module(family, frames):
    name, variables = family
    if name == "small-cnn" and frames > 41:
        frames = 40  # its dense layer takes one window's width: 40 frames pool as 41 do
    x = features(7, frames=frames)
    got = port_model(name, variables)(torch.from_numpy(x)).detach().numpy()
    want = jax_logits(name, variables, x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_bf16_logits_follow_the_jax_cast(family):
    """Both sides cast every weight to bf16 (the engines' serving cast); the
    logits stay float32."""
    name, variables = family
    x = features(8)
    got = port_model(name, variables, torch.bfloat16)(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    want = jax_logits(name, jax_cast_compute_dtype(variables, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-2)


def test_bridge_round_trips_both_ways(family):
    name, variables = family
    state = compat.variables_to_state_dict(name, variables)
    back = compat.state_dict_to_variables(name, state)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    again = compat.variables_to_state_dict(name, back)
    assert list(again) == list(state)
    for key in state:
        torch.testing.assert_close(again[key], state[key], rtol=0, atol=0, msg=key)
    assert set(state) == set(port_model(name, variables).state_dict())


@pytest.mark.parametrize("name", REFERENCE_NAMED)
def test_reference_named_state_dict_reads_back_through_the_jax_import(name):
    """A second oracle: the JAX package's importer of reference howl
    checkpoints reads the port's state dict by its names, and the JAX
    module on what it reads gives the same logits."""
    variables = jax_family_variables(name, 40 + REFERENCE_NAMED.index(name))
    state = port_model(name, variables).state_dict()
    imported = jax_compat.torch_state_to_variables(name, state)
    x = features(9, frames=53)
    np.testing.assert_allclose(jax_logits(name, imported, x), jax_logits(name, variables, x), atol=1e-5)
    np.testing.assert_allclose(port_model(name, variables)(torch.from_numpy(x)).detach().numpy(),
                               jax_logits(name, imported, x), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("frames,pads", [(41, (0, 1)), (43, (1, 1))], ids=["even", "odd"])
def test_mobilenet_same_padding_on_even_and_odd_heights(frames, pads):
    """After the downsample conv and its time pool the stem sees (frames + 4)
    // 2 frames: 22 (even) at 41, where SAME pads (0, 1) and Conv2d(padding=1)
    would shift every later layer, and 23 (odd) at 43."""
    assert same_pads((frames + 4) // 2, 3, 2) == pads and same_pads(40, 3, 2) == (0, 1)
    variables = jax_family_variables("mobilenet", 17)
    x = features(10, frames=frames)
    np.testing.assert_allclose(port_model("mobilenet", variables)(torch.from_numpy(x)).detach().numpy(),
                               jax_logits("mobilenet", variables, x), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["lstm", "gru", "las"])
def test_lengths_shorter_than_the_clip(name):
    """Clips of 61, 37 and 50 true frames padded to 61: the carry of the
    last valid frame (lstm, gru) and las's masked attention over the valid
    prefix, its backward LSTM run over that prefix alone."""
    variables = jax_family_variables(name, 21)
    x = features(11, batch=3, frames=61)
    lengths = np.array([61, 37, 50], np.int32)
    got = port_model(name, variables)(torch.from_numpy(x), lengths=torch.from_numpy(lengths)).detach().numpy()
    want = jax_logits(name, variables, x, lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    full = jax_logits(name, variables, x)
    assert np.abs(want[1:] - full[1:]).max() > 1e-3  # the lengths change the short clips' logits


@pytest.mark.parametrize("name", ["lstm", "seq-lstm", "gru"])
def test_carry_in_and_out_matches_flax(name):
    """A carry threaded through two calls, as the engines' carry_windows
    does: torch's (h, c) against flax's (c, h)."""
    variables = jax_family_variables(name, 25)
    pt, jm = port_model(name, variables), jax_create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    x1, x2 = features(12), features(13)
    o1, c1 = pt(torch.from_numpy(x1), return_carry=True)
    o2, c2 = pt(torch.from_numpy(x2), carry=c1, return_carry=True)
    j1, jc1 = jm.apply(variables, jnp.asarray(x1), train=False, return_carry=True)
    j2, jc2 = jm.apply(variables, jnp.asarray(x2), train=False, carry=jc1, return_carry=True)
    np.testing.assert_allclose(o2.detach().numpy(), np.asarray(j2), atol=1e-4, rtol=1e-5)
    if name == "gru":
        np.testing.assert_allclose(c2[0].detach().numpy(), np.asarray(jc2), atol=1e-5)
    else:
        np.testing.assert_allclose(c2[0][0].detach().numpy(), np.asarray(jc2[1]), atol=1e-5)  # h
        np.testing.assert_allclose(c2[1][0].detach().numpy(), np.asarray(jc2[0]), atol=1e-5)  # c


@pytest.mark.parametrize("frames", [40, 97])
def test_converted_static_model_matches_jax_and_refuses_short_clips(frames):
    variables = jax_family_variables("small-cnn", 31)
    inner = port_model("small-cnn", variables)
    jax_inner = jax_create_model("small-cnn", num_labels=N_LABELS, **FAMILY_KW["small-cnn"])
    conv, jax_conv = ConvertedStaticModel(inner), JaxConvertedStaticModel(jax_inner)
    x = features(14, frames=frames)
    got = conv(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax_conv.apply({k: {"inner": v} for k, v in variables.items()}, jnp.asarray(x)))
    assert got.shape == want.shape == ((frames - 40) // 10 + 1, 2, N_LABELS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    lengths = np.array([frames, 45, 12])
    np.testing.assert_array_equal(conv.compute_length(torch.from_numpy(lengths)).numpy(),
                                  np.asarray(jax_conv.compute_length(jnp.asarray(lengths))))
    with pytest.raises(ValueError, match="at least one window"):
        conv(torch.zeros((1, 3, 40, 39)))


def test_sequential_cnn_compute_length_is_the_jax_modules():
    jm = jax_create_model("seq-cnn", num_labels=N_LABELS)
    pt = create_model("seq-cnn", num_labels=N_LABELS)
    lengths = np.arange(20, 200, 7)
    np.testing.assert_array_equal(pt.compute_length(torch.from_numpy(lengths)).numpy(),
                                  np.asarray(jm.compute_length(jnp.asarray(lengths))))
    x = torch.zeros((1, 3, 40, 123))
    assert pt.eval()(x).shape[0] == int(pt.compute_length(123))


def test_mixed_precision_dtype_waits_for_the_families_training():
    """A bf16 lstm runs on bf16 casts of its float32 parameters: the
    parameters stay float32, the logits are float32 and near the float32
    model's (the mixed-precision forwards are held against flax's in
    tests/test_torch_train_families.py)."""
    model = port_model("lstm", jax_family_variables("lstm", 11))
    x = torch.from_numpy(features(12))
    want = model(x)
    model.dtype = torch.bfloat16
    got = model(x)
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=5e-2)
    assert recurrence_backend(torch.zeros(1)) == "cpu"

