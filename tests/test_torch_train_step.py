"""The port's train and eval steps (howl_tpu_torch/training/step.py) vs
howl_tpu's, from the same JAX-initialized res8 variables.

jax.random and torch draw differently, so the augmented step replays the
draws the JAX step makes from (key, step) through ``StepDraws``.

Tolerances: without augmentation the float32 loss 1e-5 relative, the
gradients and BatchNorm stats as in tests/test_torch_train_res8.py, on
ZMUV'd features; with augmentation, VTLP and the noise bank 1e-4 relative
(the VTLP filterbank and the frontend carry float32 rounding into the
loss); bf16 2e-2 relative (both sides round activations to bf16 at
different places); eval logits 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu.training import step as jstep
from howl_tpu.training.state import create_train_state as jax_create_train_state
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops import augment as taug
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.training.state import create_train_state
from howl_tpu_torch.training.step import (
    NoiseBankTrainStep,
    StepConfig,
    StepDraws,
    make_classification_eval_step,
    make_classification_train_step,
)
from tests.test_torch_augment import jax_augment_draws, jax_spec_draws
from tests.test_torch_train_res8 import (
    _jax_train_forward,
    assert_grads_close,
    assert_stats_close,
    jax_res8_variables,
    port_grads,
)

torch.set_num_threads(1)

B, N = 4, 8000
# the log-mel mean and std of these batches, as fit_zmuv fits them. Features
# far from zero mean make BatchNorm's E[x^2] - E[x]^2 cancel in float32, and
# then both sides' gradients drift ~1 % apart (measured with (-6, 4)).
ZMUV = (2.05, 1.0)


def _cfgs(augment: bool, **kw):
    jcfg = jstep.StepConfig(
        JaxFrontendConfig(n_mels=40), *ZMUV, augment=JaxAugmentConfig() if augment else None,
        negative_label=3, use_deltas=False, **kw,
    )
    tkw = {k: v for k, v in kw.items() if k != "dft_precision"}
    tcfg = StepConfig(
        FrontendConfig(n_mels=40), *ZMUV, augment=taug.AugmentConfig() if augment else None,
        negative_label=3, use_deltas=False, **tkw,
    )
    return jcfg, tcfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, N)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 4, B).astype(np.int32)
    return audio, labels


def _jax_state(variables, dtype=None):
    model = jax_create_model("res8", num_labels=4, **({"dtype": dtype} if dtype else {}))
    state = jax_create_train_state(
        model, jax.random.PRNGKey(0), np.zeros((1, 1, 40, 41), np.float32),
        learning_rate=0.01, lr_decay=0.99, steps_per_epoch=100,
    )
    return model, state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                                batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))


def _port_state(variables, dtype=None):
    model = create_model("res8", num_labels=4, dtype=dtype)
    return model, create_train_state(model, 0.01, lr_decay=0.99, steps_per_epoch=100, variables=variables, device="cpu")


def jax_step_draws(key, step, jcfg, bank_shape) -> StepDraws:
    """The draws of the JAX classification step at ``step``, restated."""
    k_wave, k_vtlp, k_spec, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    augment = jax_augment_draws(k_wave, B, N, jcfg.augment, bank_shape, jcfg.replace_prob)
    k_alpha, k_prob = jax.random.split(k_vtlp)
    alpha = jax.random.uniform(k_alpha, (), minval=0.9, maxval=1.1)
    alpha = jnp.where(jax.random.bernoulli(k_prob, jcfg.vtlp_prob), alpha, 1.0)
    spec = jax_spec_draws(k_spec, B, 40, jcfg.frontend.num_frames(N), jcfg.augment)
    return StepDraws(augment, torch.tensor(float(alpha)), spec)


def test_step_without_augmentation_matches_jax():
    variables = jax_res8_variables(21)
    audio, labels = _batch(1)
    jcfg, tcfg = _cfgs(False, use_vtlp=False)
    jmodel, jstate = _jax_state(variables)
    new_jstate, metrics = jstep.make_classification_train_step(jmodel, jcfg)(
        jstate, jnp.asarray(audio), jnp.asarray(labels), None, jax.random.PRNGKey(3)
    )
    feats = np.asarray(jstep.featurize(jnp.asarray(audio), jcfg))
    _, _, _, grads = _jax_train_forward(variables, feats, labels)
    model, state = _port_state(variables)
    step = make_classification_train_step(model, tcfg)
    state, got = step(state, torch.from_numpy(audio), torch.from_numpy(labels), None, 3)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    assert float(got["accuracy"]) == float(metrics["accuracy"])
    assert_grads_close(port_grads(state.model), grads)
    assert_stats_close(state.model, new_jstate.batch_stats)
    assert state.step == int(new_jstate.step) == 1


def test_augmented_step_with_vtlp_and_noise_bank_replays_jax_draws():
    variables = jax_res8_variables(22)
    audio, labels = _batch(2)
    bank = (np.random.default_rng(3).standard_normal((3, 9000)) * 0.05).astype(np.float32)
    jcfg, tcfg = _cfgs(True, replace_prob=0.3, vtlp_prob=1.0)
    key = jax.random.PRNGKey(7)  # draws that replace one clip, mix one and skip two
    jmodel, jstate = _jax_state(variables)
    jax_train = jstep.make_classification_train_step(jmodel, jcfg, jnp.asarray(bank))
    _, metrics = jax_train(jstate, jnp.asarray(audio), jnp.asarray(labels), None, key)
    draws = jax_step_draws(key, 0, jcfg, bank.shape)
    assert float(draws.vtlp_alpha) != 1.0 and bool(draws.augment.mix.replaced.any())
    model, state = _port_state(variables)
    step = make_classification_train_step(model, tcfg, bank)
    assert isinstance(step, NoiseBankTrainStep)
    _, got = step(state, torch.from_numpy(audio), torch.from_numpy(labels), None, 7, draws=draws)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-4)


def test_bf16_step_matches_jax_bf16():
    variables = jax_res8_variables(23)
    audio, labels = _batch(4)
    jcfg, tcfg = _cfgs(False, use_vtlp=False, dft_precision=jax.lax.Precision.HIGH)
    jmodel, jstate = _jax_state(variables, jnp.bfloat16)
    _, metrics = jstep.make_classification_train_step(jmodel, jcfg)(
        jstate, jnp.asarray(audio), jnp.asarray(labels), None, jax.random.PRNGKey(0)
    )
    model, state = _port_state(variables, torch.bfloat16)
    state, got = make_classification_train_step(model, tcfg)(
        state, torch.from_numpy(audio), torch.from_numpy(labels), None, 0
    )
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_eval_step_matches_jax():
    variables = jax_res8_variables(24)
    audio, _ = _batch(5)
    jcfg, tcfg = _cfgs(False)
    jmodel, jstate = _jax_state(variables)
    want = np.asarray(jstep.make_classification_eval_step(jmodel, jcfg)(jstate, jnp.asarray(audio), None))
    model, state = _port_state(variables)
    got = make_classification_eval_step(model, tcfg)(state, torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def tone_batch(rng, b, n, sample_rate=16000):
    """Tones in three frequency bands take labels 0-2; quiet noise label 3."""
    labels = rng.integers(0, 4, b)
    t = np.arange(n) / sample_rate
    freqs = np.array([300.0, 1000.0, 3000.0])[np.minimum(labels, 2)] * rng.uniform(0.9, 1.1, b)
    tones = 0.3 * np.sin(2 * np.pi * freqs[:, None] * t[None, :] + rng.uniform(0, 6.3, (b, 1)))
    noise = 0.003 * rng.standard_normal((b, n))
    return np.where(labels[:, None] < 3, tones, noise).astype(np.float32), labels


def test_loss_falls_on_synthetic_tones():
    rng = np.random.default_rng(0)
    audio, labels = tone_batch(rng, 16, N)
    bank = (rng.standard_normal((4, 9000)) * 0.02).astype(np.float32)
    _, tcfg = _cfgs(True, replace_prob=0.1)
    model = create_model("res8", num_labels=4)
    state = create_train_state(model, 0.01, lr_decay=0.99, steps_per_epoch=100, generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_classification_train_step(model, tcfg, bank)
    losses = [
        float(step(state, torch.from_numpy(audio), torch.from_numpy(labels), None, 11)[1]["loss"]) for _ in range(10)
    ]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_step_is_reproducible_from_key_and_step():
    audio, labels = _batch(6)
    bank = np.random.default_rng(7).standard_normal((2, 9000)).astype(np.float32)
    _, tcfg = _cfgs(True, replace_prob=0.2)

    def first_loss(key):
        model = create_model("res8", num_labels=4)
        state = create_train_state(model, 0.01, generator=torch.Generator().manual_seed(1), device="cpu")
        step = make_classification_train_step(model, tcfg, bank)
        return float(step(state, torch.from_numpy(audio), torch.from_numpy(labels), None, key)[1]["loss"])

    assert first_loss(9) == first_loss(9) != first_loss(10)


def test_noise_bank_step_caches_per_window_and_swaps_banks():
    bank = np.random.default_rng(8).standard_normal((2, 9000)).astype(np.float32)
    step = NoiseBankTrainStep(lambda *a, **k: k["noise_bank"], bank)
    assert step.prepared_for(8000) is step.prepared_for(8000)
    prep = taug.prepare_noise_bank(bank[:1], 8000)
    step.set_bank(prep)
    assert step(None, torch.zeros((2, 8000))) is prep
    with pytest.raises(ValueError, match="cannot serve 4000-sample windows"):
        step(None, torch.zeros((2, 4000)))
