"""The zoo's families in training (howl_tpu_torch/models, training/) against
howl_tpu on the same weights: flax's BatchNorm in training (ROADMAP F16),
flax's mixed precision, the CTC loss and step, the frame step with lengths,
and the training entry point's flag sets that need a family.

* F16: one training-mode forward of ``SmallCnn`` and ``MobileNetClassifier``
  moves every BatchNorm's running mean and variance as flax's does (momentum
  0.99, the batch's biased variance): each layer fed flax's input within
  1e-6; the whole forward within 1e-4 relative (MobileNet's deep layers
  see float32 convs summed in another order).
* Mixed precision: each family with ``dtype=torch.bfloat16`` over float32
  weights against the flax module with ``dtype=jnp.bfloat16``; logits within
  5e-2 (both round activations to bf16, in other places), and the
  parameters stay float32.
* ``ctc_loss``: values and gradients against JAX's ``ctc_loss`` (optax)
  within 1e-5, with the blank at 0 and at the last label, repeated labels,
  targets of one label, and full length without padding
  (``tests/test_ctc_vs_torch.py``'s cases).
* Steps, from equal weights and replayed draws (the ``jax_*_draws`` helpers
  of ``tests/test_torch_augment.py``, augmentation with a noise bank and
  VTLP): one CTC step of seq-cnn (its dropout mask replayed: recorded by a
  flax interceptor that restates ``nn.Dropout``, from the step's dropout
  key on the model's forward) and one frame step of lstm with sample
  lengths; the loss within 1e-4 relative.
* The entry point, on the CPU: each flag set that needs a family (``--model
  las``, ``--model mobilenet``, ``OBJECTIVE=ctc`` with seq-cnn,
  ``CONVERT_STATIC=true`` with small-cnn under CTC, ``--bf16`` with gru)
  trains one epoch on ``tests/fixtures.make_wakeword_corpus`` and writes its
  workspace, as ``tests/test_all_models_train.py`` runs the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu.training import step as jstep
from howl_tpu.training.objectives import ctc_loss as jax_ctc_loss
from howl_tpu.training.state import create_train_state as jax_create_train_state
from howl_tpu_torch import compat
from howl_tpu_torch.models import create_model
from howl_tpu_torch.models.base import AffineBatchNorm
from howl_tpu_torch.ops import augment as taug
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.training import objectives
from howl_tpu_torch.training.state import create_train_state
from howl_tpu_torch.training.step import (
    StepConfig,
    make_classification_train_step,
    make_ctc_train_step,
)
from tests.fixtures import make_wakeword_corpus
from tests.test_torch_models import FAMILIES, FAMILY_KW, N_LABELS, features, jax_family_variables, port_model
from tests.test_torch_train_step import B, N, ZMUV, jax_step_draws

torch.set_num_threads(1)

# ---- F16: flax's BatchNorm in training ----


@pytest.mark.parametrize("name", ["small-cnn", "mobilenet"])
def test_f16_running_stats_move_as_flaxs(name):
    """Each BatchNorm fed the input flax's saw (recorded by an interceptor)
    moves its running stats as flax's within 1e-6; the whole training
    forward moves them within 1e-4 relative, where the convs before them
    sum in another order (2.4e-5 at most through MobileNet's 17 blocks)."""
    variables = jax_family_variables(name, 30)
    x = features(31, batch=3)
    jmodel = jax_create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    order = []

    def record_bn_inputs(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.BatchNorm) and context.method_name == "__call__":
            order.append(context.module.path)
            context.module.sow("intermediates", "bn_input", args[0])
        return next_fun(*args, **kwargs)

    def apply(v, x):
        with fnn.intercept_methods(record_bn_inputs):
            return jmodel.apply(v, x, train=True, mutable=["batch_stats", "intermediates"],
                                rngs={"dropout": jax.random.PRNGKey(0)})

    _, mutated = jax.jit(apply)(variables, jnp.asarray(x))
    want = jax.tree.map(np.asarray, mutated["batch_stats"])
    model = port_model(name, variables).train()
    bns = [m for m in model.modules() if isinstance(m, AffineBatchNorm)]
    assert len(bns) == len(order)
    for bn, path in zip(bns, order):
        seen = mutated["intermediates"]
        for key in path:
            seen = seen[key]
        bn(torch.from_numpy(np.array(seen["bn_input"][0])).permute(0, 3, 1, 2))  # NHWC -> NCHW
    layerwise = compat.state_dict_to_variables(name, model.state_dict())["batch_stats"]
    whole = port_model(name, variables).train()
    whole(torch.from_numpy(x))
    forward = compat.state_dict_to_variables(name, whole.state_dict())["batch_stats"]
    assert jax.tree.structure(layerwise) == jax.tree.structure(want) == jax.tree.structure(forward)
    for g, f, w, before in zip(*(jax.tree.leaves(t) for t in (layerwise, forward, want, variables["batch_stats"]))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(f, w, rtol=1e-4, atol=1e-6)
        assert np.abs(g - before).max() > 0  # every BatchNorm moved


# ---- flax's mixed precision ----


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_forward_follows_flaxs_mixed_precision(name):
    variables = jax_family_variables(name, 40 + FAMILIES.index(name))
    x = features(41)
    want = np.asarray(jax_create_model(name, num_labels=N_LABELS, dtype=jnp.bfloat16, **FAMILY_KW[name]).apply(
        variables, jnp.asarray(x), train=False))
    model = port_model(name, variables)
    model.dtype = torch.bfloat16
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in model.parameters())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-2)


# ---- CTC ----


def _ctc_case(kind, rng):
    """(logits (T, B, L), logit lengths, labels (B, U), label lengths, blank)."""
    if kind in ("blank-0", "blank-last"):
        blank = 0 if kind == "blank-0" else 3
        logits = rng.standard_normal((24, 6, 4)).astype(np.float32)
        logit_lengths = rng.integers(10, 25, 6).astype(np.int32)
        label_lengths = rng.integers(1, 6, 6).astype(np.int32)
        non_blank = np.array([k for k in range(4) if k != blank])
        labels = non_blank[rng.integers(0, 3, (6, 5))].astype(np.int32)
        labels[np.arange(5)[None, :] >= label_lengths[:, None]] = non_blank[0]
        return logits, logit_lengths, labels, label_lengths, blank
    if kind == "repeats-short":
        logits = rng.standard_normal((12, 4, 3)).astype(np.float32)
        return (logits, np.array([12, 9, 7, 5], np.int32), np.array([[1, 1, 1], [0, 0, 1], [1, 0, 0], [0, 0, 0]], np.int32),
                np.array([3, 2, 1, 1], np.int32), 2)
    logits = rng.standard_normal((16, 3, 5)).astype(np.float32)
    return logits, np.full(3, 16, np.int32), rng.integers(1, 5, (3, 6)).astype(np.int32), np.full(3, 6, np.int32), 0


@pytest.mark.parametrize("kind", ["blank-0", "blank-last", "repeats-short", "full-length"])
def test_ctc_loss_and_grads_match_jax(kind):
    logits, logit_lengths, labels, label_lengths, blank = _ctc_case(kind, np.random.default_rng(50))
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda lg: jax_ctc_loss(lg, jnp.asarray(logit_lengths), jnp.asarray(labels), jnp.asarray(label_lengths), blank)
    ))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = objectives.ctc_loss(t, torch.from_numpy(logit_lengths), torch.from_numpy(labels),
                              torch.from_numpy(label_lengths), blank)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)
    assert (t.grad.numpy()[np.arange(logits.shape[0])[:, None] >= logit_lengths[None, :]] == 0).all()


# ---- the steps, from equal weights and replayed draws ----


def _dropout_recorder(masks: list):
    """A flax interceptor that restates ``nn.Dropout.__call__`` (one
    ``make_rng``, a Bernoulli keep mask, x / keep_prob where kept) and
    records each mask."""

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        inputs = args[0]
        if module.rate == 0.0 or fnn.merge_param("deterministic", module.deterministic, kwargs.get("deterministic")):
            return inputs
        keep_prob = 1.0 - module.rate
        keep = jax.random.bernoulli(module.make_rng(module.rng_collection), p=keep_prob, shape=inputs.shape)
        masks.append(np.asarray(keep))
        return jax.lax.select(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    return interceptor


def _cfgs(**kw):
    jcfg = jstep.StepConfig(JaxFrontendConfig(n_mels=40), *ZMUV, augment=JaxAugmentConfig(), negative_label=3,
                            use_deltas=False, vtlp_prob=1.0, **kw)
    tcfg = StepConfig(FrontendConfig(n_mels=40), *ZMUV, augment=taug.AugmentConfig(), negative_label=3,
                      use_deltas=False, vtlp_prob=1.0, **kw)
    return jcfg, tcfg


def _states(name, variables):
    jmodel = jax_create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    jstate = jax_create_train_state(jmodel, jax.random.PRNGKey(0), np.zeros((1, 1, 40, 41), np.float32),
                                    learning_rate=0.01, lr_decay=0.99, steps_per_epoch=100)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                            batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})))
    model = create_model(name, num_labels=N_LABELS, **FAMILY_KW[name])
    state = create_train_state(model, 0.01, lr_decay=0.99, steps_per_epoch=100, variables=variables, device="cpu")
    return jmodel, jstate, model, state


def _audio(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N)) * 0.1).astype(np.float32), rng


def test_ctc_step_of_seq_cnn_replays_jaxs_draws():
    variables = jax_family_variables("seq-cnn", 60)
    audio, rng = _audio(61)
    bank = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    labels = np.array([[0, 1, 2], [2, 2, 0], [1, 0, 0], [0, 0, 0]], np.int32)
    audio_lengths, label_lengths = np.array([8000, 7000, 6000, 8000], np.int32), np.array([3, 2, 1, 1], np.int32)
    jcfg, tcfg = _cfgs(blank_label=3)
    key = jax.random.PRNGKey(62)
    jmodel, jstate, model, state = _states("seq-cnn", variables)
    args = (jnp.asarray(audio), jnp.asarray(labels), jnp.asarray(audio_lengths), jnp.asarray(label_lengths), key)
    _, want = jstep.make_ctc_train_step(jmodel, jcfg, jnp.asarray(bank))(jstate, *args)
    # the step's dropout key, as the JAX step splits it; a mask depends on the key and the shape only
    k_drop = jax.random.split(jax.random.fold_in(key, 0), 4)[3]
    masks = []
    with fnn.intercept_methods(_dropout_recorder(masks)):
        jmodel.apply(variables, jnp.zeros((B, 1, 40, jcfg.frontend.num_frames(N))), train=True,
                     mutable=["batch_stats"], rngs={"dropout": k_drop})
    assert len(masks) == 1 and 0 < masks[0].mean() < 1
    draws = jax_step_draws(key, 0, jcfg._replace(replace_prob=0.0), bank.shape)._replace(dropout=masks)
    step = make_ctc_train_step(model, tcfg, bank)
    state, got = step(state, torch.from_numpy(audio), torch.from_numpy(labels), torch.from_numpy(audio_lengths),
                      torch.from_numpy(label_lengths), 62, draws=draws)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    assert state.step == 1 and all(p.grad is not None for p in state.model.parameters())


def test_frame_step_of_lstm_takes_the_lengths():
    variables = jax_family_variables("lstm", 70)
    audio, rng = _audio(71)
    bank = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    labels = rng.integers(0, 4, B).astype(np.int32)
    lengths = np.array([8000, 6000, 7000, 3000], np.int32)
    jcfg, tcfg = _cfgs(replace_prob=0.3)
    key = jax.random.PRNGKey(72)
    jmodel, jstate, model, state = _states("lstm", variables)
    _, want = jstep.make_classification_train_step(jmodel, jcfg, jnp.asarray(bank))(
        jstate, jnp.asarray(audio), jnp.asarray(labels), jnp.asarray(lengths), key)
    _, without = jstep.make_classification_train_step(jmodel, jcfg, jnp.asarray(bank))(
        jstate, jnp.asarray(audio), jnp.asarray(labels), None, key)
    assert abs(float(want["loss"]) - float(without["loss"])) > 1e-3  # the lengths change the loss
    step = make_classification_train_step(model, tcfg, bank)
    state, got = step(state, torch.from_numpy(audio), torch.from_numpy(labels), torch.from_numpy(lengths), 72,
                      draws=jax_step_draws(key, 0, jcfg, bank.shape))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    assert float(got["accuracy"]) == float(want["accuracy"])


# ---- the entry point ----

ENTRY_ENV = {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "NUM_EPOCHS": "1", "BATCH_SIZE": "4",
             "LEARNING_RATE": "0.001", "MAX_WINDOW_SIZE_SECONDS": "0.5", "EVAL_STRIDE_SIZE_SECONDS": "0.0625",
             "NUM_MELS": "40"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_wakeword_corpus(tmp_path_factory.mktemp("families") / "ww", n_positive=6, n_negative=6)


@pytest.mark.parametrize("extra,env", [
    (["--model", "las"], {}),
    (["--model", "mobilenet"], {}),
    (["--model", "seq-cnn"], {"OBJECTIVE": "ctc"}),
    (["--model", "small-cnn"], {"OBJECTIVE": "ctc", "CONVERT_STATIC": "true"}),
    (["--model", "res8"], {"OBJECTIVE": "ctc", "CONVERT_STATIC": "true"}),
    (["--model", "gru", "--bf16"], {}),
], ids=["las", "mobilenet", "ctc", "convert-static", "res8-convert-static", "bf16"])
def test_family_flag_sets_train_through_the_entry_point(corpus, tmp_path, monkeypatch, extra, env):
    import howl_tpu_torch.training.run.train as ttrain

    for k, v in {**ENTRY_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    T_SETTINGS.reset()
    stats = ttrain.LoopStats()
    ws = tmp_path / "ws"
    try:
        results = ttrain.run([*extra, "--workspace", str(ws), "-i", str(corpus), "--eval-freq", "0",
                              "--steps-per-epoch", "2", "--no-augment", "--device", "cpu"], stats)
    finally:
        T_SETTINGS.reset()
    assert set(results) >= {"dev_pos", "dev_neg", "test_pos", "test_neg"}
    assert stats.steps == 2 and np.isfinite(stats.epoch_losses).all()
    for name in ("model.pt", "model-best.pt", "train_state.pt", "zmuv.json", "errors.tsv", "settings.json"):
        assert (ws / name).exists(), name
    state_dict = torch.load(ws / "model.pt", weights_only=True)
    assert all(v.dtype != torch.bfloat16 for v in state_dict.values())  # float32 masters, --bf16 too
    if "CONVERT_STATIC" in env:
        assert all(k.startswith("inner.") for k in state_dict)


def test_ctc_refuses_a_model_that_scores_windows(tmp_path, monkeypatch):
    import howl_tpu_torch.training.run.train as ttrain

    monkeypatch.setenv("OBJECTIVE", "ctc")
    T_SETTINGS.reset()
    try:
        with pytest.raises(ValueError, match="sequential model"):
            ttrain.run(["--model", "lstm", "--workspace", str(tmp_path / "ws"), "-i", str(tmp_path), "--device", "cpu"])
    finally:
        T_SETTINGS.reset()
    assert not (tmp_path / "ws").exists()
