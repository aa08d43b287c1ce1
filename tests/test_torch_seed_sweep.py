"""The port's seed sweep (howl_tpu_torch/parallel/seed_sweep.py) against
JAX's vmapped step and against the port's own single-seed steps.

* A two-seed sweep step equals ``howl_tpu.parallel.seed_sweep``'s
  ``make_seed_sweep_step`` (``jax.vmap`` over the per-model step) from the
  same initial weights (JAX's seeds' states, carried across by
  ``compat.variables_to_state_dict``) with JAX's per-seed draws restated by
  ``jax_step_draws``, augmentation and the noise bank on: each seed's loss
  within 1e-4 relative (the single augmented step's tolerance,
  tests/test_torch_train_step.py) and its parameters within 2 lr + 1e-6,
  with over 99.9 % of them within 1e-5. AdamW's first update moves each
  weight by about lr times the sign of its gradient, so a weight whose
  gradient lies within float32 noise of zero moves by up to 2 lr
  differently in the two packages (tests/test_torch_train_run.py).
* The same sweep equals two single-seed port steps, seed s at key s, each
  with draws from its own generator, over two steps: losses within 1e-6
  relative (the tolerance ``chip_smoke.py`` holds the card to) and
  parameters equal, for the frame objective with replacement mixing and for
  CTC on seq-cnn.
* K3's plain version stacked over S x B examples equals S separate calls
  bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.models import create_model as jcreate_model
from howl_tpu.parallel import seed_sweep as jsweep
from howl_tpu.training import step as jstep
from howl_tpu_torch.models import create_model
from howl_tpu_torch.models.base import model_spec
from howl_tpu_torch.ops import augment as taug
from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_plain
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.parallel import SeedSweepStep, create_seed_states, make_seed_sweep_step, shard_seed_batch
from howl_tpu_torch.training.step import StepConfig, make_classification_train_step, make_ctc_train_step
from tests.test_torch_train_step import B, N, _cfgs, jax_step_draws

torch.set_num_threads(1)
SEEDS = [0, 1]
OPT = dict(learning_rate=0.01, lr_decay=0.99, steps_per_epoch=100)


def _bank(seed=3):
    return (np.random.default_rng(seed).standard_normal((3, 9000)) * 0.05).astype(np.float32)


def _batch(seed, s=len(SEEDS), labels=4):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((s, B, N)) * 0.1).astype(np.float32)
    return audio, rng.integers(0, labels, (s, B)).astype(np.int32)


def _params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def test_two_seed_sweep_matches_jax_vmapped_step():
    jcfg, tcfg = _cfgs(True, replace_prob=0.3, vtlp_prob=1.0)
    bank = _bank()
    audio, labels = _batch(11)
    jmodel = jcreate_model("res8", num_labels=4)
    jstates = jsweep.create_seed_states(jmodel, SEEDS, np.zeros((1, 1, 40, 41), np.float32), **OPT)
    variables = [jax.device_get({"params": jax.tree.map(lambda x: x[s], jstates.params),
                                 "batch_stats": jax.tree.map(lambda x: x[s], jstates.batch_stats)}) for s in SEEDS]
    keys = jax.vmap(jax.random.PRNGKey)(np.asarray(SEEDS))
    jax_step = jsweep.make_seed_sweep_step(jstep.make_classification_train_step(jmodel, jcfg, jnp.asarray(bank)))
    new_jstates, jmetrics = jax_step(jstates, jnp.asarray(audio), jnp.asarray(labels), None, keys)

    states = create_seed_states(create_model("res8", num_labels=4), SEEDS, variables=variables, device="cpu", **OPT)
    sweep = make_seed_sweep_step(make_classification_train_step(create_model("res8", num_labels=4), tcfg, bank))
    draws = [jax_step_draws(keys[s], 0, jcfg, bank.shape) for s in range(len(SEEDS))]
    assert any(bool(d.augment.mix.replaced.any()) for d in draws)  # a replaced clip is relabelled
    states, metrics = sweep(states, torch.from_numpy(audio), torch.from_numpy(labels), None, SEEDS, draws=draws)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=1e-4)
    assert [st.step for st in states] == np.asarray(new_jstates.step).tolist() == [1, 1]
    from howl_tpu_torch.compat import variables_to_state_dict

    lr = OPT["learning_rate"]
    for s, st in enumerate(states):
        want = variables_to_state_dict("res8", jax.device_get({
            "params": jax.tree.map(lambda x: x[s], new_jstates.params),
            "batch_stats": jax.tree.map(lambda x: x[s], new_jstates.batch_stats)}))
        got = _params(st)
        diffs = torch.cat([(got[k].float() - torch.as_tensor(np.asarray(want[k])).float()).abs().flatten()
                           for k in got if got[k].is_floating_point()])
        assert float(diffs.max()) <= 2 * lr + 1e-6
        assert float((diffs > 1e-5).float().mean()) < 1e-3, int((diffs > 1e-5).sum())


def _frame_setup():
    _, tcfg = _cfgs(True, replace_prob=0.3)
    bank = _bank(5)
    audio, labels = _batch(12)
    make = lambda: make_classification_train_step(create_model("res8", num_labels=4), tcfg, bank)  # noqa: E731
    states = lambda seeds: create_seed_states(create_model("res8", num_labels=4), seeds, device="cpu", **OPT)  # noqa: E731
    return make, states, (audio, labels, None)


def _ctc_setup():
    name = "seq-cnn"
    cfg = StepConfig(FrontendConfig(n_mels=40), 2.05, 1.0, augment=taug.AugmentConfig(), negative_label=3,
                     blank_label=4, use_deltas=model_spec(name).uses_deltas)
    bank = _bank(6)
    rng = np.random.default_rng(13)
    audio = (rng.standard_normal((len(SEEDS), B, N)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 3, (len(SEEDS), B, 3)).astype(np.int64)
    audio_lengths = rng.integers(N // 2, N + 1, (len(SEEDS), B)).astype(np.int64)
    label_lengths = rng.integers(1, 4, (len(SEEDS), B)).astype(np.int64)
    make = lambda: make_ctc_train_step(create_model(name, num_labels=5), cfg, bank)  # noqa: E731
    states = lambda seeds: create_seed_states(create_model(name, num_labels=5), seeds, device="cpu", **OPT)  # noqa: E731
    return make, states, (audio, labels, audio_lengths, label_lengths)


@pytest.mark.parametrize("objective", ["frame", "ctc"])
def test_sweep_equals_single_seed_steps(objective):
    make, make_states, arrays = (_frame_setup if objective == "frame" else _ctc_setup)()
    sweep = make_seed_sweep_step(make())
    assert isinstance(sweep, SeedSweepStep)
    states = make_states(SEEDS)
    singles = [make_states([s])[0] for s in SEEDS]
    single_step = make()
    batch = shard_seed_batch([x for x in arrays if x is not None], "cpu")
    if objective == "frame":
        batch = (*batch, None)
    for _ in range(2):
        states, metrics = sweep(states, *batch, SEEDS)
        for s in SEEDS:
            singles[s], m = single_step(singles[s], *(None if x is None else x[s] for x in batch), s)
            np.testing.assert_allclose(float(metrics["loss"][s]), float(m["loss"]), rtol=1e-6)
            if objective == "frame":
                assert float(metrics["accuracy"][s]) == float(m["accuracy"])
    for st, single in zip(states, singles):
        assert st.step == single.step == 2
        got, want = _params(st), _params(single)
        assert all(torch.equal(got[k], want[k]) for k in got)
    # the two seeds trained different models from different initial weights
    assert not torch.equal(_params(states[0])[next(iter(_params(states[0])))],
                           _params(states[1])[next(iter(_params(states[1])))])


def test_sweep_refuses_a_seed_count_it_was_not_given():
    make, make_states, (audio, labels, _) = _frame_setup()
    with pytest.raises(ValueError, match="3 seeds"):
        make_seed_sweep_step(make())(make_states(SEEDS), torch.zeros((3, B, N)), torch.zeros((3, B)), None, [0, 1, 2])


@pytest.mark.parametrize("bank_w", [5000, 32000])
def test_k3_plain_stacked_equals_separate_calls(bank_w):
    rng = np.random.default_rng(bank_w)
    s, b, n = 3, 5, 4000
    audio = torch.from_numpy((rng.standard_normal((s, b, n)) * 0.1).astype(np.float32))
    prep = taug.prepare_noise_bank(rng.standard_normal((4, bank_w)).astype(np.float32), n)
    gens = [torch.Generator().manual_seed(i) for i in range(s)]
    draws = [taug.draw_mix_noise_bank(g, b, prep, taug.AugmentConfig(), replace_prob=0.2) for g in gens]
    stacked = mix_noise_bank_plain(audio.reshape(s * b, n), prep.extended, torch.cat([d.rows for d in draws]),
                                   torch.cat([d.offs for d in draws]), torch.cat([d.alpha for d in draws]))
    for i, d in enumerate(draws):
        alone = mix_noise_bank_plain(audio[i], prep.extended, d.rows, d.offs, d.alpha)
        assert torch.equal(stacked[i * b : (i + 1) * b], alone)
    assert not torch.equal(stacked, audio.reshape(s * b, n))  # rows were mixed
