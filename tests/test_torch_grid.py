"""The seed sweep on a (seed, data) grid (item 12): ``parallel/mesh.py``'s
``seed_group`` and ``sweep_mesh``, ``parallel/seed_sweep.py`` on a seed's
data group, and the two sweep entry points, on the CPU against howl_tpu
and against the port's one-process sweep.

* ``sweep_mesh`` lays out JAX's ``make_mesh(seed=S, data=max(n // S, 1))``
  over n cards, device for device, for n in {1, 2, 3, 4, 8} and S in {1,
  2, 3}; where S > n JAX's mesh does not fit (it raises) and the port's is
  (n, 1): one process, seed s on card s mod n.
* One sweep step on a (seed 2, data 2) grid of 4 gloo ranks equals JAX's
  ``make_seed_sweep_step`` on a (seed 2, data 2) mesh of 4 CPU devices and
  the port's one-process sweep, with and without augmentation (each seed's
  draws replayed from JAX's key): each seed's loss within rtol 1e-5 of the
  one-process sweep's and 1e-4 (augmented) or 1e-5 of JAX's, its
  parameters and BatchNorm statistics within ``_assert_state_close``'s
  tolerances (``tests/test_torch_scaleout.py``). Plain SGD, so the
  parameters compare the gradients.
* ``pretrain_gsc --sharded-seeds 2`` in that grid and
  ``eval_wake_word_detection --sharded-seeds -n 2`` through ``run(...,
  mesh=)`` on a (seed 2, data 2) mesh of ``["cpu"] * 4`` equal the
  one-process runs: the first step's per-seed losses within 1e-5 and each
  epoch's within ``LOSS_RTOL`` (AdamW turns float32 noise into +-lr
  moves), the same accuracies, the harness's per-seed counts at every threshold and
  its report files equal; every rank scores evaluator batches, and rank (s,
  0) alone writes seed s's workspace.

Two grids are spawned: the step test's (which also runs ``pretrain_gsc``)
and the harness's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import howl_tpu_torch.training.run.eval_wake_word_detection as tharness
import howl_tpu_torch.training.run.pretrain_gsc as tgsc
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.parallel import data_parallel
from howl_tpu_torch.parallel.mesh import make_mesh
from howl_tpu_torch.parallel.seed_sweep import sweep_mesh
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.training.run.train import LoopStats
from tests import torch_scaleout as helpers
from tests.fixtures import make_gsc_corpus, make_noise_dir, make_wakeword_corpus
from tests.test_torch_scaleout import B, N, _assert_state_close, _jax_draws, _jax_inputs
from tests.test_torch_train_run import LOSS_RTOL

torch.set_num_threads(2)
SEEDS = 2
VOCAB = ("yes", "no", "up", "down")
GSC_ENV = {"VOCAB": json.dumps(list(VOCAB)), "BATCH_SIZE": "8", "LEARNING_RATE": "0.001",
           "MAX_WINDOW_SIZE_SECONDS": "1.0", "NUM_MELS": "40", "NUM_EPOCHS": "2"}
GSC_ARGS = ["--model", "res8", "--num-labels", "5", "--device", "cpu", "--sharded-seeds", str(SEEDS)]


@pytest.fixture(autouse=True)
def _reset_settings(monkeypatch):
    monkeypatch.setattr(data_parallel, "TIMEOUT_S", helpers.TIMEOUT_S)
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()
    J_SETTINGS.reset()


# ---- the layout ----


@pytest.mark.parametrize("seeds", [1, 2, 3])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_sweep_mesh_lays_out_jaxs_mesh(n_dev, seeds):
    from howl_tpu.parallel.mesh import make_mesh as jax_make_mesh

    cards = [torch.device("cuda", i) for i in range(n_dev)]
    mesh = sweep_mesh(seeds, "cuda", cards)
    index = np.vectorize(lambda d: d.index)(mesh.devices)
    try:
        want = jax_make_mesh(seed=seeds, data=max(n_dev // seeds, 1), devices=jax.devices()[:n_dev])
    except ValueError:
        assert seeds > n_dev
        assert dict(mesh.shape) == {"seed": n_dev, "data": 1}
        assert [mesh.device_list()[s % mesh.size].index for s in range(seeds)] == [s % n_dev for s in range(seeds)]
    else:
        assert dict(mesh.shape) == dict(want.shape)
        np.testing.assert_array_equal(index, np.vectorize(lambda d: d.id)(want.devices))
    assert dict(sweep_mesh(seeds, "cpu").shape) == {"seed": 1, "data": 1}


# ---- one step on the grid, and pretrain_gsc in it ----


def _jax_sweep_step(variables: list, jcfg, audio, labels, bank, keys):
    """JAX's seed sweep with plain SGD on a (seed 2, data 2) mesh of 4 CPU
    devices: (per-seed losses, per-seed port state dicts)."""
    import optax

    from howl_tpu.models import create_model
    from howl_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from howl_tpu.parallel.seed_sweep import make_seed_sweep_step, shard_seed_batch
    from howl_tpu.training import step as jstep
    from howl_tpu.training.state import TrainState
    from jax.sharding import NamedSharding, PartitionSpec as P

    model = create_model("res8", num_labels=4)
    tx = optax.sgd(1e-2)
    states = [TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, v["params"]), tx=tx,
                                batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"])) for v in variables]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states)
    mesh = jax_make_mesh(seed=SEEDS, data=2, devices=jax.devices()[:4])
    stacked = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P("seed", *([None] * (x.ndim - 1))))),
                           stacked)
    step = make_seed_sweep_step(jstep.make_classification_train_step(model, jcfg, None if bank is None
                                                                     else jnp.asarray(bank)))
    a, l, n = shard_seed_batch((audio, labels, np.full(labels.shape, N, np.int32)), mesh)
    new, metrics = step(stacked, a, l, n, jnp.stack(keys))
    after = jax.device_get({"params": new.params, "batch_stats": new.batch_stats})
    dicts = [res8_variables_to_state_dict(jax.tree.map(lambda x, s=s: np.asarray(x[s]), after)) for s in range(SEEDS)]
    return [float(x) for x in metrics["loss"]], [{k: v.numpy() for k, v in d.items()} for d in dicts]


@pytest.fixture(scope="module")
def grid_steps(tmp_path_factory):
    """Both cases' inputs, JAX's and the one-process sweep's results, then
    one spawned (seed 2, data 2) grid that takes both steps and runs
    ``pretrain_gsc``, and the one-process ``pretrain_gsc``."""
    from tests.test_torch_train_res8 import jax_res8_variables

    variables = [jax_res8_variables(31), jax_res8_variables(32)]
    keys = [jax.random.PRNGKey(helpers.SWEEP_KEY + s) for s in range(SEEDS)]
    cases, jax_out, one_out = [], [], []
    for augment in (False, True):
        jcfg, tcfg, audio, labels, bank = _jax_inputs(augment, 5)
        rng = np.random.default_rng(6)  # the second seed's batch
        audio = np.stack([audio, (rng.standard_normal((B, N)) * 0.1).astype(np.float32)])
        labels = np.stack([labels, rng.integers(0, 4, B).astype(np.int32)])
        draws = [_jax_draws(k, jcfg, bank.shape) for k in keys] if augment else None
        for d in draws or ():  # each seed's draws mix and replace rows on both of its ranks
            replaced = d.augment.mix.replaced
            assert bool(replaced[: B // 2].any()) and bool(replaced[B // 2 :].any()) and not bool(replaced.all())
        draws = draws and [helpers.host_draws(d) for d in draws]
        cases.append((tcfg, audio, labels, bank, draws))
        jax_out.append(_jax_sweep_step(variables, jcfg, audio, labels, bank, keys))
        one_out.append(helpers.sweep_step(variables, tcfg, audio, labels, bank, draws))
    corpus = make_gsc_corpus(tmp_path_factory.mktemp("gsc"), vocab=VOCAB, n_per_class=10)
    env = {**GSC_ENV, "DATASET_PATH": str(corpus)}
    grid_ws = tmp_path_factory.mktemp("grid") / "ws"
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        T_SETTINGS.reset()
        one_stats = LoopStats()
        one_gsc = tgsc.run(GSC_ARGS + ["--workspace", str(tmp_path_factory.mktemp("one") / "ws")], one_stats)
        grid = helpers.spawn_ranks(helpers.grid_rank, 4, variables, cases, env,
                                   GSC_ARGS + ["--workspace", str(grid_ws)])
    return jax_out, one_out, grid, (one_gsc, one_stats), grid_ws


@pytest.mark.parametrize("augment", [False, True])
def test_grid_step_matches_jaxs_seed_data_mesh_step_and_the_one_process_sweep(grid_steps, augment):
    jax_out, one_out, grid, _, _ = grid_steps
    (jax_losses, jax_after), (one_losses, one_after) = jax_out[augment], one_out[augment]
    for s in range(SEEDS):
        (loss0, after0), (loss1, after1) = (grid[2 * s + d][0][augment] for d in range(2))
        assert loss0 == loss1  # the seed's global mean on both of its ranks
        for k in after0[0]:  # both ranks hold the seed's weights and statistics
            np.testing.assert_array_equal(after0[0][k], after1[0][k], err_msg=k)
        np.testing.assert_allclose(loss0[0], one_losses[s], rtol=1e-5)
        np.testing.assert_allclose(loss0[0], jax_losses[s], rtol=1e-4 if augment else 1e-5)
        _assert_state_close(after0[0], one_after[s])
        _assert_state_close(after0[0], jax_after[s])
    assert one_losses[0] != one_losses[1]  # two seeds, two models, two batches


def test_pretrain_gsc_on_the_grid_equals_one_process(grid_steps):
    _, _, grid, (one, one_stats), grid_ws = grid_steps
    _, out, step_losses, epoch_losses = grid[0]
    assert {k: v for k, v in out.items() if k != "ranks"} == one
    np.testing.assert_allclose(epoch_losses, one_stats.epoch_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(step_losses[0], one_stats.step_losses[0], rtol=1e-5)  # before any update
    assert np.shape(step_losses) == (6, SEEDS)
    assert [r[1] for r in grid.values()] == [out] * 4  # every rank returns every seed's numbers
    assert [c["eval_batches"] for c in out["ranks"]] == [2] * 4  # a dev and a test batch a rank
    for s in range(SEEDS):
        assert (grid_ws / f"seed_{s}" / "model-best.pt").exists()


# ---- the harness through run(..., mesh=) ----


def test_harness_on_a_seed_data_mesh_equals_one_process(tmp_path, monkeypatch):
    corpus = make_wakeword_corpus(tmp_path / "ww", n_positive=8, n_negative=8)
    noise = make_noise_dir(tmp_path / "noise", n=6)
    for k, v in {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "BATCH_SIZE": "8",
                 "LEARNING_RATE": "0.02", "MAX_WINDOW_SIZE_SECONDS": "0.5", "NUM_MELS": "40", "NUM_EPOCHS": "2",
                 "USE_NOISE_DATASET": "true", "NOISE_DATASET_PATH": str(noise)}.items():
        monkeypatch.setenv(k, v)
    T_SETTINGS.reset()
    argv = ["-i", str(corpus), "-n", str(SEEDS), "--sharded-seeds", "--steps-per-epoch", "2", "--device", "cpu",
            "--threshold-hop", "0.25"]
    runs = {}
    for name, mesh in (("one", None), ("grid", make_mesh(seed=SEEDS, data=2, devices=["cpu"] * 4))):
        stats = LoopStats()
        runs[name] = tharness.run(argv + ["--workspace", str(tmp_path / name)], stats, mesh=mesh), stats
    (one, one_stats), (grid, grid_stats) = runs["one"], runs["grid"]
    assert grid["per_seed"] == one["per_seed"] and grid["hours"] == one["hours"]
    assert grid["train"]["step_losses"].shape == one["train"]["step_losses"].shape == (4, SEEDS)
    np.testing.assert_allclose(grid["train"]["epoch_losses"], one["train"]["epoch_losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(grid["train"]["step_losses"][0], one["train"]["step_losses"][0], rtol=1e-5)
    for name in ("report_clean.csv", "report_noisy.csv", "raw_results_clean.json"):
        assert (tmp_path / "grid" / "reports" / name).read_text() == (tmp_path / "one" / "reports" / name).read_text()
    for s in range(SEEDS):
        assert sorted(p.name for p in (tmp_path / "grid" / f"seed_{s}").iterdir()) == \
            sorted(p.name for p in (tmp_path / "one" / f"seed_{s}").iterdir())
    # every rank swept its seed's rows: clean and noisy, 4 sets, one batch each
    assert [c["eval_batches"] for c in grid["train"]["ranks"]] == [8] * 4
    assert grid_stats.eval_batches == 8 and one_stats.eval_batches == 16
