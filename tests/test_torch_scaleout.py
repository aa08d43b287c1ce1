"""Scale-out of the port (item 12): ``parallel/mesh.py``,
``parallel/data_parallel.py``, ``shard_streams`` on the three live engines
and the seed sweep across devices, on the CPU, against howl_tpu and
against the port's one-process paths.

* One data-parallel step with 2 gloo ranks equals JAX's step on a 2-device
  data mesh (the conftest's virtual devices) and the port's one-process
  step, with and without augmentation (K3's plain version then mixes each
  rank's slice of the global draws, replayed from JAX's keys): the loss
  within rtol 1e-5 (1e-4 against JAX with augmentation, the tolerance of
  ``tests/test_torch_train_step.py``'s augmented step), the parameters
  within rtol 1e-3 / atol 1e-5 and the BatchNorm running stats within rtol
  2e-4 / atol 1e-6 (``tests/test_train_dp.py``'s tolerances). Both take
  plain SGD, so the parameters compare the gradients.
* ``train --num-devices 2 --device cpu`` for 2 epochs equals
  ``--num-devices 1``: each epoch's loss within ``LOSS_RTOL`` (AdamW's
  first update turns float32 noise into +-lr moves), the final confusion
  matrices equal, and the two workspaces hold the same files, written once
  (rank 0 only); ``pretrain_gsc --num-devices 2`` the same way, with equal
  dev and test accuracies.
* The evaluator split over 2 ranks (ragged batches padded) gives the
  one-process evaluator's confusion matrix, errors and sweep.
* The three live engines sharded 2 and 4 ways on ``["cpu"] * k`` decide as
  the unsharded engine on every hop, with ``last_probs`` and the rings
  within atol 1e-5 (``tests/test_multichip_online.py``); ``num_streams % k``
  raises; assigning ``variables`` after sharding reaches every shard.
* The seed sweep across 2 devices is the one-device sweep bit for bit.
* ``make_mesh`` raises when the devices are too few; ``--num-devices 2``
  with one card raises before anything is written; the default rank count
  is the largest divisor of the batch size no larger than the cards.

Every multi-process test joins on a free port with a rendezvous timeout and
joins its workers within a limit (``tests/torch_scaleout.py``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import howl_tpu_torch.training.run.pretrain_gsc as tgsc
import howl_tpu_torch.training.run.train as ttrain
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.parallel import data_parallel
from howl_tpu_torch.parallel.mesh import make_mesh
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from tests import torch_scaleout as helpers
from tests.fixtures import make_gsc_corpus, make_noise_dir, make_wakeword_corpus
from tests.test_torch_train_run import ENV as TRAIN_ENV
from tests.test_torch_train_run import LOSS_RTOL

torch.set_num_threads(2)
B, N = 8, 8000
ZMUV = (2.05, 1.0)  # the log-mel mean and std of these batches (tests/test_torch_train_step.py)


def _set_env(mp, env):
    for k, v in env.items():
        mp.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_settings(monkeypatch):
    monkeypatch.setattr(data_parallel, "TIMEOUT_S", helpers.TIMEOUT_S)
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


# ---- the mesh ----


def test_make_mesh_lays_out_devices_and_raises_when_too_few(monkeypatch):
    mesh = make_mesh(data=2, seed=2, devices=["cpu"] * 4)
    assert dict(mesh.shape) == {"seed": 2, "data": 2} and mesh.size == 4
    assert [d.type for d in mesh.device_list()] == ["cpu"] * 4
    assert dict(make_mesh(devices=["cpu"] * 3).shape) == {"seed": 1, "data": 3}  # data fills what is left
    with pytest.raises(ValueError, match="mesh 1x4 needs 4 devices but only 3"):
        make_mesh(data=4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh 3x1 needs 3 devices but only 2"):
        make_mesh(data=1, seed=3, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices but only 0 available"):
        make_mesh(data=2)  # the default takes the visible cards, and nothing falls back to the CPU


def test_shard_batch_refuses_a_batch_that_does_not_divide_as_jax_does():
    """F17: a (5, 3) batch over two ranks raises in JAX's ``shard_batch`` (the
    device placement refuses it) and in the port's, before any rank takes
    rows; a (4, 3) batch gives each rank its two rows."""
    from howl_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from howl_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from howl_tpu_torch.parallel.mesh import DataGroup, shard_batch

    odd = np.arange(15, dtype=np.float32).reshape(5, 3)
    with pytest.raises(ValueError):
        jax_shard_batch((odd,), jax_make_mesh(data=2, devices=jax.devices()[:2]))
    for rank in range(2):
        group = DataGroup(rank, 2, torch.device("cpu"))
        with pytest.raises(ValueError, match=r"\(5, 3\).*2 ranks"):
            shard_batch((odd[:4], odd), group)
        (rows,) = shard_batch((odd[:4],), group)
        assert torch.equal(rows, torch.from_numpy(odd[2 * rank : 2 * rank + 2]))


def test_data_size_follows_jax_and_refuses_before_anything_is_written(tmp_path, monkeypatch):
    assert data_parallel.data_size(0, 16, torch.device("cpu")) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert data_parallel.data_size(0, 12, torch.device("cuda")) == 6  # the largest divisor of 12 up to 8 cards
    assert data_parallel.data_size(4, 16, torch.device("cuda")) == 4
    with pytest.raises(SystemExit, match="must divide the batch size"):
        data_parallel.data_size(5, 16, torch.device("cuda"))
    # --num-devices 2 on a one-card host: refused before the workspace exists
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _set_env(monkeypatch, {"BATCH_SIZE": "16"})
    for mod, args in ((ttrain, ["--model", "res8", "-i", str(tmp_path)]), (tgsc, ["--model", "res8"])):
        with pytest.raises(RuntimeError, match="needs 2 cards, one a rank; 1 visible"):
            mod.run(args + ["--workspace", str(tmp_path / "ws"), "--num-devices", "2"])
        assert not (tmp_path / "ws").exists()


# ---- one data-parallel step ----


def _jax_inputs(augment: bool, seed: int):
    from howl_tpu.ops.augment import AugmentConfig as JAugmentConfig
    from howl_tpu.ops.frontend import FrontendConfig as JFrontendConfig
    from howl_tpu.training import step as jstep
    from howl_tpu_torch.ops import augment as taug
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.training.step import StepConfig

    kw = dict(negative_label=3, use_deltas=False, use_vtlp=augment, vtlp_prob=1.0, replace_prob=0.3 if augment else 0)
    jcfg = jstep.StepConfig(JFrontendConfig(n_mels=40), *ZMUV, augment=JAugmentConfig() if augment else None, **kw)
    tcfg = StepConfig(FrontendConfig(n_mels=40), *ZMUV, augment=taug.AugmentConfig() if augment else None, **kw)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, N)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 4, B).astype(np.int32)
    bank = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32) if augment else None
    return jcfg, tcfg, audio, labels, bank


def _jax_draws(key, jcfg, bank_shape):
    """The draws of JAX's classification step at step 0 for the global
    batch of B (tests/test_torch_train_step.py's ``jax_step_draws``)."""
    from howl_tpu_torch.training.step import StepDraws
    from tests.test_torch_augment import jax_augment_draws, jax_spec_draws

    k_wave, k_vtlp, k_spec, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    augment = jax_augment_draws(k_wave, B, N, jcfg.augment, bank_shape, jcfg.replace_prob)
    k_alpha, k_prob = jax.random.split(k_vtlp)
    alpha = jax.random.uniform(k_alpha, (), minval=0.9, maxval=1.1)
    alpha = jnp.where(jax.random.bernoulli(k_prob, jcfg.vtlp_prob), alpha, 1.0)
    spec = jax_spec_draws(k_spec, B, 40, jcfg.frontend.num_frames(N), jcfg.augment)
    return StepDraws(augment, torch.tensor(float(alpha)), spec)


def _jax_mesh_step(variables, jcfg, audio, labels, bank, key):
    """JAX's step with plain SGD on a 2-device data mesh."""
    import optax

    from howl_tpu.models import create_model
    from howl_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from howl_tpu.parallel.mesh import replicate, shard_batch
    from howl_tpu.training import step as jstep
    from howl_tpu.training.state import TrainState

    model = create_model("res8", num_labels=4)
    state = TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
                              tx=optax.sgd(1e-2), batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    mesh = jax_make_mesh(data=2)
    step = jstep.make_classification_train_step(model, jcfg, None if bank is None else jnp.asarray(bank))
    a, l, n = shard_batch((audio, labels, np.full(B, N, np.int32)), mesh)
    new, metrics = step(replicate(state, mesh), a, l, n, key)
    after = jax.device_get({"params": new.params, "batch_stats": new.batch_stats})
    return float(metrics["loss"]), res8_variables_to_state_dict(jax.tree.map(np.asarray, after))


def _assert_state_close(got: dict, want: dict):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):  # not in JAX's variables
            continue
        g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
        if k.startswith("bn"):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_data_parallel_step_matches_jaxs_mesh_step_and_one_process(augment):
    from tests.test_torch_train_res8 import jax_res8_variables

    variables = jax_res8_variables(31)
    jcfg, tcfg, audio, labels, bank = _jax_inputs(augment, 5)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, jcfg, bank.shape) if augment else None
    if augment:  # the draws mix, replace and skip rows on both ranks
        assert bool(draws.augment.mix.replaced[: B // 2].any() | draws.augment.mix.replaced[B // 2 :].any())
    jax_loss, jax_after = _jax_mesh_step(variables, jcfg, audio, labels, bank, key)
    one_loss, one_after = helpers.port_step(variables, tcfg, audio, labels, bank, helpers.host_draws(draws))
    out = helpers.spawn_ranks(helpers.dp_step_rank, 2, variables, tcfg, audio, labels, bank,
                              helpers.host_draws(draws))
    (loss0, after0), (loss1, after1) = out[0], out[1]
    assert loss0 == loss1  # the global mean on every rank
    for k in after0:  # every rank holds the same weights and statistics
        np.testing.assert_array_equal(after0[k], after1[k], err_msg=k)
    np.testing.assert_allclose(loss0, one_loss, rtol=1e-5)
    np.testing.assert_allclose(loss0, jax_loss, rtol=1e-4 if augment else 1e-5)
    _assert_state_close(after0, one_after)
    _assert_state_close(after0, {k: v.numpy() for k, v in jax_after.items()})


# ---- the evaluator ----


def test_evaluator_split_over_ranks_equals_one_process(tmp_path):
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.training.run.train import BatchedEvaluator

    corpus = make_wakeword_corpus(tmp_path / "corpus", n_positive=6, n_negative=7)
    model = create_model("res8", num_labels=4)
    state_dict = model.init_weights(torch.Generator().manual_seed(3)).state_dict()
    thresholds = [0.0, 0.2, 0.25, 0.3, 0.35, 0.5]
    dataset, engine = helpers.evaluator_pieces(corpus, state_dict)
    # max_batch=4 over 13 clips in two length buckets: ragged batches padded onto the ranks
    one = helpers.evaluate(BatchedEvaluator(engine, max_batch=4), dataset, thresholds)
    out = helpers.spawn_ranks(helpers.evaluator_rank, 2, corpus, state_dict, thresholds)
    assert out[0][:4] == out[1][:4] == one[:4]
    assert out[0][4] == one[4] >= 2  # as many engine calls a rank, over more than one batch


# ---- the entry points ----


def _names(ws: Path) -> list:
    """The workspace's files, TensorBoard event files by their directory
    (their names carry the time and the process id)."""
    return [name.split("/events.")[0] + "/events" if "/events." in name else name for name in helpers.ws_files(ws)]


def _files_once(ws: Path) -> dict:
    return {name: (ws / name).read_bytes().count(b"\n") for name in ("metrics.jsonl", "errors.tsv")}


def test_train_num_devices_2_equals_1_and_rank_0_writes(tmp_path, monkeypatch):
    corpus = make_wakeword_corpus(tmp_path / "ww", n_positive=12, n_negative=12)
    noise = make_noise_dir(tmp_path / "noise")
    _set_env(monkeypatch, {**TRAIN_ENV, "NOISE_DATASET_PATH": str(noise), "NUM_EPOCHS": "2",
                           "INFERENCE_THRESHOLD": "0.5"})
    args = ["--model", "res8", "-i", str(corpus), "--eval-freq", "1", "--steps-per-epoch", "2", "--device", "cpu"]
    runs = {}
    for n in (1, 2):
        stats = ttrain.LoopStats()
        results = ttrain.run(args + ["--workspace", str(tmp_path / f"ws{n}"), "--num-devices", str(n)], stats)
        runs[n] = (stats, results)
    (stats1, res1), (stats2, res2) = runs[1], runs[2]
    assert stats2.steps == stats1.steps == 4 and stats2.examples == stats1.examples
    np.testing.assert_allclose(stats2.epoch_losses, stats1.epoch_losses, rtol=LOSS_RTOL)
    assert res2 == res1 and "test_noisy_pos" in res2
    assert _names(tmp_path / "ws2") == _names(tmp_path / "ws1")
    assert _files_once(tmp_path / "ws2") == _files_once(tmp_path / "ws1")  # each line written once
    assert (tmp_path / "ws2" / "errors.tsv").read_text() == (tmp_path / "ws1" / "errors.tsv").read_text()
    # --resume restores every rank: one more epoch on two ranks from the saved train state
    _set_env(monkeypatch, {"NUM_EPOCHS": "1"})
    ttrain.run(args + ["--workspace", str(tmp_path / "ws2"), "--num-devices", "2", "--resume"])
    state = torch.load(tmp_path / "ws2" / "train_state.pt", weights_only=True)
    assert state["step"] == 6


def test_pretrain_gsc_num_devices_2_equals_1(tmp_path, monkeypatch):
    vocab = ("yes", "no", "up", "down")
    corpus = make_gsc_corpus(tmp_path / "gsc", vocab=vocab, n_per_class=10)
    _set_env(monkeypatch, {"VOCAB": json.dumps(list(vocab)), "BATCH_SIZE": "8", "LEARNING_RATE": "0.001",
                           "MAX_WINDOW_SIZE_SECONDS": "1.0", "NUM_MELS": "40", "NUM_EPOCHS": "2",
                           "DATASET_PATH": str(corpus)})
    args = ["--model", "res8", "--num-labels", "5", "--device", "cpu"]
    runs = {}
    for n in (1, 2):
        stats = ttrain.LoopStats()
        runs[n] = (stats, tgsc.run(args + ["--workspace", str(tmp_path / f"ws{n}"), "--num-devices", str(n)], stats))
    (stats1, res1), (stats2, res2) = runs[1], runs[2]
    np.testing.assert_allclose(stats2.epoch_losses, stats1.epoch_losses, rtol=LOSS_RTOL)
    assert res2 == res1
    assert _names(tmp_path / "ws2") == _names(tmp_path / "ws1")
    lines = lambda n: (tmp_path / f"ws{n}" / "metrics.jsonl").read_text().count("\n")  # noqa: E731
    assert lines(2) == lines(1)


# ---- the live engines sharded ----


def _engines(cls, k: int, num_streams: int = 8, **kw):
    from howl_tpu_torch.inference import EngineConfig
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    model = create_model("res8", num_labels=3)
    state_dict = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    cfg = EngineConfig(inference_sequence=(0, 1), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
                       negative_label=2, num_labels=3)
    make = lambda: cls(model, state_dict, cfg, FrontendConfig(n_mels=40), num_streams=num_streams,  # noqa: E731
                       device="cpu", **kw)
    return make(), make().shard_streams(make_mesh(data=k, devices=["cpu"] * k))


def _drive(cls, base, sharded, audio, hops):
    hop = base.hop_samples * getattr(base, "hop_block", 1)
    for j in range(hops):
        if cls.__name__ == "OnlineEngine":
            chunk = audio[:, max(0, (j + 1) * hop - base.window_samples) : (j + 1) * hop]
            fired = base.ingest(chunk), sharded.ingest(chunk)
        else:
            chunk = audio[:, j * hop : (j + 1) * hop]
            fired = base.push(chunk), sharded.push(chunk)
        assert fired[0] == fired[1], f"hop {j}"
        np.testing.assert_array_equal(base.last_fired, sharded.last_fired)
        np.testing.assert_array_equal(base.last_labels, sharded.last_labels)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["online", "incremental", "trunk", "trunk-blocked"])
def test_sharded_engines_decide_as_the_unsharded_engine(kind, k, rng):
    from howl_tpu_torch.inference import FusedStreamingOnlineEngine
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine

    cls = {"online": OnlineEngine, "incremental": IncrementalOnlineEngine}.get(kind, FusedStreamingOnlineEngine)
    kw = {"hop_block": 3} if kind == "trunk-blocked" else {}
    base, sharded = _engines(cls, k, **kw)
    assert len(sharded.shards) == k and [s.num_streams for s in sharded.shards] == [8 // k] * k
    hop = base.hop_samples * getattr(base, "hop_block", 1)
    audio = (rng.standard_normal((8, hop * 10)) * 0.1).astype(np.float32)
    _drive(cls, base, sharded, audio, 10)
    assert sharded.curr_time == base.curr_time
    for a, b in zip(base.state, sharded.state):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-5)
    if cls is IncrementalOnlineEngine:
        np.testing.assert_allclose(base.mel_ring.numpy(), sharded.mel_ring.numpy(), atol=1e-5)
    if cls is FusedStreamingOnlineEngine:
        np.testing.assert_allclose(base.last_probs.numpy(), sharded.last_probs.numpy(), atol=1e-5)
        np.testing.assert_allclose(base.mel_cache.numpy(), sharded.mel_cache.numpy(), atol=1e-5)
    # reset reaches every shard, and both engines start over alike
    base.reset()
    sharded.reset()
    assert sharded.curr_time == 0.0 and sharded.last_fired is None
    _drive(cls, base, sharded, audio, 3)


def test_sharding_refuses_uneven_streams_and_new_variables_reach_every_shard(rng):
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine

    for cls in (OnlineEngine, IncrementalOnlineEngine):
        base, sharded = _engines(cls, 2, num_streams=6)
        with pytest.raises(ValueError, match="num_streams=6 must be divisible by the mesh's 4 devices"):
            _engines(cls, 4, num_streams=6)
        with pytest.raises(ValueError, match="already sharded"):
            sharded.shard_streams(make_mesh(data=2, devices=["cpu"] * 2))
        new = {k: v * 1.5 if k.startswith("conv") else v for k, v in base.variables.items()}
        base.variables = new
        sharded.variables = new
        for shard in sharded.shards:
            assert torch.equal(shard.model.conv0.weight, base.model.conv0.weight)
            assert torch.equal(shard._stem_taps, base._stem_taps)  # the stem kernel's taps re-derived
        hop = base.hop_samples
        audio = (rng.standard_normal((6, hop * 6)) * 0.3).astype(np.float32)
        _drive(cls, base, sharded, audio, 6)
        np.testing.assert_allclose(base.state.pred_ring.numpy(), sharded.state.pred_ring.numpy(), atol=1e-5)


# ---- the seed sweep across devices ----


def test_seed_sweep_across_two_devices_is_the_one_device_sweep_bit_for_bit(rng):
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops import augment as taug
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.parallel import create_seed_states, make_seed_sweep_step, shard_seed_batch
    from howl_tpu_torch.training.step import StepConfig, make_classification_train_step

    cfg = StepConfig(FrontendConfig(n_mels=40), *ZMUV, augment=taug.AugmentConfig(), negative_label=3,
                     use_deltas=False, replace_prob=0.3)
    model = create_model("res8", num_labels=4)
    bank = torch.from_numpy((rng.standard_normal((3, 9000)) * 0.05).astype(np.float32))
    arrays = ((rng.standard_normal((3, 4, N)) * 0.1).astype(np.float32),
              rng.integers(0, 4, (3, 4)).astype(np.int64), np.full((3, 4), N, np.int64))
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    out = {}
    for name, m in (("one", None), ("two", mesh)):
        states = create_seed_states(model, [0, 1, 2], device="cpu", mesh=m, learning_rate=0.01)
        step = make_seed_sweep_step(make_classification_train_step(model, cfg, bank))
        losses = []
        for _ in range(2):
            batch = shard_seed_batch(arrays, "cpu", m)
            assert isinstance(batch[0], list) == (m is not None)  # one tensor a seed across devices
            states, metrics = step(states, *batch, [0, 1, 2])
            losses.append(metrics["loss"])
        out[name] = (torch.stack(losses), [s.model.state_dict() for s in states])
    assert torch.equal(out["one"][0], out["two"][0])
    for a, b in zip(out["one"][1], out["two"][1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
