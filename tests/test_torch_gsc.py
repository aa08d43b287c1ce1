"""The port's GSC keyword pretraining
(howl_tpu_torch/training/run/pretrain_gsc.py, data/dataset/gsc_loader.py)
and the commands-recognition protocol (eval_commands_recognition.py) against
howl_tpu's, on ``tests/fixtures.py``'s GSC tone corpus, on the CPU.

* The loader's three splits equal JAX's: paths, transcriptions, labels and
  the shared ``label_map``, with and without ``--silence-proportion``, and
  both drop every clip of a corpus whose path holds "noise".
* A ``--no-augment`` run of each package from the same initial weights
  (JAX's, captured from its ``create_train_state`` and carried into the
  port's workspace by ``compat.variables_to_state_dict``, then
  ``--load-weights``): ``zmuv.json`` within 1e-6 relative, each epoch's
  ``Training/Loss`` within 5e-3 relative (tests/test_torch_train_run.py's
  tolerances: AdamW's first update turns float32-noise gradients into +-lr
  moves), every epoch's ``Dev/Metric/acc`` and the final dev and test
  accuracies equal; ``--eval`` on the port's workspace reads
  ``model-best.pt``.
* ``--sharded-seeds 2`` (float32 and ``--bf16``, augmented): ``seed_0/`` and
  ``seed_1/`` are written, the result has the JAX run's keys, and each
  seed's first sweep step equals that seed's single-model step at key s on
  its own batch, bit for bit.
* ``--num-devices 2`` on a host with one card raises before anything is
  written (two ranks run on the CPU in tests/test_torch_scaleout.py); the
  card is asked for unless ``--device cpu``; ``--help`` runs without jax.
* ``eval_commands_recognition`` with the same ``pretrain_gsc.run`` results
  patched into both packages writes JAX's report CSV and raw JSON byte for
  byte, scopes the same settings around each run, forwards ``--device`` and
  leaves ``SETTINGS`` as it found it; one unpatched port run trains.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import howl_tpu.training.run.eval_commands_recognition as jcmd
import howl_tpu.training.run.pretrain_gsc as jgsc
import howl_tpu_torch.training.run.eval_commands_recognition as tcmd
import howl_tpu_torch.training.run.pretrain_gsc as tgsc
from howl_tpu.data.dataset.gsc_loader import GoogleSpeechCommandsDatasetLoader as JLoader
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import variables_to_state_dict
from howl_tpu_torch.data.dataset.gsc_loader import GoogleSpeechCommandsDatasetLoader as TLoader
from howl_tpu_torch.models import create_model
from howl_tpu_torch.parallel import create_seed_states
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.training.run.train import LoopStats
from howl_tpu_torch.training.step import make_classification_train_step
from howl_tpu_torch.workspace import Workspace
from tests.fixtures import make_gsc_corpus
from tests.test_torch_train_run import LOSS_RTOL, ZMUV_RTOL

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
VOCAB = ("yes", "no", "up", "down")
EPOCHS = 2
# 10 clips a word: 24 train clips (3 steps of 8 an epoch), 8 dev, 8 test; after two epochs at this rate the model
# is right on some clips and wrong on others
ENV = {"VOCAB": json.dumps(list(VOCAB)), "BATCH_SIZE": "8", "LEARNING_RATE": "0.001", "MAX_WINDOW_SIZE_SECONDS": "1.0",
       "NUM_MELS": "40", "NUM_EPOCHS": str(EPOCHS)}
ARGS = ["--model", "res8", "--num-labels", "5", "--no-augment"]


def _set_env(mp, env):
    for k, v in env.items():
        mp.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_settings():
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    yield
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_gsc_corpus(tmp_path_factory.mktemp("gsc") / "gsc", vocab=VOCAB, n_per_class=10)


def _metrics(ws: Path, name: str) -> list:
    lines = [json.loads(line) for line in (ws / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["value"]) for r in lines if r["name"] == name]


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory, corpus):
    """JAX's run, then the port's from JAX's initial weights (``--load-weights``)."""
    root = tmp_path_factory.mktemp("runs")
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        _set_env(mp, {**ENV, "DATASET_PATH": str(corpus)})
        real = jgsc.create_train_state

        def capture(*a, **k):
            state = real(*a, **k)
            captured["init"] = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
            return state

        mp.setattr(jgsc, "create_train_state", capture)
        jax_out = jgsc.run(ARGS + ["--workspace", str(root / "jax"), "--num-devices", "1"])
        Workspace(root / "port").save_model(variables_to_state_dict("res8", captured["init"]), best=True)
        stats = LoopStats()
        port_out = tgsc.run(ARGS + ["--workspace", str(root / "port"), "--load-weights", "--device", "cpu"], stats)
    return dict(root=root, corpus=corpus, jax=jax_out, port=port_out, stats=stats)


# ---- the loader ----


@pytest.mark.parametrize("silence", [0.0, 0.1])
def test_loader_splits_equal_jax(corpus, silence):
    jsplits, tsplits = JLoader(list(VOCAB)).load_splits(corpus), TLoader(list(VOCAB)).load_splits(corpus)
    for jds, tds in zip(jsplits, tsplits):
        if silence:
            for ds in (jds, tds):
                ds.label_map.setdefault("__silence__", len(VOCAB) + 1)
                ds.silence_proportion = silence
        assert tds.label_map == jds.label_map == {"yes": 0, "no": 1, "up": 2, "down": 3, "__default__": 4,
                                                  **({"__silence__": 5} if silence else {})}
        assert len(tds) == len(jds) > 0
        assert [(m.path, m.transcription) for m in tds.metadata_list] == \
            [(m.path, m.transcription) for m in jds.metadata_list]
        assert [tds[i].label for i in range(len(tds))] == [jds[i].label for i in range(len(jds))]
    assert [len(ds) for ds in tsplits] == ([26, 8, 8] if silence else [24, 8, 8])


def test_loader_drops_every_clip_under_a_path_holding_noise(tmp_path):
    corpus = make_gsc_corpus(tmp_path / "noise_words", vocab=VOCAB, n_per_class=5)
    for loader in (JLoader(list(VOCAB)), TLoader(list(VOCAB))):
        assert [len(ds) for ds in loader.load_splits(corpus.absolute())] == [0, 0, 0]
    assert [len(ds) for ds in TLoader(list(VOCAB), use_bg_noise=True).load_splits(corpus.absolute())] == [12, 4, 4]


# ---- training parity ----


def test_zmuv_equals_jax(parity_runs):
    jz, tz = (json.loads((parity_runs["root"] / p / "zmuv.json").read_text()) for p in ("jax", "port"))
    np.testing.assert_allclose([tz["mean"], tz["mean2"]], [jz["mean"], jz["mean2"]], rtol=ZMUV_RTOL)
    assert tz["total"] == jz["total"]


def test_no_augment_runs_agree_from_the_same_initial_weights(parity_runs):
    root = parity_runs["root"]
    jloss, tloss = _metrics(root / "jax", "Training/Loss"), _metrics(root / "port", "Training/Loss")
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == list(range(EPOCHS))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss], rtol=LOSS_RTOL)
    for name in ("Dev/Metric/acc", "Test/Metric/acc"):
        assert _metrics(root / "port", name) == _metrics(root / "jax", name)
    assert parity_runs["port"] == parity_runs["jax"]
    assert parity_runs["stats"].steps == 3 * EPOCHS and len(parity_runs["stats"].step_losses) == 3 * EPOCHS
    for name in ("model-best.pt", "model.pt", "train_state.pt", "settings.json", "cmd-args.json"):
        assert (root / "port" / name).exists()


def test_eval_reads_the_ports_best_checkpoint(parity_runs, monkeypatch):
    _set_env(monkeypatch, {**ENV, "DATASET_PATH": str(parity_runs["corpus"])})
    ws = parity_runs["root"] / "port"
    dev_accs = [v for _, v in _metrics(ws, "Dev/Metric/acc")]
    out = tgsc.run(ARGS + ["--workspace", str(ws), "--eval", "--device", "cpu"])
    assert out["dev_acc"] == max(dev_accs)  # model-best.pt: the first epoch of the best dev accuracy
    assert 0.0 <= out["test_acc"] <= 1.0
    assert [v for _, v in _metrics(ws, "Dev/Metric/acc")] == dev_accs  # --eval keeps the run's metrics


# ---- the seed sweep ----


@pytest.fixture(scope="module")
def jax_sweep_keys(tmp_path_factory, corpus):
    with pytest.MonkeyPatch.context() as mp:
        _set_env(mp, {**ENV, "DATASET_PATH": str(corpus), "NUM_EPOCHS": "1"})
        out = jgsc.run(ARGS + ["--workspace", str(tmp_path_factory.mktemp("jax_sweep")), "--sharded-seeds", "2"])
    return sorted(out)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sharded_seeds_write_each_seed_and_step_as_single_models(corpus, tmp_path, monkeypatch, jax_sweep_keys, bf16):
    _set_env(monkeypatch, {**ENV, "DATASET_PATH": str(corpus), "NUM_EPOCHS": "1"})
    extra = ["--silence-proportion", "0.1", "--num-labels", "6"] + (["--bf16"] if bf16 else [])
    stats = LoopStats()
    out = tgsc.run(["--model", "res8", "--workspace", str(tmp_path / "ws"), "--sharded-seeds", "2", "--device", "cpu",
                    *extra], stats)  # augmentation and VTLP on: each seed draws from its own generator
    assert sorted(out) == jax_sweep_keys == ["dev_acc", "per_seed_dev_acc", "per_seed_test_acc", "test_acc"]
    assert len(out["per_seed_dev_acc"]) == len(out["per_seed_test_acc"]) == 2
    assert out["dev_acc"] == pytest.approx(np.mean(out["per_seed_dev_acc"]))
    for s in (0, 1):
        assert (tmp_path / "ws" / f"seed_{s}" / "model-best.pt").exists()
    assert stats.steps == 3 and np.shape(stats.step_losses) == (3, 2)
    weights = [torch.load(tmp_path / "ws" / f"seed_{s}" / "model.pt", weights_only=True) for s in (0, 1)]
    assert not all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0])

    # each seed's first sweep step against its own single-model step at key s on its own batch
    train_ds, _, _ = tgsc.load_splits(0.1)
    audio, labels, lengths = next(tgsc.seed_batches(train_ds, 2, 0, torch.device("cpu")))
    zmuv = Workspace(tmp_path / "ws", delete_existing=False).load_zmuv()
    model = create_model("res8", num_labels=6, dtype=torch.bfloat16 if bf16 else None)
    step = make_classification_train_step(model, tgsc.step_config("res8", zmuv, use_augment=True))
    for s in (0, 1):
        state = create_seed_states(model, [s], device="cpu", **tgsc.optimizer_settings(3))[0]
        _, m = step(state, audio[s], labels[s], lengths[s], s)
        assert float(m["loss"]) == stats.step_losses[0][s]


# ---- refusals, the device, --help ----


def test_more_than_one_device_is_refused_citing_item_12(tmp_path, monkeypatch):
    _set_env(monkeypatch, {**ENV, "DATASET_PATH": str(tmp_path)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--num-devices 2 needs 2 cards, one a rank; 1 visible"):
        tgsc.run(ARGS + ["--workspace", str(tmp_path / "ws"), "--num-devices", "2"])
    assert not (tmp_path / "ws").exists()  # refused before anything was read or written


@pytest.mark.parametrize("entry", ["pretrain_gsc", "eval_commands_recognition"])
def test_entry_points_ask_for_the_card_unless_given_the_cpu(entry, corpus, tmp_path, monkeypatch):
    _set_env(monkeypatch, {**ENV, "DATASET_PATH": str(corpus), "NUM_EPOCHS": "0"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"pretrain_gsc": tgsc, "eval_commands_recognition": tcmd}[entry]
    args = {"pretrain_gsc": ARGS, "eval_commands_recognition": ["--models", "res8", "-i", str(corpus), "--epochs", "0",
                                                                "--vocab", json.dumps(list(VOCAB))]}[entry]
    args = args + ["--workspace", str(tmp_path / "ws")]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(args + device)
    assert not (tmp_path / "ws").exists()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mod.run(args + ["--device", "tpu"])
    mod.run(args + ["--device", "cpu"])  # no epochs: the ZMUV fit and the final evaluation run on the CPU
    assert (tmp_path / "ws").exists()


@pytest.mark.parametrize("entry,flags", [
    ("pretrain_gsc", ("--device", "--sharded-seeds", "--silence-proportion", "--bf16", "--no-augment")),
    ("eval_commands_recognition", ("--device", "--models", "--num-models", "--epochs")),
])
def test_help_runs_without_jax(entry, flags):
    code = (
        "import runpy, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'howl_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"sys.argv = ['{entry}', '--help']\n"
        f"runpy.run_module('howl_tpu_torch.training.run.{entry}', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in flags:
        assert flag in proc.stdout


# ---- the commands-recognition protocol ----


def _fake_gsc_run(calls: list, settings, accuracies: dict):
    """A stand-in for ``pretrain_gsc.run`` that records the scoped settings
    and returns the test accuracy of the (model, seed) it was asked for."""

    def fake(argv, *rest):
        model = argv[argv.index("--model") + 1]
        t = settings.training
        calls.append({"argv": argv, "model": model, "seed": t.seed, "lr": t.learning_rate, "epochs": t.num_epochs,
                      "batch": t.batch_size, "vocab": list(t.vocab), "window": t.max_window_size_seconds,
                      "eval_window": t.eval_window_size_seconds, "wd": t.weight_decay, "decay": t.lr_decay,
                      "noise": t.use_noise_dataset, "mels": settings.audio_transform.num_mels,
                      "dataset": settings.dataset.dataset_path})
        return {"dev_acc": 0.5, "test_acc": accuracies[(model, t.seed)]}

    return fake


def test_commands_recognition_report_is_jaxs_bytes(tmp_path, monkeypatch):
    accuracies = {("res8", 0): 0.8125, ("res8", 1): 0.90625, ("res8", 2): 0.71875,
                  ("lstm", 0): 0.5, ("lstm", 1): 0.6015625, ("lstm", 2): 0.125}
    argv = ["--models", "res8", "lstm", "-n", "3", "--epochs", "1", "-i", str(tmp_path / "gsc")]
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jgsc, "run", _fake_gsc_run(calls["jax"], J_SETTINGS, accuracies))
    monkeypatch.setattr(tgsc, "run", _fake_gsc_run(calls["port"], T_SETTINGS, accuracies))
    before = T_SETTINGS.to_dict()
    jres = jcmd.run(argv + ["--workspace", str(tmp_path / "jax")])
    tres = tcmd.run(argv + ["--workspace", str(tmp_path / "port"), "--device", "cpu"])
    assert T_SETTINGS.to_dict() == before
    assert tres == jres
    for name in ("commands_recognition_report.csv", "commands_recognition_raw.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert len(calls["port"]) == 6
    for jcall, tcall in zip(calls["jax"], calls["port"]):
        assert tcall["argv"][-2:] == ["--device", "cpu"]
        assert tcall["argv"][:-2] == [a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in jcall["argv"]]
        assert {k: v for k, v in tcall.items() if k != "argv"} == {k: v for k, v in jcall.items() if k != "argv"}
    assert calls["port"][0]["lr"] == 0.01 and calls["port"][3]["lr"] == 0.001 and calls["port"][0]["epochs"] == 1


def test_commands_recognition_trains_through_the_port(corpus, tmp_path):
    out = tcmd.run(["--models", "res8", "-n", "1", "--epochs", "1", "--batch-size", "8", "--num-labels", "5",
                    "--vocab", json.dumps(list(VOCAB)), "-i", str(corpus), "--workspace", str(tmp_path / "exp"),
                    "--device", "cpu"])
    assert len(out["res8"]["accuracies"]) == 1 and 0.0 <= out["res8"]["mean"] <= 1.0
    assert (tmp_path / "exp" / "res8" / "seed_0" / "model-best.pt").exists()
    rows = (tmp_path / "exp" / "commands_recognition_report.csv").read_text().splitlines()
    assert rows[0] == "model,mean,std,p90,p95,p99" and rows[1].startswith("res8,")
    assert T_SETTINGS.training.num_epochs != 1 or T_SETTINGS.training.batch_size != 8
