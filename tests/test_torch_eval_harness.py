"""The port's wake-word experiment harness
(howl_tpu_torch/training/run/eval_wake_word_detection.py) and its ROC tools
against howl_tpu's, on the CPU.

* ``write_reports`` writes the JAX harness's bytes (report CSVs and raw
  JSON, clean and noisy) from the same per-seed results and hours.
* ``sweep_workspace`` on one res8 (seeded weights, written as a port
  workspace and, carried across by ``compat``, as a JAX one) gives JAX's
  tp/tn/fp/fn at every threshold, clean and noisy (JAX's eval-mix draws
  replayed), the same audio hours and the same ``{t}_results.csv`` files.
  The weights put the word's clean posterior peaks at 0.473-0.480 on half
  the clips and 0.599-0.604 on the other half, so the counts change along
  the sweep; the thresholds step by 0.07, none within 0.01 of those peaks.
  Counts are integers and must be equal.
* ``run -n 2 --sharded-seeds --device cpu`` trains both seeds in one sweep
  and writes consistent reports (a row for every set, threshold and metric;
  tp + fn the positive set's size at every threshold); the seeds' weights
  differ; ``run_exp`` trains a seed through the entry point; without a card
  and without ``--device cpu`` the harness raises before reading anything.
* ``load_metrics``, ``load_precise_metrics`` and ``generate_roc``'s JSON
  sidecar equal JAX's on the same reports.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import howl_tpu.training.run.eval_wake_word_detection as jharness
import howl_tpu.training.run.generate_precise_roc as jprecise
import howl_tpu.training.run.generate_roc as jroc
import howl_tpu_torch.training.run.eval_wake_word_detection as tharness
import howl_tpu_torch.training.run.generate_precise_roc as tprecise
import howl_tpu_torch.training.run.generate_roc as troc
import howl_tpu_torch.training.run.train as ttrain
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import numpy_variables
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from tests.fixtures import make_noise_dir, make_wakeword_corpus
from tests.test_torch_train_run import jax_eval_mix_draws
from tests.torch_serving import settings_dict, write_jax_workspace, write_port_workspace

torch.set_num_threads(2)
THRESHOLDS = [round(t, 2) for t in np.arange(0.0, 1.000001, 0.07)]
SETS = ["Dev positive", "Dev negative", "Test positive", "Test negative"]


@pytest.fixture(autouse=True)
def _reset_settings():
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    yield
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    return make_wakeword_corpus(root / "ww", n_positive=8, n_negative=8), make_noise_dir(root / "noise", n=6)


def _per_seed(rng, noisy: bool):
    names = SETS + ([f"{s.split()[0]} noisy {s.split()[1]}" for s in SETS] if noisy else [])
    return [{name: {float(t): tuple(int(x) for x in rng.integers(0, 5, 4)) for t in THRESHOLDS} for name in names}
            for _ in range(3)]


@pytest.mark.parametrize("noisy", [False, True])
def test_write_reports_writes_the_jax_bytes(tmp_path, noisy):
    rng = np.random.default_rng(int(noisy))
    per_seed = _per_seed(rng, noisy)
    hours = {name: float(rng.uniform(0.001, 0.01)) for name in per_seed[0]}
    for suffix in ["clean"] + (["noisy"] if noisy else []):
        tharness.write_reports(tmp_path / "port", per_seed, hours, THRESHOLDS, suffix)
        jharness.write_reports(tmp_path / "jax", per_seed, hours, THRESHOLDS, suffix)
        for name in (f"report_{suffix}.csv", f"raw_results_{suffix}.json"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    rows = (tmp_path / "port" / "report_clean.csv").read_text().splitlines()
    assert len(rows) == 1 + len(SETS) * len(THRESHOLDS) * 6


def _with_noise(noise) -> dict:
    settings = settings_dict(word=1, threshold=0.0)
    settings["training"].update(use_noise_dataset=True, noise_dataset_path=str(noise))
    return settings


def test_sweep_workspace_counts_equal_jax_on_carried_weights(corpora, tmp_path, monkeypatch):
    corpus, noise = corpora
    variables = numpy_variables("res8", 4, np.random.default_rng(0), kernel_gain=1.0)
    port_ws = write_port_workspace(tmp_path / "port", "res8", variables, _with_noise(noise))
    jax_ws = write_jax_workspace(tmp_path / "jax", "res8", variables, _with_noise(noise))
    monkeypatch.setattr(ttrain, "draw_eval_mix", jax_eval_mix_draws)
    stats = ttrain.LoopStats()
    got, got_hours = tharness.sweep_workspace(port_ws, "res8", [str(corpus)], THRESHOLDS, False, device="cpu",
                                              stats=stats)
    want, want_hours = jharness.sweep_workspace(jax_ws, "res8", [str(corpus)], THRESHOLDS, False)
    assert list(got) == list(want) == SETS[:1] + ["Dev noisy positive"] + SETS[1:2] + ["Dev noisy negative"] + \
        SETS[2:3] + ["Test noisy positive"] + SETS[3:] + ["Test noisy negative"]
    assert got == {name: {float(t): c for t, c in res.items()} for name, res in want.items()}
    assert got_hours == pytest.approx(want_hours, rel=1e-12)
    for t in THRESHOLDS:
        name = f"{round(float(t), 2)}_results.csv"
        assert (port_ws / name).read_text() == (jax_ws / name).read_text()
    fired = [sum(c[0] + c[2] for name, res in got.items() if "noisy" not in name for c in [res[t]]) for t in THRESHOLDS]
    assert len(set(fired)) >= 3, fired  # the sweep moves: all fire, half fire, none fire
    assert stats.eval_batches == 8 and stats.eval_s > 0  # one batch a set, clean and noisy


def _harness_env(monkeypatch, noise, epochs=2):
    for k, v in {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "BATCH_SIZE": "8",
                 "LEARNING_RATE": "0.02", "MAX_WINDOW_SIZE_SECONDS": "0.5", "NUM_MELS": "40",
                 "NUM_EPOCHS": str(epochs), "USE_NOISE_DATASET": "true", "NOISE_DATASET_PATH": str(noise)}.items():
        monkeypatch.setenv(k, v)
    T_SETTINGS.reset()


@pytest.fixture(scope="module")
def sharded_run(corpora, tmp_path_factory):
    corpus, noise = corpora
    base = tmp_path_factory.mktemp("sharded") / "exp"
    with pytest.MonkeyPatch.context() as mp:
        _harness_env(mp, noise)
        stats = ttrain.LoopStats()
        out = tharness.run(["--workspace", str(base), "-i", str(corpus), "-n", "2", "--sharded-seeds",
                            "--steps-per-epoch", "2", "--device", "cpu", "--threshold-hop", "0.25"], stats)
    T_SETTINGS.reset()
    return base, out, stats


def test_sharded_seeds_run_end_to_end(sharded_run):
    base, out, stats = sharded_run
    train = out["train"]
    assert train["steps"] == 4 and train["step_losses"].shape == (4, 2) and np.isfinite(train["step_losses"]).all()
    thresholds = out["thresholds"]
    assert thresholds == [0.0, 0.25, 0.5, 0.75, 1.0]
    sd = [torch.load(base / f"seed_{s}" / "model-best.pt", weights_only=True) for s in (0, 1)]
    assert not torch.equal(sd[0]["conv0.weight"], sd[1]["conv0.weight"])
    assert stats.eval_batches == 2 * 8  # two seeds, four sets clean and noisy, one batch each
    for s in (0, 1):
        for t in thresholds:
            rows = (base / f"seed_{s}" / f"{t}_results.csv").read_text().splitlines()
            assert len(rows) == 8
    reports = base / "reports"
    for suffix, names in (("clean", SETS), ("noisy", [f"{n.split()[0]} noisy {n.split()[1]}" for n in SETS])):
        rows = (reports / f"report_{suffix}.csv").read_text().splitlines()
        assert rows[0] == "set,threshold,metric,mean,std,p90,p95,p99"
        table = {(r.split(",")[0], float(r.split(",")[1]), r.split(",")[2]): float(r.split(",")[3]) for r in rows[1:]}
        assert set(table) == {(n, float(t), m) for n in names for t in thresholds
                              for m in ("tp", "tn", "fp", "fn", "tp_rate", "fah")}
        for n in (n for n in names if "positive" in n):  # the corpus's 2 positives in each of dev and test
            assert all(res[n][float(t)][0] + res[n][float(t)][3] == 2 for res in out["per_seed"] for t in thresholds)
            assert all(table[(n, float(t), "tp")] + table[(n, float(t), "fn")] == 2 for t in thresholds)
    assert set(json.loads((reports / "hours.json").read_text())) == set(out["hours"])
    points = troc.load_metrics(reports / "report_clean.csv", "Test")
    assert [p[0] for p in points] == thresholds and all(0.0 <= p[2] <= 1.0 for p in points)


def test_run_exp_trains_a_seed_through_the_entry_point(corpora, tmp_path, monkeypatch):
    from howl_tpu_torch.training.run import run_exp

    corpus, noise = corpora
    _harness_env(monkeypatch, noise, epochs=1)
    base = tmp_path / "exp"
    out = run_exp.run(["--workspace", str(base), "-i", str(corpus), "-n", "1", "--steps-per-epoch", "2",
                       "--device", "cpu", "--threshold-hop", "0.5", "--no-augment"])
    assert out["train"] is None and len(out["per_seed"]) == 1
    assert (base / "seed_0" / "model-best.pt").exists() and (base / "seed_0" / "train_state.pt").exists()
    assert json.loads((base / "seed_0" / "cmd-args.json").read_text())["device"] == "cpu"
    # a second run keeps the trained seed and only sweeps it
    first = (base / "seed_0" / "model-best.pt").read_bytes()
    again = run_exp.run(["--workspace", str(base), "-i", str(corpus), "-n", "1", "--device", "cpu",
                         "--threshold-hop", "0.5", "--sharded-seeds"])
    assert again["train"] is None and again["per_seed"] == out["per_seed"]
    assert (base / "seed_0" / "model-best.pt").read_bytes() == first


def test_harness_asks_for_the_card_unless_given_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tharness.run(["--workspace", str(tmp_path / "exp"), "-i", str(tmp_path), "--sharded-seeds"])
    assert not (tmp_path / "exp").exists()


def test_roc_tools_equal_jax(sharded_run, tmp_path):
    base, _, _ = sharded_run
    reports = base / "reports"
    for name in ("report_clean.csv", "report_noisy.csv"):
        for split in ("Dev", "Test"):
            assert troc.load_metrics(reports / name, split) == jroc.load_metrics(reports / name, split)
    records = [{"threshold": t, "tp": 10 - i, "fn": i, "fp": 3 * i} for i, t in enumerate([0.9, 0.2, 0.5])]
    (tmp_path / "precise.json").write_text(json.dumps(records))
    for hours in (1.0, 2.9):
        assert tprecise.load_precise_metrics(tmp_path / "precise.json", hours) == \
            jprecise.load_precise_metrics(tmp_path / "precise.json", hours)
    assert tprecise.KNOWN_NEGATIVE_SECONDS == jprecise.KNOWN_NEGATIVE_SECONDS
    other = tmp_path / "other" / "reports"
    shutil.copytree(reports, other)
    args = ["-i", str(reports), str(other), "--names", "a", "b", "--split", "Dev"]
    curves = troc.run(args + ["-o", str(tmp_path / "port.pdf")])
    jroc.run(args + ["-o", str(tmp_path / "jax.pdf")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert set(curves) == {"a", "b"} and (tmp_path / "port.pdf").stat().st_size > 0
    tprecise.run(["-i", str(reports), "--precise-results", str(tmp_path / "precise.json"), "--exp-type", "hey_ff",
                  "-o", str(tmp_path / "precise.pdf")])
    assert (tmp_path / "precise.pdf").stat().st_size > 0
