"""The port's training entry point (howl_tpu_torch/training/run/train.py)
against howl_tpu's on the synthetic-tone corpus of ``tests/fixtures.py``.

* ``mix_for_eval``: JAX's draws (fold_in, split in 3, bernoulli, randint,
  uniform) replayed into the port's ``apply_eval_mix``, within 1e-6.
* ``BatchedEvaluator`` on res8 weights JAX trained, carried across by
  ``compat`` (float32): detections, confusion matrices and ``errors.tsv``
  rows equal to the JAX evaluator's, with and without a mix bank.
* A ``--no-augment`` run of each package from the same initial weights (JAX's,
  injected into the port's ``create_train_state``) on the same corpus and
  noise corpus, eval draws replayed: the per-epoch ``Training/Loss`` within
  1e-4 relative, the learning rates within 1e-6 relative (JAX's are float32), ``zmuv.json``
  within 1e-6 relative (float32 features summed in float64; the two
  frontends round differently), and final results with the same keys and
  equal decisions, ``errors.tsv`` included.
* ``--eval`` and ``--resume`` on the port's workspace; F9 on the port's
  trained weights (the bf16 engine at the "bf16" frontend grade decides as
  the float32 engine at the exact grade on every dev and test clip); the
  refusal of a rank count that does not split the batch; the card by
  default.

On the CPU the kernels K1, K2 and K3 take their plain versions.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import howl_tpu.training.run.train as jtrain
import howl_tpu_torch.training.run.train as ttrain
from howl_tpu.context import InferenceContext as JContext
from howl_tpu.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader as JNoiseLoader
from howl_tpu.data.dataset.dataset_loader import WakeWordDatasetLoader as JLoader
from howl_tpu.inference.config import EngineConfig as JEngineConfig
from howl_tpu.inference.engine import StreamingEngine as JEngine
from howl_tpu.models import create_model as jcreate_model
from howl_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu.workspace import Workspace as JWorkspace
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.context import InferenceContext as TContext
from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader as TLoader
from howl_tpu_torch.inference.config import EngineConfig as TEngineConfig
from howl_tpu_torch.inference.engine import StreamingEngine as TEngine
from howl_tpu_torch.models import create_model as tcreate_model
from howl_tpu_torch.ops.frontend import FrontendConfig as TFrontendConfig
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from tests.fixtures import make_noise_dir, make_wakeword_corpus

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
# (epochs, steps per epoch)
PARITY_RUN, JAX_TRAINED_RUN, PORT_TRAINED_RUN = (3, 2), (20, 5), (40, 10)
ENV = {  # tests/test_train_wakeword.py's recipe, shortened, with a noise corpus for the noisy sweeps
    "VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "BATCH_SIZE": "16",
    "LEARNING_RATE": "0.02", "LR_DECAY": "0.98", "MAX_WINDOW_SIZE_SECONDS": "0.5", "EVAL_STRIDE_SIZE_SECONDS": "0.063",
    "NUM_MELS": "40", "INFERENCE_THRESHOLD": "0", "TOLERANCE_WINDOW_MS": "500", "USE_NOISE_DATASET": "true",
}
# The first step's loss is bit for bit JAX's. AdamW's first update moves every weight by about
# lr * sign(grad), so the few weights (under 30 of 110k) whose gradient lies within float32 noise
# of zero move differently in the two packages, by up to ~3e-3; after 6 steps the per-epoch losses
# differ by up to ~2e-3 relative, and after 40 steps by 10 %, with other decisions.
LOSS_RTOL = 5e-3
ZMUV_RTOL = 1e-6
MIX_ATOL = 1e-6


def jax_eval_mix_draws(batch, n_rows, seed, fold, prob, device) -> ttrain.EvalMixDraws:
    """The draws ``howl_tpu``'s ``mix_for_eval`` makes for (seed, fold)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    k_apply, k_row, k_alpha = jax.random.split(key, 3)
    apply = jax.random.bernoulli(k_apply, prob, (batch,))
    rows = jax.random.randint(k_row, (batch,), 0, n_rows)
    uniform = jax.random.uniform(k_alpha, (batch,))
    as_t = lambda x: torch.from_numpy(np.array(x)).to(device)  # noqa: E731
    return ttrain.EvalMixDraws(as_t(apply), as_t(rows).long(), as_t(uniform))


def _set_env(mp, env):
    for k, v in env.items():
        mp.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_port_settings():
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


def _capture_jax_init(mp, captured: dict) -> None:
    real = jtrain.create_train_state

    def capture(*a, **k):
        state = real(*a, **k)
        captured["init"] = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        return state

    mp.setattr(jtrain, "create_train_state", capture)


def _train(root: Path, corpus, noise, epochs: int, steps: int, packages=("jax", "port")) -> dict:
    """``--no-augment`` runs on the corpora, each package's in ``root/<package>``.
    With both, the port starts from JAX's initial weights and replays JAX's
    eval-mixing draws."""
    args = ["--model", "res8", "-i", str(corpus), "--eval-freq", "0", "--steps-per-epoch", str(steps), "--no-augment"]
    out = dict(root=root, corpus=corpus, noise=noise)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        _set_env(mp, {**ENV, "NOISE_DATASET_PATH": str(noise), "NUM_EPOCHS": str(epochs)})
        if "jax" in packages:
            _capture_jax_init(mp, captured)
            out["jax"] = jtrain.run(args + ["--workspace", str(root / "jax")])
            final = JWorkspace(root / "jax", delete_existing=False).load_model(captured["init"], best=False)
            out["jax_final"] = jax.device_get(final)
        if "port" in packages:
            if "jax" in packages:
                real = ttrain.create_train_state
                mp.setattr(ttrain, "create_train_state", lambda model, **k: real(model, **{**k, "variables": captured["init"]}))
                mp.setattr(ttrain, "draw_eval_mix", jax_eval_mix_draws)
            out["stats"] = ttrain.LoopStats()
            out["port"] = ttrain.run(args + ["--workspace", str(root / "port"), "--device", "cpu"], out["stats"])
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    return make_wakeword_corpus(root / "ww", n_positive=12, n_negative=12), make_noise_dir(root / "noise")


@pytest.fixture(scope="module")
def short_runs(tmp_path_factory, corpora):
    """The parity pair: few enough steps that the two packages' weights stay close."""
    return _train(tmp_path_factory.mktemp("short"), *corpora, *PARITY_RUN)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory, corpora):
    """JAX weights trained until they fire on some positives, for the evaluator's comparison."""
    return _train(tmp_path_factory.mktemp("jax_trained"), *corpora, *JAX_TRAINED_RUN, packages=("jax",))


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory, corpora):
    """The port trained from its own initial weights until the corpus is
    separated, as tests/test_train_wakeword.py trains JAX: for F9,
    ``--eval`` and ``--resume``."""
    return _train(tmp_path_factory.mktemp("port_trained"), *corpora, *PORT_TRAINED_RUN, packages=("port",))


def _metrics(ws: Path, name: str) -> list:
    lines = [json.loads(line) for line in (ws / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["value"]) for r in lines if r["name"] == name]


# ---- mix_for_eval ----


@pytest.mark.parametrize("batch,n,bank_shape,fold,prob", [
    (3, 32000, (12, 32000), 0, 0.75),  # the fixture's eval batch and bank
    (7, 48000, (5, 20000), 3, 0.75),  # bank rows tiled to a longer clip
    (16, 9000, (4, 9000), 11, 1.0),
    (16, 9000, (4, 9000), 2, 0.0),
])
def test_mix_for_eval_with_jax_draws_replayed(batch, n, bank_shape, fold, prob):
    rng = np.random.default_rng(fold)
    audio = (0.3 * rng.standard_normal((batch, n))).astype(np.float32)
    bank = (0.1 * rng.standard_normal(bank_shape)).astype(np.float32)
    want = np.asarray(jtrain.mix_for_eval(audio, bank, seed=5, strength=0.2, prob=prob, fold=fold))
    draws = jax_eval_mix_draws(batch, bank_shape[0], 5, fold, prob, "cpu")
    got = ttrain.apply_eval_mix(torch.from_numpy(audio), torch.from_numpy(bank), draws, 0.2).numpy()
    assert np.abs(got - want).max() <= MIX_ATOL
    untouched = ~draws.apply.numpy()
    assert np.array_equal(got[untouched], audio[untouched])
    assert untouched.all() if prob == 0.0 else not untouched.any() if prob == 1.0 else True


def test_mix_for_eval_draws_are_its_own_and_reproducible():
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 4000)).astype(np.float32))
    bank = torch.from_numpy(np.random.default_rng(1).standard_normal((6, 3000)).astype(np.float32))
    a = ttrain.mix_for_eval(audio, bank, seed=0, fold=1)
    assert torch.equal(a, ttrain.mix_for_eval(audio, bank, seed=0, fold=1))
    assert not torch.equal(a, ttrain.mix_for_eval(audio, bank, seed=0, fold=2))
    d = ttrain.draw_eval_mix(64, 6, 0, 1, 0.75, "cpu")
    assert d.rows.min() >= 0 and d.rows.max() < 6 and 0.0 <= float(d.uniform.min()) and float(d.uniform.max()) < 1.0
    alpha = torch.where(d.apply, d.uniform * 0.2, 0.0)
    assert torch.allclose(a, audio * (1 - alpha[:, None]) + bank[d.rows].repeat(1, 2)[:, :4000] * alpha[:, None])


# ---- the evaluator ----


def _eval_sets(loader, ctx, corpus):
    _, dev, test = loader.load_splits(corpus, sample_rate=16000, mono=True, frame_labeler=ctx.labeler)
    out = []
    for ds in (dev, test):
        for positive in (True, False):
            out.append((ds.filter(lambda m, p=positive: ctx.searcher.search(m.transcription) == p, clone=True), positive))
    return out


@pytest.mark.parametrize("with_bank", [False, True], ids=["clean", "mix-bank"])
def test_batched_evaluator_equals_jax_on_weights_from_jax(jax_trained, monkeypatch, with_bank):
    runs = jax_trained
    _set_env(monkeypatch, ENV)
    zmuv = json.loads((runs["root"] / "jax" / "zmuv.json").read_text())
    mean, std = zmuv["mean"], float(np.sqrt(zmuv["mean2"] - zmuv["mean"] ** 2))
    jctx, tctx = JContext(vocab=["hey", "fire", "fox"]), TContext(vocab=["hey", "fire", "fox"])
    variables = runs["jax_final"]
    jengine = JEngine(jcreate_model("res8", num_labels=jctx.num_labels), variables, JEngineConfig.from_settings(jctx),
                      JFrontendConfig.from_settings(), mean, std)
    tengine = TEngine(tcreate_model("res8", num_labels=tctx.num_labels), res8_variables_to_state_dict(variables),
                      TEngineConfig.from_settings(tctx), TFrontendConfig.from_settings(), mean, std,
                      frontend_precision="f32", device="cpu")
    bank = None
    if with_bank:
        noise_ds = JNoiseLoader().load(runs["noise"], sample_rate=16000, mono=True)
        bank = jtrain.build_noise_bank(noise_ds, 32000)
        monkeypatch.setattr(ttrain, "draw_eval_mix", jax_eval_mix_draws)
    detected = 0
    t_eval = ttrain.BatchedEvaluator(tengine, max_batch=2)
    for (jds, positive), (tds, _) in zip(_eval_sets(JLoader(), jctx, runs["corpus"]),
                                         _eval_sets(TLoader(), tctx, runs["corpus"]), strict=True):
        jconf, jerr, jms = jtrain.BatchedEvaluator(jengine, max_batch=2).evaluate(jds, positive, bank)
        tconf, terr, tms = t_eval.evaluate(tds, positive, bank)
        assert (vars(tconf), terr, tms) == (vars(jconf), jerr, jms)
        detected += tconf.tp + tconf.fp
    assert detected > 0  # the trained weights fire on some clips: the comparison is not all-negative
    assert t_eval.batches == 8  # 3 clips a split, 2 a batch
    if not with_bank:
        (jds, positive), (tds, _) = _eval_sets(JLoader(), jctx, runs["corpus"])[0], _eval_sets(TLoader(), tctx, runs["corpus"])[0]
        jsweep, _ = jtrain.BatchedEvaluator(jengine).evaluate_sweep(jds, positive, [0.0, 0.5, 0.9])
        tsweep, _ = ttrain.BatchedEvaluator(tengine).evaluate_sweep(tds, positive, [0.0, 0.5, 0.9])
        assert {t: vars(c) for t, c in tsweep.items()} == {t: vars(c) for t, c in jsweep.items()}


# ---- the two packages' runs ----


def test_no_augment_runs_agree_from_the_same_initial_weights(short_runs):
    runs = short_runs
    epochs, steps = PARITY_RUN
    jws, tws = runs["root"] / "jax", runs["root"] / "port"
    jloss, tloss = _metrics(jws, "Training/Loss"), _metrics(tws, "Training/Loss")
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == list(range(epochs))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss], rtol=LOSS_RTOL)
    np.testing.assert_allclose(_metrics(tws, "Training/LearningRate"), _metrics(jws, "Training/LearningRate"), rtol=1e-6)
    jz, tz = (json.loads((ws / "zmuv.json").read_text()) for ws in (jws, tws))
    assert tz["total"] == jz["total"]
    np.testing.assert_allclose([tz["mean"], tz["mean2"]], [jz["mean"], jz["mean2"]], rtol=ZMUV_RTOL)
    assert list(runs["port"]) == list(runs["jax"]) == [
        "dev_pos", "dev_neg", "dev_noisy_pos", "dev_noisy_neg", "test_pos", "test_neg", "test_noisy_pos", "test_noisy_neg"]
    assert runs["port"] == runs["jax"]
    assert (tws / "errors.tsv").read_text() == (jws / "errors.tsv").read_text()
    assert sorted(p.name for p in tws.iterdir()) == [
        "cmd-args.json", "errors.tsv", "logs", "metrics.jsonl", "model-best.pt", "model.pt", "settings.json",
        "train_state.pt", "zmuv.json"]
    stats = runs["stats"]
    assert (stats.steps, stats.examples, stats.eval_batches) == (epochs * steps, epochs * steps * 16, 8)
    assert stats.eval_audio_ms == 8 * 3 * 2000.0 and min(stats.prep_s, stats.step_s, stats.eval_s) > 0


def test_eval_and_resume_on_the_ports_workspace(port_trained, tmp_path, monkeypatch):
    runs = port_trained
    trained_steps = PORT_TRAINED_RUN[0] * PORT_TRAINED_RUN[1]
    ws = tmp_path / "ws"
    shutil.copytree(runs["root"] / "port", ws)
    _set_env(monkeypatch, {**ENV, "NOISE_DATASET_PATH": str(runs["noise"]), "INFERENCE_THRESHOLD": "0.0"})
    base = ["--model", "res8", "--workspace", str(ws), "-i", str(runs["corpus"]), "--device", "cpu"]
    assert ttrain.run(base + ["--eval"]) == runs["port"]  # model-best.pt reproduces the final sweeps
    rows = (ws / "0.0_results.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == [
        "Dev positive", "Dev negative", "Dev noisy positive", "Dev noisy negative",
        "Test positive", "Test negative", "Test noisy positive", "Test noisy negative"]
    assert rows[0] == f"Dev positive,0.0,{runs['port']['dev_pos']['tp']},0,0,{runs['port']['dev_pos']['fn']}"
    _set_env(monkeypatch, {"NUM_EPOCHS": "1"})
    ttrain.run(base + ["--resume", "--steps-per-epoch", "2", "--no-augment", "--eval-freq", "0"])
    saved = torch.load(ws / "train_state.pt", weights_only=True)
    assert saved["step"] == trained_steps + 2
    # AdamW's own step counts came back from the file and went on: a fresh optimizer would read 2
    assert {float(s["step"]) for s in saved["optimizer"]["state"].values()} == {trained_steps + 2.0}
    assert _metrics(ws, "Training/LearningRate")[-1] == (0, pytest.approx(0.02 * 0.98 ** ((trained_steps + 2) // 2)))


def test_f9_bf16_decisions_equal_float32_on_the_ports_trained_weights(port_trained, monkeypatch):
    """The bf16 engine as served (K1's "bf16" grade, K2 in bf16) against the
    float32 engine at the exact grade, on every dev and test clip, on the
    weights the port's own run trained until every positive fires and no
    negative does. (On weights trained less, a positive that barely fires
    can flip: near its threshold a decision is the bf16 noise's to make.)"""
    runs = port_trained
    _set_env(monkeypatch, ENV)
    tctx = TContext(vocab=["hey", "fire", "fox"])
    zmuv = json.loads((runs["root"] / "port" / "zmuv.json").read_text())
    mean, std = zmuv["mean"], float(np.sqrt(zmuv["mean2"] - zmuv["mean"] ** 2))
    state_dict = torch.load(runs["root"] / "port" / "model.pt", weights_only=True)
    engines = {
        name: TEngine(tcreate_model("res8", num_labels=tctx.num_labels), state_dict, TEngineConfig.from_settings(tctx),
                      TFrontendConfig.from_settings(), mean, std, compute_dtype=dtype, frontend_precision=precision,
                      device="cpu")
        for name, dtype, precision in (("f32", None, "f32"), ("bf16", torch.bfloat16, "bf16"))
    }
    dprob = 0.0
    for ds, positive in _eval_sets(TLoader(), tctx, runs["corpus"]):
        audio = np.stack([ds[i].audio_data for i in range(len(ds))])
        out = {name: eng.infer_batch(audio) for name, eng in engines.items()}
        assert out["f32"]["detected"].tolist() == [positive] * len(ds)  # the corpus is separated
        assert torch.equal(out["bf16"]["detected"], out["f32"]["detected"])
        dprob = max(dprob, float((out["bf16"]["probs"] - out["f32"]["probs"]).abs().max()))
    assert dprob < 0.05  # ~1e-2 on these weights


# ---- refusals and the device ----


@pytest.mark.parametrize("extra,env,item", [
    (["--num-devices", "4"], {"BATCH_SIZE": "6"}, "must divide the batch size 6"),
    (["--num-devices", "3"], {"BATCH_SIZE": "16"}, "must divide the batch size 16"),
])
def test_refusals_cite_their_roadmap_item(tmp_path, monkeypatch, extra, env, item):
    """Data parallelism (ROADMAP item 12) refuses a rank count that does not
    split the batch, before anything is read or launched
    (tests/test_torch_scaleout.py holds the rest)."""
    _set_env(monkeypatch, env)
    args = ["--model", "res8", "--workspace", str(tmp_path / "ws"), "-i", str(tmp_path), "--device", "cpu", *extra]
    with pytest.raises(SystemExit, match=item):
        ttrain.run(args)
    assert not (tmp_path / "ws").exists()  # refused before anything was read or written


def test_run_asks_for_the_card_unless_given_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--model", "res8", "--workspace", str(tmp_path / "ws"), "-i", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(args)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ttrain.run(args + ["--device", "tpu"])
    _set_env(monkeypatch, {"DEVICE": "cpu"})  # SETTINGS.training.device is the flag's default
    for split in ("training", "dev", "test"):
        (tmp_path / f"aligned-metadata-{split}.jsonl").write_text("")
    with pytest.raises(SystemExit, match="no training clips"):  # it ran, on the CPU, until it found no clips
        ttrain.run(args)


def test_help_runs_without_jax():
    code = (
        "import runpy, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'howl_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "sys.argv = ['train', '--help']\n"
        "runpy.run_module('howl_tpu_torch.training.run.train', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--device", "--bf16", "--fused-trunk", "--resume", "--noise-bank-mb", "--eval-freq"):
        assert flag in proc.stdout
