"""The port's export and host tools against howl_tpu's, on the CPU:
``ops/meyda.py``, ``training/run/export_honkling.py``,
``training/run/generate_precise_dataset.py``, ``training/run/demo.py`` and
``utils/profiling.py``.

* ``cooley_tukey_fft`` and ``MeydaMelSpectrogram`` give JAX's outputs bit
  for bit (the same numpy operations); with ``USE_MEYDA_SPECTROGRAM`` the
  port's log-mel frontend (22,050 Hz, 40 mels) matches the Meyda chain at
  rtol 1e-3 / atol 1e-4 in the exp domain and differs from the Nyquist
  basis, as ``tests/test_config_and_exports.py`` holds JAX's.
* The honkling file of res8 (name ``RES8``, and another name), small-cnn and
  lstm is byte for byte the JAX tool's on the same weights, carried across
  by ``compat.variables_to_state_dict``; a workspace directory reads its
  ``model-best.pt``.
* ``generate_precise_dataset`` writes JAX's tree: the same names, symlinks
  to the same resolved targets, ``--deep-copy`` bytes, and the noisy dev and
  test wavs byte for byte.
* ``demo --streams 2 --incremental`` on one res8's port and JAX workspaces
  prints JAX's lines (the ticks that fired and the per-stream detections),
  and so does the single-stream client; the engine flags are refused
  together before any file is read; the card is asked for unless
  ``--device cpu``.
* ``StepTimer`` keeps its keys; ``trace`` writes a Chrome trace on the CPU.
"""

import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.compat import variables_to_state_dict
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from tests.fixtures import make_noise_dir, make_wakeword_corpus

torch.set_num_threads(2)


def _set_env(mp, env: dict):
    for k, v in env.items():
        mp.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_port_settings():
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


# ---- Meyda ----


@pytest.mark.parametrize("n", [32, 256, 512])
def test_cooley_tukey_fft_is_jaxs_bit_for_bit(n, rng):
    from howl_tpu.ops.meyda import cooley_tukey_fft as jfft
    from howl_tpu_torch.ops.meyda import cooley_tukey_fft as tfft

    x = rng.standard_normal(n)
    np.testing.assert_array_equal(tfft(x), jfft(x))
    np.testing.assert_allclose(tfft(x), np.fft.fft(x), atol=1e-8)
    with pytest.raises(ValueError, match="power of 2"):
        tfft(np.zeros(n + 3))


@pytest.mark.parametrize("kw", [dict(n_mels=40), dict(n_fft=512, n_mels=40, sample_rate=22050, hop_length=200)])
def test_meyda_mel_spectrogram_is_jaxs_bit_for_bit(kw, rng):
    from howl_tpu.ops.meyda import MeydaMelSpectrogram as JMeyda
    from howl_tpu_torch.ops.meyda import MeydaMelSpectrogram as TMeyda

    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    j, t = JMeyda(**kw), TMeyda(**kw)
    np.testing.assert_array_equal(t.mel_basis, j.mel_basis)
    np.testing.assert_array_equal(t.fft_window, j.fft_window)
    out = t(audio)
    assert out.dtype == np.float32 and out.shape == (2, 40, 41)
    np.testing.assert_array_equal(out, j(audio))


def test_use_meyda_spectrogram_routes_the_ports_frontend(monkeypatch, rng):
    from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
    from howl_tpu_torch.ops.meyda import MeydaMelSpectrogram

    assert FrontendConfig.from_settings().f_max is None  # flag off: Nyquist
    _set_env(monkeypatch, {"USE_MEYDA_SPECTROGRAM": "true", "SAMPLE_RATE": "22050", "NUM_MELS": "40"})
    cfg = FrontendConfig.from_settings()
    assert cfg.f_max == 8000.0 and cfg.sample_rate == 22050

    audio = (rng.standard_normal((1, 11025)) * 0.1).astype(np.float32)
    meyda = MeydaMelSpectrogram(n_fft=cfg.n_fft, n_mels=cfg.n_mels, sample_rate=cfg.sample_rate,
                                hop_length=cfg.hop_length)
    host = meyda(audio)
    dev = np.exp(log_mel_spectrogram(torch.from_numpy(audio), cfg).numpy())
    np.testing.assert_allclose(dev, host, rtol=1e-3, atol=1e-4)
    nyq = np.exp(log_mel_spectrogram(torch.from_numpy(audio), FrontendConfig(
        n_fft=cfg.n_fft, n_mels=cfg.n_mels, sample_rate=cfg.sample_rate, hop_length=cfg.hop_length)).numpy())
    assert not np.allclose(dev, nyq, rtol=1e-3, atol=1e-4)


# ---- the honkling export ----


def _jax_variables(name: str, num_labels: int = 4):
    """The JAX tool's own template for ``name``, initialized at PRNGKey(0),
    as numpy."""
    import jax

    from howl_tpu.models import create_model
    from howl_tpu.ops.frontend import FrontendConfig
    from howl_tpu.training.step import StepConfig, featurize

    model = create_model(name, num_labels=num_labels)
    cfg = StepConfig(frontend=FrontendConfig.from_settings(), zmuv_mean=0.0, zmuv_std=1.0, use_vtlp=False)
    feats0 = featurize(np.zeros((1, 8000), np.float32), cfg)
    variables = model.init({"params": jax.random.PRNGKey(0)}, feats0, train=False)
    return jax.tree.map(np.asarray, jax.device_get(variables))


@pytest.mark.parametrize("name,honkling", [("res8", "RES8"), ("res8", "my-res8"), ("small-cnn", "SMALL"),
                                           ("lstm", "LSTM")])
def test_honkling_file_is_the_jax_tools_byte_for_byte(name, honkling, tmp_path):
    import flax

    from howl_tpu.training.run.export_honkling import run as jrun
    from howl_tpu_torch.training.run.export_honkling import run as trun

    variables = _jax_variables(name)
    (tmp_path / "model.flax").write_bytes(flax.serialization.to_bytes(variables))
    torch.save(variables_to_state_dict(name, variables), tmp_path / "model.pt")
    common = ["--name", honkling, "--model", name, "--num-labels", "4"]
    jrun(["-i", str(tmp_path / "model.flax"), "-o", str(tmp_path / "jax.js"), *common])
    trun(["-i", str(tmp_path / "model.pt"), "-o", str(tmp_path / "port.js"), *common])
    jax_bytes = (tmp_path / "jax.js").read_bytes()
    assert (tmp_path / "port.js").read_bytes() == jax_bytes
    weights = json.loads(jax_bytes.decode().split("= ", 1)[1])
    assert ("scale1.scale" in weights) == (honkling == "RES8")
    if name == "res8":
        assert np.asarray(weights["conv0.weight"]).shape == (45, 1, 3, 3)
        assert np.asarray(weights["output.weight"]).shape == (4, 45)
    # a workspace directory is read through its model-best.pt
    ws = tmp_path / "ws"
    ws.mkdir()
    (tmp_path / "model.pt").rename(ws / "model-best.pt")
    trun(["-i", str(ws), "-o", str(tmp_path / "ws.js"), *common])
    assert (tmp_path / "ws.js").read_bytes() == jax_bytes


# ---- the precise dataset ----


def _tree(root: Path) -> dict:
    """{relative path: ("link", resolved target) or ("file", bytes)}."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
    return out


@pytest.mark.parametrize("deep_copy", [False, True])
def test_precise_dataset_tree_is_the_jax_tools(deep_copy, tmp_path, monkeypatch):
    from howl_tpu.training.run.generate_precise_dataset import run as jrun
    from howl_tpu_torch.training.run.generate_precise_dataset import run as trun

    make_wakeword_corpus(tmp_path / "ww", n_positive=4, n_negative=4)
    noise = make_noise_dir(tmp_path / "noise", n=4, seconds=2.5)
    _set_env(monkeypatch, {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]",
                           "USE_NOISE_DATASET": "True", "NOISE_DATASET_PATH": str(noise)})
    monkeypatch.chdir(tmp_path)  # a relative -i: the links must resolve
    extra = ["--deep-copy"] if deep_copy else []
    jrun(["-i", "ww", "-o", str(tmp_path / "jax"), *extra])
    trun(["-i", "ww", "-o", str(tmp_path / "port"), *extra])
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert port_tree == jax_tree
    kinds = {rel.split("/")[0]: kind for rel, (kind, _) in port_tree.items()}
    assert kinds["wake-word"] == ("file" if deep_copy else "link")
    assert kinds["noisy-dev"] == kinds["noisy-test"] == "file"  # mixed wavs, byte for byte
    assert any(rel.startswith("noisy-test/not-wake-word/") for rel in port_tree)
    if not deep_copy:
        link = next((tmp_path / "port" / "wake-word").glob("*.wav"))
        assert os.path.isabs(os.readlink(link)) and link.exists()


# ---- the demo ----


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    from tests.torch_serving import family_setup

    setup = family_setup(tmp_path_factory.mktemp("demo"), "res8")
    T_SETTINGS.reset()
    return setup


def _printed(fn, args) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("flags", [["--streams", "2", "--incremental"], ["--streams", "3"], []])
def test_demo_prints_the_jax_demos_detections(flags, demo_setup):
    from howl_tpu.training.run.demo import run as jrun
    from howl_tpu_torch.training.run.demo import run as trun

    wavs = [str(demo_setup["pos"][0]), str(demo_setup["neg"][0])]
    jax_lines = _printed(jrun, ["--workspace", str(demo_setup["jax"]), "--wav", *wavs, *flags])
    port_lines = _printed(trun, ["--workspace", str(demo_setup["port"]), "--wav", *wavs, *flags, "--device", "cpu"])
    assert port_lines == jax_lines
    assert any("detected" in line for line in port_lines)
    if flags:
        assert port_lines[-1].startswith(f"served {flags[1]} streams")


def test_demo_refuses_its_engine_flags_together_and_asks_for_the_card(tmp_path, monkeypatch):
    from howl_tpu_torch.training.run.demo import run as trun

    with pytest.raises(SystemExit):
        trun(["--workspace", str(tmp_path / "missing"), "--incremental", "--streaming-trunk"])
    assert not (tmp_path / "missing").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun(["--workspace", str(tmp_path / "missing"), "--wav", "x.wav", "--streams", "2"])


# ---- profiling ----


def test_step_timer_keeps_its_keys():
    from howl_tpu.utils.profiling import StepTimer as JTimer
    from howl_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer()
    assert timer.summary() == JTimer().summary() == {}
    for _ in range(5):
        with timer:
            sum(range(1000))
    summary = timer.summary()
    assert set(summary) == {"steps", "mean_ms", "p50_ms", "p90_ms", "p99_ms"} and summary["steps"] == 5
    assert 0 < summary["p50_ms"] <= summary["p90_ms"] <= summary["p99_ms"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from howl_tpu_torch.utils.profiling import trace

    x = torch.randn(64, 64)
    with trace(tmp_path / "tb", device="cpu") as prof:
        (x @ x).sum()
    files = list((tmp_path / "tb").glob("*.json"))
    assert files == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any("aten::mm" in e.key for e in prof.key_averages())


def test_two_trace_sessions_in_one_process_write_their_own_files(tmp_path):
    """F18's CPU half: two sessions one after the other in this process, each
    around its own op, each write a trace file of their own that holds its
    op and not the other's (the card's half, each session naming K1, is
    ``tests/test_torch_gpu.py``'s)."""
    from howl_tpu_torch.utils.profiling import trace

    x = torch.randn(64, 64)
    paths = []
    for op, other in ((torch.mm, "aten::mul"), (torch.mul, "aten::mm")):
        with trace(tmp_path / "tb", device="cpu") as prof:
            op(x, x).sum()
        names = {str(e.get("name")) for e in json.loads(prof.trace_path.read_text())["traceEvents"]}
        assert f"aten::{op.__name__}" in names and other not in names
        assert not hasattr(prof, "lost_at_start")  # no primer without the card
        paths.append(prof.trace_path)
    assert paths[0] != paths[1] and sorted((tmp_path / "tb").glob("*.json")) == sorted(paths)
