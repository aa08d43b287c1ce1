"""The port's online engines (howl_tpu_torch/inference/online.py) against the
JAX package's, and the repair that lets the frontend and stem kernels take
65,536 clips in one launch.

* ``OnlineEngine`` and ``IncrementalOnlineEngine`` against their JAX twins
  on the same weights (carried across by ``compat``) and the same seeded
  audio: 4 streams of 2 s, 4 labels, 500 ms windows every 62.5 ms, a word
  and threshold picked so that some streams fire and some do not. Per-step
  labels and fire flags equal; the newest posterior of the smoothing ring
  within 1e-4 in float32 and 2e-2 in bf16. On the CPU the JAX engines run
  their XLA log-mel chain; the port's ``OnlineEngine`` runs the plain
  version of its frontend kernel and both run the stem kernel's plain
  version.
* The incremental ring equals the port's own clip-level
  ``log_mel_spectrogram(stream, center=True)`` frames bit for bit once the
  startup frames have rolled out, at the default geometry and at 125 ms /
  750 ms; at 12.5 ms (one frame a push, a matrix-vector product) within
  1e-5, JAX's own bound.
* The float32 clock rebase keeps the detections; shapes and arguments are
  checked as in JAX; the engines ask for the card unless given the CPU.
* The grid repair: the wrappers take 65,536 clips, no launcher caps the
  clips, and the one-axis grid visits every (clip, tile) once.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference.online import IncrementalOnlineEngine as JaxIncrementalOnlineEngine
from howl_tpu.inference.online import OnlineEngine as JaxOnlineEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig
from howl_tpu_torch.inference import online
from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
from howl_tpu_torch.models import create_model
from howl_tpu_torch.models.base import ModelSpec
from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda
from howl_tpu_torch.tools.validate_tpu_decisions import margin_word_threshold

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SR = 16000
ZMUV = (-6.0, 4.0)
STREAMS = 4
BASE = dict(inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5, negative_label=3,
            num_labels=4, sample_rate=SR)
ENGINES = {"full-window": (JaxOnlineEngine, OnlineEngine), "incremental": (JaxIncrementalOnlineEngine,
                                                                           IncrementalOnlineEngine)}


def _variables(seed):
    rng = np.random.default_rng(seed)
    variables = jax_create_model("res8", num_labels=4).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 1, 40, 41)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    for i in range(1, 7):
        variables["batch_stats"][f"bn{i}"] = {"mean": rng.normal(0.0, 0.1, 45).astype(np.float32),
                                              "var": rng.uniform(0.5, 1.5, 45).astype(np.float32)}
    return variables


def _audio(seed, streams=STREAMS, samples=2 * SR):
    """Loud tones over noise on the first half of the streams, quiet noise on
    the rest: inputs a random res8 scores far apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    tones = 0.5 * np.sin(2 * np.pi * rng.uniform(200.0, 4000.0, (streams, 1)) * t)
    noise = rng.standard_normal((streams, samples))
    loud = np.arange(streams)[:, None] < streams // 2
    return np.where(loud, tones + 0.05 * noise, 0.002 * noise).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """Weights, audio and a configuration whose word and threshold split the
    streams, picked from the JAX engines' own per-step posteriors, float32
    and bf16 (their first windows hold the silence of a filling buffer,
    which a random res8 may score high): the word and threshold that keep
    every decision 0.01 from flipping (``margin_word_threshold``)."""
    variables, audio = _variables(47), _audio(48)
    probs = []
    for cls in (JaxOnlineEngine, JaxIncrementalOnlineEngine):
        for dtype in (None, jnp.bfloat16):
            per_step = []
            _feed(_jax_engine(cls, variables, BASE, dtype), audio,
                  lambda e: per_step.append(np.asarray(e.state.pred_ring[:, -1])))
            probs.append(np.stack(per_step))  # (T, N, L)
    pick = margin_word_threshold(np.concatenate(probs), 0.01)
    word = pick["word"]
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4,
                  inference_threshold=pick["threshold"])
    return variables, audio, cfg_kw


def _jax_engine(cls, variables, cfg_kw, dtype=None, **kw):
    return cls(jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw),
               JaxFrontendConfig(n_mels=kw.pop("n_mels", 40)), *ZMUV, num_streams=kw.pop("num_streams", STREAMS),
               compute_dtype=dtype, **kw)


def _port_engine(cls, variables, cfg_kw, dtype=None, **kw):
    return cls(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables), EngineConfig(**cfg_kw),
               FrontendConfig(n_mels=kw.pop("n_mels", 40)), *ZMUV, num_streams=kw.pop("num_streams", STREAMS),
               compute_dtype=dtype, device="cpu", **kw)


def _feed(engine, audio, step):
    """Drive an engine over ``audio`` hop by hop, as the JAX decision tool
    does: ``OnlineEngine`` gets the window ending at each hop (shorter at the
    start), the incremental engine each hop's samples. Calls ``step(engine)``
    after every hop."""
    hop = engine.hop_samples if hasattr(engine, "push") else int(round(engine.stride_ms / 1000 * SR))
    for end in range(hop, audio.shape[1] + 1, hop):
        if hasattr(engine, "push"):
            engine.push(audio[:, end - hop : end])
        else:
            engine.ingest(audio[:, max(0, end - engine.window_samples) : end])
        step(engine)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_online_engine_matches_its_jax_twin(setup, kind, dtype):
    variables, audio, cfg_kw = setup
    jcls, tcls = ENGINES[kind]
    jx = _jax_engine(jcls, variables, cfg_kw, None if dtype == "float32" else jnp.bfloat16)
    pt = _port_engine(tcls, variables, cfg_kw, None if dtype == "float32" else torch.bfloat16)
    assert pt.stride_ms == jx.stride_ms
    outs = {}
    for name, eng in (("jax", jx), ("port", pt)):
        labels, fired, probs = [], [], []

        def step(e, labels=labels, fired=fired, probs=probs):
            labels.append(np.asarray(e.last_labels))
            fired.append(np.asarray(e.last_fired))
            probs.append(np.asarray(e.state.pred_ring[:, -1].float() if torch.is_tensor(e.state.pred_ring)
                                    else e.state.pred_ring[:, -1]))

        _feed(eng, audio, step)
        outs[name] = np.stack(labels), np.stack(fired), np.stack(probs)
    (jl, jf, jp), (tl, tf, tp) = outs["jax"], outs["port"]
    assert tl.shape == (32, STREAMS) and tl.dtype == np.int32 and tf.dtype == bool
    np.testing.assert_allclose(tp, jp, atol=1e-4 if dtype == "float32" else 2e-2)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
    detected = tf.any(0)
    assert detected.any() and not detected.all(), f"need some streams to fire and some not: {detected}"
    assert pt.state.fired.tolist() == detected.tolist()


@pytest.mark.parametrize("stride_ms,n_mels,window_ms,exact", [
    (62.5, 40, 500.0, True), (125.0, 40, 750.0, True), (12.5, 80, 500.0, False)])
def test_incremental_ring_equals_clip_level_frames(setup, stride_ms, n_mels, window_ms, exact):
    variables, _, _ = setup
    cfg_kw = dict(BASE, max_window_size_ms=window_ms, eval_stride_size_ms=stride_ms)
    eng = _port_engine(IncrementalOnlineEngine, variables, cfg_kw, n_mels=n_mels, num_streams=2)
    n_fft, hop = eng.frontend.n_fft, eng.frontend.hop_length
    assert n_fft - hop <= eng.tail_samples < n_fft and eng.tail_samples % hop == (n_fft // 2) % hop
    assert (eng.tail_samples + eng.hop_samples - n_fft) // hop + 1 == eng.stride_frames
    clip = (np.random.default_rng(10).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    n_push = clip.shape[-1] // eng.hop_samples
    for k in range(n_push):
        eng.push(clip[:, k * eng.hop_samples : (k + 1) * eng.hop_samples])
    ref = (log_mel_spectrogram(torch.from_numpy(clip), eng.frontend) - ZMUV[0]) / ZMUV[1]
    shift = (eng.tail_samples + hop - n_fft // 2) // hop
    t_end = eng.stride_frames * n_push - shift
    start = t_end - eng.window_frames + 1
    assert start >= 2, "the clip is too short for a ring with no startup frame"
    want = ref[:, :, start : t_end + 1]
    if exact:
        assert torch.equal(eng.mel_ring, want)
    else:
        torch.testing.assert_close(eng.mel_ring, want, rtol=1e-5, atol=1e-5)


def test_clock_rebase_keeps_the_detections(setup):
    """A stream started just below the float32 rebase point labels and fires
    at the same steps as one at the start of the clock."""
    variables, audio, cfg_kw = setup
    fresh, old = (_port_engine(IncrementalOnlineEngine, variables, cfg_kw) for _ in range(2))
    hop = fresh.hop_samples
    for k in range(3):
        for eng in (fresh, old):
            eng.push(audio[:, k * hop : (k + 1) * hop])
    shift = online._REBASE_AT - old.curr_time - old.stride_ms  # the clock crosses it on the next push
    old.curr_time += shift
    old.state = old.state._replace(pred_times=old.state.pred_times + np.float32(shift),
                                   label_times=old.state.label_times + np.float32(shift))
    seen = {"fresh": [], "old": []}
    for k in range(3, audio.shape[1] // hop):
        for name, eng in (("fresh", fresh), ("old", old)):
            fired = eng.push(audio[:, k * hop : (k + 1) * hop])
            seen[name].append((fired, eng.last_labels.tolist(), eng.last_fired.tolist()))
    assert old.curr_time < online._REBASE_AT  # the rebase ran
    assert seen["fresh"] == seen["old"]
    assert any(f for f, _, _ in seen["fresh"])


def test_shapes_and_arguments_are_checked_as_in_jax(setup):
    variables, _, cfg_kw = setup
    inc = _port_engine(IncrementalOnlineEngine, variables, cfg_kw, num_streams=2)
    with pytest.raises(ValueError, match="push expects"):
        inc.push(np.zeros((2, inc.hop_samples - 1), np.float32))
    full = _port_engine(OnlineEngine, variables, cfg_kw, num_streams=2)
    with pytest.raises(ValueError, match="stream"):
        full.ingest(np.zeros((3, 8000), np.float32))
    # a short window is zero-padded on the left; a long one keeps its newest samples
    short, long_ = np.ones((2, 3000), np.float32) * 0.1, np.ones((2, 9000), np.float32) * 0.1
    full.ingest(short)
    pad_state = full.state
    full.reset()
    full.ingest(np.concatenate([np.zeros((2, 5000), np.float32), short], 1))
    torch.testing.assert_close(full.state.pred_ring, pad_state.pred_ring, rtol=0, atol=0)
    full.reset()
    full.ingest(long_)
    assert full.curr_time == full.stride_ms and full.last_labels.shape == (2,)
    assert isinstance(inc.push(np.zeros(inc.hop_samples, np.float32)[None].repeat(2, 0)), bool)
    for cls in (OnlineEngine, IncrementalOnlineEngine):
        with pytest.raises(ValueError, match="recurrent.*item 8"):
            _port_engine(cls, variables, cfg_kw, carry_hops=True)
        with pytest.raises(NotImplementedError, match="item 12"):
            _port_engine(cls, variables, cfg_kw).shard_streams(None)
        other = ModelSpec("small-cnn", create_model, supports_trunk=False)
        with pytest.raises(NotImplementedError, match="item 8"):
            _port_engine(cls, variables, cfg_kw, spec=other)


def test_engines_ask_for_the_card_unless_given_the_cpu(setup, monkeypatch):
    variables, _, cfg_kw = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (OnlineEngine, IncrementalOnlineEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables), EngineConfig(**cfg_kw),
                FrontendConfig(n_mels=40))


def test_new_variables_re_derive_the_stem_taps(setup):
    """Assigning ``variables`` loads the weights and the stem kernel's taps
    (ROADMAP F2): the engine then scores as a fresh one on those weights."""
    variables, audio, cfg_kw = setup
    other = res8_variables_to_state_dict(_variables(43))
    eng = _port_engine(OnlineEngine, variables, cfg_kw)
    taps = eng._stem_taps.clone()
    eng.variables = other
    assert not torch.equal(taps, eng._stem_taps)
    fresh = OnlineEngine(create_model("res8", num_labels=4), other, EngineConfig(**cfg_kw), FrontendConfig(n_mels=40),
                         *ZMUV, num_streams=STREAMS, device="cpu")
    eng.ingest(audio[:, :8000])
    fresh.ingest(audio[:, :8000])
    torch.testing.assert_close(eng.state.pred_ring, fresh.state.pred_ring, rtol=0, atol=0)


# ---- the grid repair: 65,536 clips in one launch ----

_LAUNCHERS = {
    "stem_tc.cu": ("stem_tc_kernel", "kTile"),
    "stem.cu": ("stem_kernel", "kPooledPerBlock"),
    "frontend_tc.cu": ("logmel_tc_kernel", "kTile"),
    "frontend.cu": ("logmel_kernel", "kFramesPerBlock"),
}


def test_the_wrappers_take_65536_clips():
    """On the CPU the wrappers run their plain versions at 65,536 clips (of a
    small geometry); no wrapper and no launcher of the two kernels caps the
    clips any more."""
    mel = torch.randn((65536, 3, 4))
    taps = torch.randn((3, 3, 2))
    out = res8_stem_cuda(mel, taps)
    assert tuple(out.shape) == (65536, 1, 1, 2) and bool(torch.isfinite(out).all())
    audio = torch.randn((65536, 400)) * 0.1
    cfg = FrontendConfig(n_mels=8, n_fft=64, hop_length=32)
    mels = log_mel_spectrogram_cuda(audio, cfg, precision="bf16", out_dtype=torch.bfloat16, layout="fm")
    assert tuple(mels.shape) == (65536, 8, cfg.num_frames(400))
    for name in ("ops/stem_cuda.py", "ops/frontend_cuda.py", "csrc/stem_tc.cu", "csrc/stem.cu", "csrc/frontend_tc.cu",
                 "csrc/frontend.cu"):
        text = (REPO / "howl_tpu_torch" / name).read_text()
        assert "65535" not in text and "65,535" not in text and "blockIdx.y" not in text, name


@pytest.mark.parametrize("source", list(_LAUNCHERS))
def test_each_launcher_puts_clips_and_tiles_on_one_grid_axis(source):
    """The launch is a one-axis grid of clips x tiles, the tiles of a clip
    adjacent, and the kernel decodes its block index back; walked here over
    65,536 clips of 41 frames (one tile) and 3 clips of many tiles: every
    (clip, tile) once."""
    text = (REPO / "howl_tpu_torch" / "csrc" / source).read_text()
    kernel, tile = _LAUNCHERS[source]
    assert re.search(rf"const int n_tiles = \(\w+ \+ {tile} - 1\) / {tile};\n\s*const int b = blockIdx.x / n_tiles;",
                     text), source
    assert re.search(rf"= \(blockIdx.x % n_tiles\) \* {tile};", text), source
    assert re.search(rf"const long long blocks = static_cast<long long>\(\(\w+ \+ {tile} - 1\) / {tile}\) \* B;",
                     text), source
    assert "0x7fffffffLL" in text and "const dim3 grid(static_cast<unsigned>(blocks));" in text
    assert f"{kernel}" in text
    for clips, tiles in ((65536, 1), (3, 7)):
        blocks = np.arange(clips * tiles)
        b, t = blocks // tiles, blocks % tiles
        assert b.max() == clips - 1 and len(set(zip(b.tolist(), t.tolist()))) == clips * tiles
        assert (np.diff(b) >= 0).all()  # the tiles of a clip adjacent, as the two-axis grid ran them
