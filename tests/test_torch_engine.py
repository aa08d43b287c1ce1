"""The whole slice: the port's StreamingEngine (howl_tpu_torch) vs the JAX
StreamingEngine(use_pallas_stem=True) on the same seeded weights and audio,
at B=4 clips of 2 s, 40 mels, bench.py's EngineConfig geometry.

On the CPU the JAX engine turns its Pallas frontend off (it is TPU-only,
engine.py's ``_use_pallas``), so its features come from the jnp chain at
``serving_dft_precision``: exact float32 for float32 serving, the 1-pass
"bf16" grade for bf16 serving. The port runs the plain versions of its
frontend and stem kernels here: at ``frontend_precision="auto"`` (float32)
for the float32 comparison, and at its default ("auto": "bf16" in bf16)
with bf16 mels for the bf16 one; the default pinned against the JAX
constructor's for both dtypes (ROADMAP F12). The JAX stem runs in Pallas interpret mode.

The word label and threshold are picked from the float32 JAX posteriors so
that some clips fire and some do not, and the tests assert that they do.
Tolerances: float32 posteriors 1e-4; bf16 posteriors 2e-2; decisions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference import StreamingEngine as JaxStreamingEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.models.base import model_spec as jax_model_spec
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import numpy_variables, res8_variables_to_state_dict, variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig, StreamingEngine, WholeClipEngine
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.frontend import FrontendConfig

torch.set_num_threads(1)

SR = 16000
ZMUV = (-6.0, 4.0)
BASE = dict(
    inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
    negative_label=3, num_labels=4, sample_rate=SR,
)
DECISIONS = ("labels", "fired", "detected", "first_fire_step")


def _variables(seed):
    rng = np.random.default_rng(seed)
    flax_model = jax_create_model("res8", num_labels=4)
    variables = flax_model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 1, 40, 41)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    for i in range(1, 7):
        variables["batch_stats"][f"bn{i}"] = {
            "mean": rng.normal(0.0, 0.1, 45).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 45).astype(np.float32),
        }
    return variables


def _audio(seed, batch=4, samples=2 * SR):
    """Loud tones over noise for the first half of the batch, quiet noise for
    the rest: inputs a random res8 scores far apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    tones = 0.5 * np.sin(2 * np.pi * rng.uniform(200.0, 4000.0, (batch, 1)) * t)
    noise = rng.standard_normal((batch, samples))
    loud = np.arange(batch)[:, None] < batch // 2
    return np.where(loud, tones + 0.05 * noise, 0.002 * noise).astype(np.float32)


def _jax_engine(variables, cfg_kw, compute_dtype=None):
    return JaxStreamingEngine(
        jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw), JaxFrontendConfig(n_mels=40),
        *ZMUV, spec=jax_model_spec("res8"), compute_dtype=compute_dtype, use_pallas_stem=True,
    )


def _port_engine(variables, cfg_kw, compute_dtype=None, **kw):
    return StreamingEngine(
        create_model("res8", num_labels=4), res8_variables_to_state_dict(variables), EngineConfig(**cfg_kw),
        FrontendConfig(n_mels=40), *ZMUV, compute_dtype=compute_dtype, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def slice_setup():
    variables = _variables(21)
    audio = _audio(22)
    lengths = np.array([2 * SR, 21000, 2 * SR, 2 * SR - 3000], np.int32)
    probe = np.asarray(_jax_engine(variables, BASE).score_batch(audio)["probs"])
    half = probe.shape[0] // 2
    word = int(np.bincount(probe[:half].argmax(-1).ravel(), minlength=4).argmax())
    peak = probe.max(-1).max(-1)
    quiet, loud = float(peak[half:].max()), float(peak[:half].min())
    assert loud - quiet > 0.1, "the probe batch does not split: no threshold separates the clips"
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4,
                  inference_threshold=(quiet + loud) / 2)
    return variables, audio, lengths, cfg_kw


def _assert_decisions_equal(got, want):
    for key in DECISIONS:
        np.testing.assert_array_equal(got[key].cpu().numpy(), np.asarray(want[key]), err_msg=key)


def test_engine_matches_jax_f32(slice_setup):
    variables, audio, lengths, cfg_kw = slice_setup
    jx = _jax_engine(variables, cfg_kw)
    pt = _port_engine(variables, cfg_kw, frontend_precision="auto")
    want = jx.infer_batch(audio, lengths)
    got = pt.infer_batch(audio, lengths)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)
    np.testing.assert_array_equal(got["times_ms"], want["times_ms"])
    detected = got["detected"].numpy()
    assert detected.any() and not detected.all(), f"need some clips to fire and some not: {detected}"

    scores_j, scores_t = jx.score_batch(audio, lengths), pt.score_batch(audio, lengths)
    np.testing.assert_array_equal(scores_t["valid"].numpy(), np.asarray(scores_j["valid"]))
    np.testing.assert_allclose(scores_t["probs"].numpy(), np.asarray(scores_j["probs"]), atol=1e-4)
    for thr in (None, 0.0, cfg_kw["inference_threshold"] + 0.05):
        _assert_decisions_equal(pt.detect_from_scores(scores_t, thr), jx.detect_from_scores(scores_j, thr))


def test_engine_matches_jax_bf16(slice_setup):
    variables, audio, lengths, cfg_kw = slice_setup
    want = _jax_engine(variables, cfg_kw, jnp.bfloat16).infer_batch(audio, lengths)
    pt = _port_engine(variables, cfg_kw, torch.bfloat16)
    assert pt.frontend_precision == "bf16" and pt.model.conv1.weight.dtype == torch.bfloat16
    got = pt.infer_batch(audio, lengths)
    assert got["probs"].dtype == torch.float32
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=2e-2)
    _assert_decisions_equal(got, want)
    detected = got["detected"].numpy()
    assert detected.any() and not detected.all()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
def test_default_frontend_grade_is_the_jax_engines(slice_setup, dtype, monkeypatch):
    """ROADMAP F12: an engine built with defaults serves the frontend grade
    the JAX constructor serves ("auto": the exact grade in float32, "bf16"
    in bf16), read through the live engines' mapping of the JAX chain's
    precision (None is the exact float32 grade there); the float32 engine
    calls K1 at "f32"."""
    from howl_tpu_torch.inference import engine as engine_mod
    from howl_tpu_torch.ops.frontend_cuda import frontend_grade

    variables, audio, lengths, cfg_kw = slice_setup
    jx = JaxStreamingEngine(jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw),
                            JaxFrontendConfig(n_mels=40), *ZMUV, compute_dtype=None if dtype is None else jnp.bfloat16)
    jax_grade = "f32" if jx._dft_precision is None else frontend_grade(jx._dft_precision)
    pt = StreamingEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                         EngineConfig(**cfg_kw), FrontendConfig(n_mels=40), *ZMUV, compute_dtype=dtype, device="cpu")
    assert frontend_grade(pt.frontend_precision) == jax_grade == ("f32" if dtype is None else "bf16")
    calls = []
    k1 = engine_mod.log_mel_spectrogram_cuda

    def spy(*args, **kw):
        calls.append(frontend_grade(kw["precision"]))
        return k1(*args, **kw)

    monkeypatch.setattr(engine_mod, "log_mel_spectrogram_cuda", spy)
    got = pt.infer_batch(audio, lengths)
    assert calls == [jax_grade]
    if dtype is None:  # the exact grade is what the JAX engine scores: its posteriors to float32's bound
        want = jx.infer_batch(audio, lengths)
        np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)


def test_short_clips_score_no_windows(slice_setup):
    """Clips shorter than one window are padded for scoring, every window is
    masked invalid and nothing fires, as in the JAX engine."""
    variables, _, _, cfg_kw = slice_setup
    clips = _audio(23, batch=2, samples=7999)
    want = _jax_engine(variables, cfg_kw).infer_batch(clips)
    got = _port_engine(variables, cfg_kw, frontend_precision="auto").infer_batch(clips)
    _assert_decisions_equal(got, want)
    assert not got["detected"].any() and (got["labels"] == -1).all()
    pt = _port_engine(variables, cfg_kw)
    assert pt.infer(clips[0]) is False


def test_new_variables_change_scores(slice_setup):
    """Assigning engine.variables re-derives the stem taps: the scores follow
    the new checkpoint and equal a fresh engine's (ROADMAP F2)."""
    variables, audio, _, cfg_kw = slice_setup
    other = _variables(31)
    pt = _port_engine(variables, cfg_kw)
    before = pt.score_batch(audio)["probs"]
    taps_before = pt._stem_taps.clone()
    pt.variables = res8_variables_to_state_dict(other)
    after = pt.score_batch(audio)["probs"]
    assert not torch.equal(taps_before, pt._stem_taps)
    assert float((after - before).abs().max()) > 1e-3
    fresh = _port_engine(other, cfg_kw).score_batch(audio)["probs"]
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


def test_unported_options_raise(slice_setup):
    """carry_windows is ported: res8 is no recurrent model, so its scores stay
    as they were, as the JAX engine reads the option for recurrent models
    only; WholeClipEngine is ported and refuses res8 as the JAX one does."""
    variables, audio, _, cfg_kw = slice_setup
    torch.testing.assert_close(_port_engine(variables, cfg_kw, carry_windows=True).score_batch(audio)["probs"],
                               _port_engine(variables, cfg_kw).score_batch(audio)["probs"], rtol=0, atol=0)
    # the int8 trunk is ported: it raises, as the JAX engine does, only without calibration audio or off the
    # fused-trunk scorer
    with pytest.raises(ValueError, match="int8_calibration_audio"):
        _port_engine(variables, cfg_kw, use_int8_trunk=True)
    with pytest.raises(ValueError, match="fused-trunk scorer only"):
        _port_engine(variables, cfg_kw, use_int8_trunk=True, fused_trunk=False, int8_calibration_audio=np.zeros((1, 8000)))
    with pytest.raises(ValueError, match="WholeClipEngine requires a sequential model"):
        WholeClipEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                        EngineConfig(**cfg_kw), FrontendConfig(n_mels=40), device="cpu")
    rng = np.random.default_rng(5)
    for cls, name, kw in ((StreamingEngine, "lstm", {"carry_windows": True}), (WholeClipEngine, "seq-lstm", {})):
        eng = cls(create_model(name, num_labels=4, hidden_size=8),
                  variables_to_state_dict(name, numpy_variables(name, 4, rng, hidden_size=8)), EngineConfig(**cfg_kw),
                  FrontendConfig(n_mels=40), device="cpu", **kw)
        assert eng.spec.name == name and eng.infer_batch(audio[:1, :8000])["detected"].shape == (1,)
    # the threshold sweep is ported: it decides, and at one threshold as infer_batch does
    pt = _port_engine(variables, cfg_kw)
    clip = np.zeros((1, 8000), np.float32)
    np.testing.assert_array_equal(pt.infer_sweep_batch(clip, thresholds=(0.5,))[0],
                                  pt.infer_batch(clip, threshold=0.5)["detected"].numpy())
