"""The per-window mega-batch scorer: the port's StreamingEngine(fused_trunk=
False) vs the JAX StreamingEngine(fused_trunk=False) on the same seeded
weights and audio, at B=4 clips of 2 s, 40 mels, bench.py's EngineConfig
geometry (500 ms windows of 41 frames every 5 frames: 25 windows a clip).

Both engines run the same frontend grade: the port's
``frontend_precision="auto"`` against the JAX XLA chain's
``dft_precision="auto"``, exact float32 for float32 scoring and the 1-pass
"bf16" grade with bf16 features for bf16 scoring. Every window goes through
the whole res8 as one batch: the JAX stem is XLA's conv, the port's the stem
kernel's plain version.

The word label and threshold are picked from the float32 JAX posteriors so
that some clips fire and some do not, and the tests assert that they do.
Tolerances: float32 posteriors 1e-4; bf16 posteriors 2e-2; decisions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference import StreamingEngine as JaxStreamingEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.models.base import model_spec as jax_model_spec
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig, StreamingEngine
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.frontend import FrontendConfig
from tests.test_torch_engine import BASE, DECISIONS, SR, ZMUV, _audio, _variables

torch.set_num_threads(1)


def _jax_legacy(variables, cfg_kw, compute_dtype=None):
    return JaxStreamingEngine(
        jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw), JaxFrontendConfig(n_mels=40),
        *ZMUV, spec=jax_model_spec("res8"), compute_dtype=compute_dtype, fused_trunk=False, dft_precision="auto",
    )


def _port_legacy(variables, cfg_kw, compute_dtype=None):
    return StreamingEngine(
        create_model("res8", num_labels=4), res8_variables_to_state_dict(variables), EngineConfig(**cfg_kw),
        FrontendConfig(n_mels=40), *ZMUV, compute_dtype=compute_dtype, fused_trunk=False,
        frontend_precision="auto", device="cpu",
    )


@pytest.fixture(scope="module")
def legacy_setup():
    variables = _variables(41)
    audio = _audio(42)
    probe = np.asarray(_jax_legacy(variables, BASE).score_batch(audio)["probs"])
    half = probe.shape[0] // 2
    word = int(np.bincount(probe[:half].argmax(-1).ravel(), minlength=4).argmax())
    peak = probe.max(-1).max(-1)
    quiet, loud = float(peak[half:].max()), float(peak[:half].min())
    assert loud - quiet > 0.05, "the probe batch does not split: no threshold separates the clips"
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4,
                  inference_threshold=(quiet + loud) / 2)
    return variables, audio, cfg_kw


def _assert_decisions_equal(got, want):
    for key in DECISIONS:
        np.testing.assert_array_equal(got[key].cpu().numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype,atol", [(None, 1e-4), ("bf16", 2e-2)], ids=["f32", "bf16"])
def test_legacy_engine_matches_jax(legacy_setup, dtype, atol):
    variables, audio, cfg_kw = legacy_setup
    jx = _jax_legacy(variables, cfg_kw, jnp.bfloat16 if dtype else None)
    pt = _port_legacy(variables, cfg_kw, torch.bfloat16 if dtype else None)
    assert not pt.fused_trunk and pt.frontend_precision == ("bf16" if dtype else None)
    want, got = jx.infer_batch(audio), pt.infer_batch(audio)
    assert tuple(got["probs"].shape) == (4, 25, 4) and got["probs"].dtype == torch.float32
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=atol)
    _assert_decisions_equal(got, want)
    np.testing.assert_array_equal(got["times_ms"], want["times_ms"])
    detected = got["detected"].numpy()
    assert detected.any() and not detected.all(), f"need some clips to fire and some not: {detected}"


def test_legacy_engine_masks_windows_past_the_lengths(legacy_setup):
    variables, audio, cfg_kw = legacy_setup
    lengths = np.array([2 * SR, 21000, 2 * SR - 3000, 9000], np.int32)
    jx, pt = _jax_legacy(variables, cfg_kw), _port_legacy(variables, cfg_kw)
    want, got = jx.infer_batch(audio, lengths), pt.infer_batch(audio, lengths)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)
    scores_j, scores_t = jx.score_batch(audio, lengths), pt.score_batch(audio, lengths)
    valid = scores_t["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(scores_j["valid"]))
    assert valid[0].all() and not valid[1].all() and valid[3].sum() == 2
    for thr in (None, 0.0, cfg_kw["inference_threshold"] + 0.05):
        _assert_decisions_equal(pt.detect_from_scores(scores_t, thr), jx.detect_from_scores(scores_j, thr))


def test_legacy_engine_scores_no_valid_window_on_a_short_clip(legacy_setup):
    """A clip shorter than one window is padded so the gather stays inside
    it, every window is masked invalid and nothing fires."""
    variables, _, cfg_kw = legacy_setup
    clips = _audio(43, batch=2, samples=7999)
    want = _jax_legacy(variables, cfg_kw).infer_batch(clips)
    pt = _port_legacy(variables, cfg_kw)
    got = pt.infer_batch(clips)
    assert pt.n_windows(7999) == 1 and tuple(got["probs"].shape) == (2, 1, 4)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)
    assert not got["detected"].any() and (got["labels"] == -1).all()
    assert not pt.score_batch(clips, np.full(2, 7999))["valid"].any()


def test_legacy_engine_scores_past_the_stem_grid_in_chunks(legacy_setup, monkeypatch):
    """Every window goes through the model as one batch: the stem kernel's
    grid no longer caps the clips of a launch, so the scorer no longer
    splits its windows into chunks of 65,535 (the name is the test's
    earlier claim); the posteriors are the per-clip scorer's."""
    variables, audio, cfg_kw = legacy_setup
    pt = _port_legacy(variables, cfg_kw)
    batches = []
    forward = pt.model.forward
    monkeypatch.setattr(pt.model, "forward", lambda x, *a: batches.append(x.shape[0]) or forward(x, *a))
    whole = pt.score_batch(audio)["probs"]
    assert batches == [4 * 25]
    per_clip = torch.cat([pt.score_batch(audio[i : i + 1])["probs"] for i in range(4)])
    torch.testing.assert_close(whole, per_clip, rtol=0, atol=1e-6)
