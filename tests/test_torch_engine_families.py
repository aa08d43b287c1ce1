"""The port's offline engines for the zoo's other families against the JAX
package's: ``StreamingEngine`` (the per-window mega-batch, and
``carry_windows`` for lstm and gru) and ``WholeClipEngine`` (seq-lstm,
seq-cnn), on the same weights and audio, at 4 clips of 1.5 s, 40 mels, 0.4 s
windows (41 frames) every 60 ms.

The weights are seeded numpy weights (``compat.numpy_variables``) at
``tests/test_torch_models.py``'s narrow widths, loaded by the JAX engine as
they are and by the port's through ``compat.variables_to_state_dict``; the
clips are the decision gate's ``family_audio`` (loud and quiet kinds, each
repeating with the hop). The first kernel gain of ``GAINS`` and seed whose
JAX posteriors admit a word and threshold under which some clips fire and
some do not, every decision 0.01 from flipping
(``validate_tpu_decisions.margin_word_threshold`` without halves), is
taken.

Both sides run float32 with the exact frontend: the JAX engine's jnp chain
at HIGHEST, the port's frontend kernel's plain version at "f32" (its
stacked chain for las). Tolerances: posteriors atol 1e-4; decisions
(detections, first-fire steps, per-step labels and fire flags) equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference import StreamingEngine as JaxStreamingEngine
from howl_tpu.inference.engine import WholeClipEngine as JaxWholeClipEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.models.base import model_spec as jax_model_spec
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import numpy_variables, variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig, StreamingEngine, WholeClipEngine
from howl_tpu_torch.inference.engine import WINDOW_CHUNK
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.tools.validate_tpu_decisions import family_audio, margin_word_threshold
from tests.test_torch_models import FAMILY_KW, PORT_KW, jax_family_variables

torch.set_num_threads(1)

SR = 16000
ZMUV = (-6.0, 4.0)
BASE = dict(inference_sequence=(0, 1, 2), max_window_size_ms=400.0, eval_stride_size_ms=62.5,
            negative_label=3, num_labels=4, sample_rate=SR)
DECISIONS = ("labels", "fired", "detected", "first_fire_step")
# (family, carry_windows): every family, lstm and gru also with their state carried across windows
CASES = [("small-cnn", False), ("mobilenet", False), ("lstm", False), ("lstm", True), ("gru", False),
         ("gru", True), ("las", False), ("seq-lstm", False), ("seq-cnn", False)]
MARGIN = 0.01
GAINS = (1.0, 1.1, 1.2, 1.3, 2**0.5, 2.0)  # kernel standard deviations in units of flax's lecun-normal


def _audio(seed, batch=4, samples=24000):
    return family_audio(batch, samples, seed)


def _engines(name, variables, cfg_kw, carry_windows=False):
    sequential = jax_model_spec(name).is_sequential
    jax_cls, port_cls = (JaxWholeClipEngine, WholeClipEngine) if sequential else (JaxStreamingEngine, StreamingEngine)
    jax_eng = jax_cls(jax_create_model(name, num_labels=4, **FAMILY_KW[name]), variables, JaxEngineConfig(**cfg_kw),
                      JaxFrontendConfig(n_mels=40), *ZMUV, spec=jax_model_spec(name), carry_windows=carry_windows)
    port_eng = port_cls(create_model(name, num_labels=4, **FAMILY_KW[name], **PORT_KW.get(name, {})),
                        variables_to_state_dict(name, variables), EngineConfig(**cfg_kw), FrontendConfig(n_mels=40),
                        *ZMUV, carry_windows=carry_windows, device="cpu")
    return jax_eng, port_eng


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}{'-carry' if c else ''}" for n, c in CASES])
def case(request):
    """(name, carry_windows, variables, audio, lengths, cfg_kw, jax engine,
    port engine), the word and threshold picked from the JAX posteriors."""
    name, carry = request.param
    audio = _audio(61)
    for gain, seed in ((g, s) for g in GAINS for s in range(3)):
        variables = numpy_variables(name, 4, np.random.default_rng(seed), kernel_gain=gain, **FAMILY_KW[name],
                                    **PORT_KW.get(name, {}))
        probs = np.asarray(_engines(name, variables, BASE, carry)[0].score_batch(audio)["probs"])  # (B, T, L)
        try:
            pick = margin_word_threshold(probs.transpose(1, 0, 2), MARGIN, halves=False)
            break
        except ValueError:
            continue
    word = pick["word"]
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4, inference_threshold=pick["threshold"])
    lengths = np.array([24000, 19000, 24000, 17500], np.int32)
    return (name, carry, variables, audio, lengths, cfg_kw, *_engines(name, variables, cfg_kw, carry))


def _assert_decisions_equal(got, want):
    for key in DECISIONS:
        np.testing.assert_array_equal(got[key].cpu().numpy(), np.asarray(want[key]), err_msg=key)


def test_infer_batch_matches_jax(case):
    name, _, _, audio, _, _, jax_eng, port_eng = case
    want, got = jax_eng.infer_batch(audio), port_eng.infer_batch(audio)
    assert got["probs"].shape == want["probs"].shape and torch.isfinite(got["probs"]).all()
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)
    np.testing.assert_allclose(got["times_ms"], want["times_ms"], rtol=1e-6)
    assert 0 < int(got["detected"].sum()) < len(audio), name  # some clips fire, some do not


def test_lengths_mask_the_same_steps(case):
    _, _, _, audio, lengths, _, jax_eng, port_eng = case
    want, got = jax_eng.infer_batch(audio, lengths), port_eng.infer_batch(audio, lengths)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)


def test_score_batch_and_detect_from_scores_match_jax(case):
    _, _, _, audio, lengths, _, jax_eng, port_eng = case
    scores_j, scores_t = jax_eng.score_batch(audio, lengths), port_eng.score_batch(audio, lengths)
    np.testing.assert_array_equal(scores_t["valid"].numpy(), np.asarray(scores_j["valid"]))
    np.testing.assert_allclose(scores_t["times_ms"], scores_j["times_ms"], rtol=1e-6)
    assert scores_t["check_offset_is_stride"] == scores_j["check_offset_is_stride"]
    np.testing.assert_allclose(scores_t["probs"].numpy(), np.asarray(scores_j["probs"]), atol=1e-4)
    _assert_decisions_equal(port_eng.detect_from_scores(scores_t), jax_eng.detect_from_scores(scores_j))
    np.testing.assert_array_equal(port_eng.infer_sweep_batch(audio, lengths, thresholds=(0.2, 0.9)),
                                  np.asarray(jax_eng.infer_sweep_batch(audio, lengths, thresholds=(0.2, 0.9))))


def test_a_clip_shorter_than_one_window(case):
    """Padded to one window, it never fires (static and recurrent models); a
    sequential model scores its frames as they are."""
    _, _, _, audio, _, _, jax_eng, port_eng = case
    short = audio[:, :4000]
    want, got = jax_eng.infer_batch(short), port_eng.infer_batch(short)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    _assert_decisions_equal(got, want)
    if not port_eng.spec.is_sequential:
        assert not got["detected"].any()


def test_carry_windows_changes_only_recurrent_scores(case):
    """With carry_windows a recurrent model's state runs on from window to
    window: its first window's scores are the stateless mega-batch's, the
    later ones differ (by little: a window of 41 frames forgets most of its
    initial state). The engines read the option for recurrent window
    models only, as the JAX engine does: other models, seq-lstm's whole
    clip too, score the same bit for bit."""
    name, carry, variables, audio, _, cfg_kw, _, port_eng = case
    stateless = _engines(name, variables, cfg_kw)[1] if carry else port_eng
    carried = port_eng if carry else _engines(name, variables, cfg_kw, carry_windows=True)[1]
    a, b = stateless.score_batch(audio)["probs"], carried.score_batch(audio)["probs"]
    if not port_eng.spec.is_recurrent or port_eng.spec.is_sequential:
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        return
    torch.testing.assert_close(b[:, 0], a[:, 0], rtol=0, atol=1e-6)
    assert float((b[:, 1:] - a[:, 1:]).abs().max()) > 0


def test_the_mega_batch_is_chunked_for_models_without_a_trunk(case, monkeypatch):
    """Scoring in chunks of 7 windows gives the one-batch posteriors."""
    name, carry, _, audio, _, _, _, port_eng = case
    whole = port_eng.score_batch(audio)["probs"]
    calls = []
    forward = port_eng.model.forward
    monkeypatch.setattr(port_eng.model, "forward", lambda *a, **k: calls.append(a[0].shape[0]) or forward(*a, **k))
    monkeypatch.setattr("howl_tpu_torch.inference.engine.WINDOW_CHUNK", 7)
    torch.testing.assert_close(port_eng.score_batch(audio)["probs"], whole, rtol=0, atol=1e-6)
    if port_eng.spec.is_sequential:
        assert calls == [4]
    elif carry:
        assert calls == [4] * whole.shape[1]
    else:
        assert calls == [7] * (4 * whole.shape[1] // 7) + ([4 * whole.shape[1] % 7] if 4 * whole.shape[1] % 7 else [])
    assert WINDOW_CHUNK >= 8192


def test_whole_clip_engine_refuses_static_models_and_skips_blank_frames():
    variables = jax_family_variables("seq-lstm", 70)
    cfg_kw = dict(BASE, inference_threshold=0.3)
    with pytest.raises(ValueError, match="sequential model"):
        WholeClipEngine(create_model("lstm", num_labels=4, **FAMILY_KW["lstm"]),
                        variables_to_state_dict("lstm", jax_family_variables("lstm", 71)), EngineConfig(**cfg_kw),
                        FrontendConfig(n_mels=40), device="cpu")
    audio = _audio(72)
    for blank in (-1, 2):
        kw = dataclasses.replace(EngineConfig(**cfg_kw), blank_label=blank)
        jax_eng = JaxWholeClipEngine(jax_create_model("seq-lstm", num_labels=4, **FAMILY_KW["seq-lstm"]), variables,
                                     JaxEngineConfig(**{**cfg_kw, "blank_label": blank}), JaxFrontendConfig(n_mels=40),
                                     *ZMUV, spec=jax_model_spec("seq-lstm"))
        port_eng = WholeClipEngine(create_model("seq-lstm", num_labels=4, **FAMILY_KW["seq-lstm"]),
                                   variables_to_state_dict("seq-lstm", variables), kw, FrontendConfig(n_mels=40), *ZMUV,
                                   device="cpu")
        want, got = jax_eng.infer_batch(audio), port_eng.infer_batch(audio)
        _assert_decisions_equal(got, want)
        if blank >= 0:
            skipped = (np.asarray(want["probs"]).argmax(-1) == blank)
            assert skipped.any() and (got["labels"].numpy()[skipped] == -1).all()


def test_bf16_engine_casts_the_weights_and_scores_in_bf16():
    """The bf16 engine serves every family on weights cast to bf16 (the JAX
    engine's cast); its posteriors are float32 and close to float32's."""
    name = "gru"
    variables = jax_family_variables(name, 73)
    state = variables_to_state_dict(name, variables)
    audio = _audio(74)
    engines = [StreamingEngine(create_model(name, num_labels=4, **FAMILY_KW[name]), state, EngineConfig(**BASE),
                               FrontendConfig(n_mels=40), *ZMUV, compute_dtype=dtype, device="cpu")
               for dtype in (None, torch.bfloat16)]
    assert engines[1].model.lstm_encoder.weight_ih_l0.dtype == torch.bfloat16
    f32, bf16 = (eng.score_batch(audio)["probs"] for eng in engines)
    assert bf16.dtype == torch.float32
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=3e-2)
