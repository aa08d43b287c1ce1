"""The port's scan form of smoothing + FSM and its threshold sweep
(howl_tpu_torch/inference/detect.py) against the JAX package's.

* ``fsm_scan`` and ``detect_step`` against JAX's on random configurations
  (tests/test_detect_fuzz.py's generators, with validity masks, blank
  labels, phone-mode color maps and rings that already hold entries).
* Stepping ``detect_step`` over a sequence decides as the port's parallel
  ``smooth_and_detect`` does, as in the JAX package.
* ``smooth_and_detect_sweep`` equals K single-threshold calls and JAX's
  sweep; the engine's ``detect_sweep_from_scores`` and ``infer_sweep_batch``
  equal JAX's engine's.
Decisions are integers and booleans, so they must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import detect as jdet
from howl_tpu.inference.config import EngineConfig as JaxEngineConfig
from howl_tpu_torch.inference import detect as tdet
from howl_tpu_torch.inference.config import EngineConfig, ring_steps

torch.set_num_threads(1)


def _fuzz_cfg(rng):
    num_labels = int(rng.integers(2, 6))
    seq_len = int(rng.integers(1, min(num_labels, 3) + 1))
    use_blank = bool(rng.random() < 0.3)
    use_colors = bool(rng.random() < 0.3)
    return dict(
        inference_sequence=tuple(rng.permutation(num_labels - 1)[:seq_len].tolist()),
        inference_window_ms=float(rng.choice([250.0, 500.0, 1000.0, 2000.0])),
        smoothing_window_ms=float(rng.choice([0.0, 50.0, 125.0, 300.0])),
        tolerance_window_ms=float(rng.choice([100.0, 250.0, 500.0])),
        inference_threshold=float(rng.choice([0.0, 0.3, 0.6, 0.9])),
        negative_label=num_labels - 1,
        blank_label=num_labels - 1 if use_blank else -1,
        num_labels=num_labels,
        label_color_map=tuple(rng.integers(0, num_labels, num_labels).tolist()) if use_colors else None,
    )


def _probs(rng, *shape):
    x = rng.gamma(0.3, size=shape)
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _assert_state_equal(got: tdet.DetectState, want):
    for name in tdet.DetectState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(12))
def test_fsm_scan_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    kw = _fuzz_cfg(rng)
    b, w = int(rng.integers(1, 6)), int(rng.integers(1, 40))
    stride = float(rng.choice([31.25, 62.5, 125.0]))
    labels = rng.integers(-1, kw["num_labels"], (b, w)).astype(np.int32)
    times = (np.arange(w, dtype=np.float32) * stride)[None].repeat(b, 0)
    times[rng.random((b, w)) < 0.2] = np.float32(-1e30)  # empty slots
    check = np.float32((w - 1) * stride + stride * rng.integers(0, 2))
    args = (kw["inference_sequence"], kw["tolerance_window_ms"], kw["inference_window_ms"])
    want = np.asarray(jdet.fsm_scan(jnp.asarray(labels), jnp.asarray(times), check, *args))
    got = tdet.fsm_scan(torch.from_numpy(labels), torch.from_numpy(times), float(check), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    # a (B,) check time, and the empty sequence
    checks = (times.max(1) + stride).astype(np.float32)
    want = np.asarray(jdet.fsm_scan(jnp.asarray(labels), jnp.asarray(times), jnp.asarray(checks), *args))
    np.testing.assert_array_equal(
        tdet.fsm_scan(torch.from_numpy(labels), torch.from_numpy(times), torch.from_numpy(checks), *args).numpy(), want)
    assert not tdet.fsm_scan(torch.from_numpy(labels), torch.from_numpy(times), 0.0, (), 100.0, 1000.0).any()


@pytest.mark.parametrize("seed", range(12))
def test_detect_step_matches_jax_step_by_step(seed):
    """Both scan forms over the same posteriors, validity and times: equal
    labels, fire flags and states (rings, timestamps, the sticky flag) at
    every step."""
    rng = np.random.default_rng(400 + seed)
    kw = _fuzz_cfg(rng)
    jcfg, tcfg = JaxEngineConfig(**kw), EngineConfig(**kw)
    stride = float(rng.choice([31.25, 62.5, 100.0, 125.0]))
    s_steps, w_steps = ring_steps(tcfg, stride)
    b, t = int(rng.integers(1, 5)), int(rng.integers(5, 40))
    probs = _probs(rng, t, b, kw["num_labels"])
    valid = rng.random((t, b)) > 0.15
    check_offset = float(stride * rng.integers(0, 2))
    js = jdet.init_state(b, kw["num_labels"], s_steps, w_steps)
    ts = tdet.init_state(b, kw["num_labels"], s_steps, w_steps, device="cpu")
    _assert_state_equal(ts, js)
    for k in range(t):
        t_now = np.float32(k * stride)
        js, jlab, jfired = jdet.detect_step(js, jnp.asarray(probs[k]), t_now, jnp.asarray(valid[k]), jcfg, check_offset)
        ts, tlab, tfired = tdet.detect_step(ts, torch.from_numpy(probs[k]), float(t_now), torch.from_numpy(valid[k]),
                                            tcfg, check_offset)
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab), err_msg=f"step {k}")
        np.testing.assert_array_equal(tfired.numpy(), np.asarray(jfired), err_msg=f"step {k}")
        _assert_state_equal(ts, js)


def test_detect_step_takes_a_bool_validity_and_leaves_invalid_streams_alone():
    cfg = EngineConfig(inference_sequence=(0,), negative_label=1, num_labels=2)
    state = tdet.init_state(2, 2, 1, 33, device="cpu")
    probs = torch.tensor([[0.9, 0.1], [0.2, 0.8]])
    new, label, fired = tdet.detect_step(state, probs, 0.0, False, cfg, 62.5)
    assert label.tolist() == [-1, -1] and not fired.any()
    for name in tdet.DetectState._fields:
        assert torch.equal(getattr(new, name), getattr(state, name)), name
    new, label, fired = tdet.detect_step(state, probs, 0.0, True, cfg, 62.5)
    assert label.tolist() == [0, 1] and fired.tolist() == [True, False] and new.fired.tolist() == [True, False]
    # the previous state is not written in place
    assert (state.label_ring == -1).all() and (state.pred_times == tdet.EMPTY_TIME).all()


@pytest.mark.parametrize("seed", range(8))
def test_stepping_detect_step_decides_as_the_parallel_form(seed):
    """The scan form stepped over a sequence and the parallel form on the
    whole of it: the same labels and fire flags (the JAX package holds its
    two forms to each other the same way)."""
    rng = np.random.default_rng(500 + seed)
    kw = _fuzz_cfg(rng)
    cfg = EngineConfig(**kw)
    stride = float(rng.choice([31.25, 62.5, 100.0, 125.0]))
    check_offset_is_stride = bool(rng.random() < 0.5)
    b, t = int(rng.integers(1, 5)), int(rng.integers(5, 60))
    probs = _probs(rng, b, t, kw["num_labels"])
    valid = rng.random((b, t)) > 0.15
    times = np.arange(t, dtype=np.float32) * stride
    par = tdet.smooth_and_detect(torch.from_numpy(probs), times, torch.from_numpy(valid), cfg, check_offset_is_stride)
    _, s_steps, w_steps, _, check_offset = tdet._ring_geometry(times, cfg, check_offset_is_stride)
    state = tdet.init_state(b, kw["num_labels"], s_steps, w_steps, device="cpu")
    labels, fired = [], []
    for k in range(t):
        state, lab, f = tdet.detect_step(state, torch.from_numpy(probs[:, k]), float(times[k]),
                                         torch.from_numpy(valid[:, k]), cfg, check_offset)
        labels.append(lab)
        fired.append(f)
    np.testing.assert_array_equal(torch.stack(labels, 1).numpy(), par["labels"].numpy())
    np.testing.assert_array_equal(torch.stack(fired, 1).numpy(), par["fired"].numpy())
    np.testing.assert_array_equal(state.fired.numpy(), par["detected"].numpy())


@pytest.mark.parametrize("seed", range(8))
def test_sweep_equals_single_thresholds_and_jax(seed):
    rng = np.random.default_rng(600 + seed)
    kw = _fuzz_cfg(rng)
    cfg, jcfg = EngineConfig(**kw), JaxEngineConfig(**kw)
    stride = float(rng.choice([31.25, 62.5, 125.0]))
    b, t = int(rng.integers(1, 5)), int(rng.integers(5, 50))
    probs = _probs(rng, b, t, kw["num_labels"])
    valid = rng.random((b, t)) > 0.15
    times = np.arange(t, dtype=np.float32) * stride
    thresholds = np.array([0.0, 0.25, 0.5, 0.75, 0.95], np.float32)
    offset = bool(rng.random() < 0.5)
    sweep = tdet.smooth_and_detect_sweep(torch.from_numpy(probs), times, torch.from_numpy(valid), thresholds, cfg, offset)
    jsweep = jdet.smooth_and_detect_sweep(probs, times, valid, thresholds, jcfg, offset)
    for key in ("labels", "fired", "detected", "first_fire_step"):
        assert tuple(sweep[key].shape[:2]) == (len(thresholds), b), key
        np.testing.assert_array_equal(sweep[key].numpy(), np.asarray(jsweep[key]), err_msg=key)
        for i, thr in enumerate(thresholds):
            one = tdet.smooth_and_detect(torch.from_numpy(probs), times, torch.from_numpy(valid),
                                         dataclasses.replace(cfg, inference_threshold=float(thr)), offset)
            np.testing.assert_array_equal(sweep[key][i].numpy(), one[key].numpy(), err_msg=f"{key} at {thr}")


def test_engine_sweeps_match_jax():
    """``detect_sweep_from_scores`` and ``infer_sweep_batch`` of the port's
    engine against the JAX engine's on the same weights and audio (4 clips
    of 2 s, one shorter than its buffer), float32."""
    import jax

    from howl_tpu.inference import StreamingEngine as JaxStreamingEngine
    from howl_tpu.models import create_model as jax_create_model
    from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    kw = dict(inference_sequence=(0,), max_window_size_ms=500.0, eval_stride_size_ms=62.5, negative_label=3,
              num_labels=4, sample_rate=16000)
    variables = jax_create_model("res8", num_labels=4).init(
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((1, 1, 40, 41)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((4, 32000)) * np.array([[0.5], [0.05], [0.2], [0.01]])).astype(np.float32)
    lengths = np.array([32000, 30000, 20000, 32000], np.int32)
    jx = JaxStreamingEngine(jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**kw),
                            JaxFrontendConfig(n_mels=40), -6.0, 4.0, use_pallas_stem=True)
    pt = StreamingEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                         EngineConfig(**kw), FrontendConfig(n_mels=40), -6.0, 4.0, frontend_precision="auto",
                         device="cpu")
    peaks = np.asarray(jx.score_batch(audio, lengths)["probs"])[..., 0].max(-1)
    thresholds = np.concatenate([[0.0], np.sort(peaks) - 1e-3, [1.0]]).astype(np.float32)
    want = jx.detect_sweep_from_scores(jx.score_batch(audio, lengths), thresholds)
    got = pt.detect_sweep_from_scores(pt.score_batch(audio, lengths), thresholds)
    for key in ("labels", "fired", "detected", "first_fire_step"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    detected = pt.infer_sweep_batch(audio, lengths, thresholds)
    assert isinstance(detected, np.ndarray) and detected.shape == (len(thresholds), 4)
    np.testing.assert_array_equal(detected, np.asarray(jx.infer_sweep_batch(audio, lengths, thresholds)))
    assert detected[0].all() and not detected[-1].any()  # the sweep spans firing and silence
