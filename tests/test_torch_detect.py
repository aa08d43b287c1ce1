"""The port's smoothing + FSM (howl_tpu_torch/inference/detect.py) vs the JAX
parallel form on random posteriors, with tests/test_detect_fuzz.py's
generators plus validity masks, blank labels, phone-mode color maps and
inference weights. Decisions are integers and booleans: they must be
exactly equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from howl_tpu.inference import detect as jdet
from howl_tpu.inference.config import EngineConfig as JaxEngineConfig
from howl_tpu_torch.inference import detect as tdet
from howl_tpu_torch.inference.config import EngineConfig, hop_geometry, ring_steps
from howl_tpu_torch.ops.frontend import FrontendConfig

torch.set_num_threads(1)


def _fuzz_case(seed):
    rng = np.random.default_rng(100 + seed)
    num_labels = int(rng.integers(2, 6))
    seq_len = int(rng.integers(1, min(num_labels, 3) + 1))
    sequence = tuple(rng.permutation(num_labels - 1)[:seq_len].tolist())
    stride = float(rng.choice([31.25, 62.5, 100.0, 125.0]))
    use_blank = bool(rng.random() < 0.3)
    use_colors = bool(rng.random() < 0.3)
    use_weights = bool(rng.random() < 0.4)
    kwargs = dict(
        inference_sequence=sequence,
        inference_window_ms=float(rng.choice([250.0, 500.0, 1000.0, 2000.0])),
        smoothing_window_ms=float(rng.choice([0.0, 50.0, 125.0, 300.0])),
        tolerance_window_ms=float(rng.choice([100.0, 250.0, 500.0])),
        inference_threshold=float(rng.choice([0.0, 0.3, 0.6, 0.9])),
        negative_label=num_labels - 1,
        blank_label=num_labels - 1 if use_blank else -1,
        num_labels=num_labels,
        label_color_map=tuple(rng.integers(0, num_labels, num_labels).tolist()) if use_colors else None,
        inference_weights=tuple(rng.uniform(0.5, 2.0, num_labels - 1).tolist()) if use_weights else None,
    )
    b, t = int(rng.integers(1, 5)), int(rng.integers(5, 60))
    x = rng.gamma(0.3, size=(b, t, num_labels))
    probs = (x / x.sum(-1, keepdims=True)).astype(np.float32)
    valid = rng.random((b, t)) > 0.15
    times = np.arange(t, dtype=np.float32) * stride
    check_offset = bool(rng.random() < 0.5)
    return kwargs, probs, valid, times, check_offset


@pytest.mark.parametrize("seed", range(24))
def test_smooth_and_detect_matches_jax(seed):
    kwargs, probs, valid, times, check_offset = _fuzz_case(seed)
    jcfg, tcfg = JaxEngineConfig(**kwargs), EngineConfig(**kwargs)
    jprobs = np.array(jdet.apply_inference_weights(probs, jcfg))
    tprobs = tdet.apply_inference_weights(torch.from_numpy(probs), tcfg)
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=1e-6, atol=1e-7)
    # identical posteriors into both decision paths: decisions must be equal
    want = jdet.smooth_and_detect(jprobs, times, valid, jcfg, check_offset_is_stride=check_offset)
    got = tdet.smooth_and_detect(
        torch.from_numpy(jprobs), times, torch.from_numpy(valid), tcfg, check_offset_is_stride=check_offset
    )
    for key in ("labels", "fired", "detected", "first_fire_step"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=f"{key} seed={seed} {kwargs}")


@pytest.mark.parametrize("threshold", [0.0, 0.45, 0.8])
def test_fsm_sentinels_and_long_sequences(threshold):
    """A three-word walk over a long clip with gaps: the -1e30 "no match yet"
    sentinel and the -inf invalid posteriors both stay in float32."""
    rng = np.random.default_rng(7)
    kwargs = dict(
        inference_sequence=(0, 1, 2), inference_window_ms=2000.0, smoothing_window_ms=50.0,
        tolerance_window_ms=500.0, inference_threshold=threshold, negative_label=3, num_labels=4,
    )
    t = 160
    labels = np.repeat(rng.integers(0, 4, t // 8), 8)
    probs = np.full((3, t, 4), 0.1, np.float32)
    probs[:, np.arange(t), labels] = 0.7
    valid = np.ones((3, t), bool)
    valid[1, 40:90] = False
    valid[2] = False
    times = np.arange(t, dtype=np.float32) * 62.5
    want = jdet.smooth_and_detect(probs, times, valid, JaxEngineConfig(**kwargs))
    got = tdet.smooth_and_detect(torch.from_numpy(probs), times, torch.from_numpy(valid), EngineConfig(**kwargs))
    for key in ("labels", "fired", "detected", "first_fire_step"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert not bool(got["detected"][2]) and int(got["first_fire_step"][2]) == t


def test_ring_and_hop_geometry_match_jax():
    from howl_tpu.inference.config import hop_geometry as jax_hop_geometry
    from howl_tpu.inference.config import ring_steps as jax_ring_steps
    from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig

    for stride_ms, window_ms in ((62.5, 500.0), (63.0, 750.0), (100.0, 1000.0)):
        kwargs = dict(eval_stride_size_ms=stride_ms, max_window_size_ms=window_ms)
        tcfg, jcfg = EngineConfig(**kwargs), JaxEngineConfig(**kwargs)
        for center in (True, False):
            geom = hop_geometry(tcfg, FrontendConfig(center=center))
            assert geom == jax_hop_geometry(jcfg, JaxFrontendConfig(center=center))
            assert ring_steps(tcfg, geom[2]) == jax_ring_steps(jcfg, geom[2])
        times = np.arange(9, dtype=np.float32) * stride_ms
        for offset in (True, False):
            t_geom = tdet._ring_geometry(times, tcfg, offset)
            j_geom = jdet._ring_geometry(times, jcfg, offset)
            assert t_geom[1:] == j_geom[1:]
            assert dataclasses.asdict(t_geom[0]) == dataclasses.asdict(j_geom[0])
    w = EngineConfig(num_labels=4, inference_weights=(2.0,)).padded_weights()
    np.testing.assert_array_equal(w, JaxEngineConfig(num_labels=4, inference_weights=(2.0,)).padded_weights())
