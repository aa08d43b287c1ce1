"""The port's scalar oracle (howl_tpu_torch/inference/oracle.py) against
howl_tpu's, and the port's batched decisions against it.

* ``OracleEngine`` gives JAX's labels and fire flags on seeded posterior
  streams over random engine configurations (tests/test_detect_fuzz.py's
  generators, with validity masks, blank labels and phone-mode color maps).
* Stepping the port's ``detect_step`` (whose FSM is ``fsm_scan``) over each
  stream, with the rings ``smooth_and_detect`` sizes, gives the oracle's
  labels and its first fire; the parallel ``smooth_and_detect`` gives its
  labels and detection, as tests/test_detect_fuzz.py holds the JAX engine.
Decisions are integers and booleans, so they must be equal.
"""

import numpy as np
import pytest
import torch

from howl_tpu.inference.config import EngineConfig as JaxEngineConfig
from howl_tpu.inference.oracle import OracleEngine as JaxOracle
from howl_tpu_torch.inference import detect as tdet
from howl_tpu_torch.inference.config import EngineConfig
from howl_tpu_torch.inference.oracle import OracleEngine
from tests.test_torch_detect_scan import _fuzz_cfg, _probs

torch.set_num_threads(1)


def _case(seed):
    rng = np.random.default_rng(700 + seed)
    kw = _fuzz_cfg(rng)
    stride = float(rng.choice([31.25, 62.5, 100.0, 125.0]))
    b, t = int(rng.integers(1, 5)), int(rng.integers(5, 60))
    probs = _probs(rng, b, t, kw["num_labels"])
    valid = rng.random((b, t)) > 0.15
    times = np.arange(t, dtype=np.float32) * stride
    return kw, probs, valid, times, bool(rng.random() < 0.5)


@pytest.mark.parametrize("seed", range(12))
def test_oracle_matches_jax(seed):
    kw, probs, valid, times, offset = _case(seed)
    for i in range(probs.shape[0]):
        labels, fired = OracleEngine(EngineConfig(**kw)).run(probs[i], times, valid[i], offset)
        jlabels, jfired = JaxOracle(JaxEngineConfig(**kw)).run(probs[i], times, valid[i], offset)
        np.testing.assert_array_equal(labels, jlabels)
        np.testing.assert_array_equal(fired, jfired)
    # the oracle's own state between calls: reset, an empty sequence never fires
    oracle = OracleEngine(EngineConfig(**{**kw, "inference_sequence": ()}))
    assert not oracle.run(probs[0], times, valid[0], offset)[1].any()
    oracle.reset()
    assert oracle.pred_history == [] and oracle.label_history == [] and oracle.curr_time == 0.0


@pytest.mark.parametrize("seed", range(12))
def test_port_decisions_match_the_oracle(seed):
    kw, probs, valid, times, offset = _case(seed)
    cfg = EngineConfig(**kw)
    b, t = valid.shape
    par = tdet.smooth_and_detect(torch.from_numpy(probs), times, torch.from_numpy(valid), cfg, offset)
    _, s_steps, w_steps, _, check_offset = tdet._ring_geometry(times, cfg, offset)
    state = tdet.init_state(b, kw["num_labels"], s_steps, w_steps, device="cpu")
    labels, fired = [], []
    for k in range(t):
        state, lab, f = tdet.detect_step(state, torch.from_numpy(probs[:, k]), float(times[k]),
                                         torch.from_numpy(valid[:, k]), cfg, check_offset)
        labels.append(lab)
        fired.append(f)
    labels, fired = torch.stack(labels, 1).numpy(), torch.stack(fired, 1).numpy()
    for i in range(b):
        o_labels, o_fired = OracleEngine(cfg).run(probs[i], times, valid[i], offset)
        np.testing.assert_array_equal(labels[i], o_labels, err_msg=f"stream {i}")
        np.testing.assert_array_equal(par["labels"][i].numpy(), o_labels, err_msg=f"stream {i}")
        first = np.flatnonzero(fired[i])
        assert (first[0] if len(first) else -1) == (np.flatnonzero(o_fired)[0] if o_fired.any() else -1)
        assert bool(state.fired[i]) == bool(par["detected"][i]) == bool(o_fired.any())
