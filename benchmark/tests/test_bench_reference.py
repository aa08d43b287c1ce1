"""The plain reference against the program at small sizes on the CPU, both
in float32: the reference follows what the configuration runs. (The chip
compares the program's bf16 path with it at the cells' sizes; these pin that
the two are the same function.)"""

import numpy as np
import pytest
import torch
from bench_tiny import SEED

from benchmark import harness, port
from benchmark.reference import detect, logmel

AUDIO = {"std": 0.1, "segment_ms": 250, "min_db": -40, "tone_share": 1.0, "tone_hz": [100, 4000]}
CPU = torch.device("cpu")


def _setup(name: str, seconds: float = 4.0, recordings: int = 3):
    cfg = harness.load_config(name)
    c = cfg.data
    w = harness.make_weights(port.state_shapes(cfg.module.model(c)), SEED, CPU)
    cfg.module.fit_weights(c, w, harness.make_audio((4, 32000), SEED + 1, AUDIO, 16000, CPU))
    audio = harness.make_audio((recordings, int(seconds * 16000)), SEED + 2, AUDIO, 16000, CPU)
    return cfg, c, w, audio


def _offline_engine(cfg, w, calibration=None, **kw):
    from howl_tpu_torch.inference import StreamingEngine

    c = cfg.data
    return StreamingEngine(cfg.module.model(c), w, port.engine_config(c), port.frontend_config(c), 0.0, 1.0,
                           frontend_precision="f32", device="cpu", int8_calibration_audio=calibration, **kw)


def test_log_mels_match_the_programs_float32_chain():
    from howl_tpu_torch.ops.frontend import log_mel_spectrogram

    for name in ("res8-hey-ff", "mobilenet-hey-ff"):
        cfg, c, _, audio = _setup(name)
        ref = logmel.log_mels(audio, c["audio"])
        got = log_mel_spectrogram(audio, port.frontend_config(c))
        assert ref.shape == got.shape
        # float32 DFT by products against torch.stft: the log magnifies the rounding of tiny powers only
        assert float((ref - got).abs().max()) < 2e-3


@pytest.mark.parametrize("int8", [False, True])
def test_res8_offline_scorer(int8):
    cfg, c, w, audio = _setup("res8-hey-ff")
    n = (audio.shape[1] // 200 + 1 - 41) // 5 + 1
    calib = audio[:2] if int8 else None
    eng = _offline_engine(cfg, w, calib, fused_trunk=True, use_int8_trunk=int8)
    got = eng.infer_batch(audio)["probs"]
    if int8:
        ref = cfg.module.reference(c, w, "offline", audio, n, calib)
    else:
        ref = cfg.module.reference({**c, "precision": {**c["precision"], "offline_trunk": "bfloat16"}}, w,
                                   "offline", audio, n)
    d = (got - ref).abs()
    if int8:
        # float32 rounding in both, but a float32 difference can move an activation across a quantisation step,
        # one level of 127, at a few positions: the windows that hold one move by up to ~1e-2, the rest not at all
        assert float(d.median()) < 1e-6 and float(d.max()) < 1e-2
    else:
        assert float(d.max()) < 1e-4


def test_res8_live_trunk_engine():
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine

    cfg, c, w, audio = _setup("res8-hey-ff", seconds=2.0, recordings=3)
    eng = FusedStreamingOnlineEngine(cfg.module.model(c), w, port.engine_config(c), port.frontend_config(c), 0.0, 1.0,
                                     num_streams=3, device="cpu")
    hops = audio.shape[1] // 1000
    probs = []
    for j in range(hops):
        eng.push(audio[:, j * 1000 : (j + 1) * 1000])
        probs.append(eng.last_probs.clone())
    lag = eng.schedule.lag
    stream = torch.cat([torch.zeros((3, cfg.module.preroll_samples(c))), audio[:, : hops * 1000]], dim=1)
    ref = cfg.module.reference(c, w, "live", stream, hops - lag + 1)
    got = torch.stack(probs[lag - 1 :], dim=1)
    assert float((got - ref).abs().max()) < 1e-4


def test_mobilenet_offline_scorer():
    cfg, c, w, audio = _setup("mobilenet-hey-ff", seconds=2.0)
    n = (audio.shape[1] // 200 + 1 - 61) // 5 + 1
    got = _offline_engine(cfg, w).infer_batch(audio)["probs"]
    ref = cfg.module.reference(c, w, "offline", audio, n)
    # 52 layers of float32 rounding, each a relative 1e-7, through a network that magnifies them
    assert float((got - ref).abs().max()) < 1e-3


def test_mobilenet_online_engine():
    from howl_tpu_torch.inference.online import OnlineEngine

    cfg, c, w, audio = _setup("mobilenet-hey-ff", seconds=0.75, recordings=4)
    eng = OnlineEngine(cfg.module.model(c), w, port.engine_config(c), port.frontend_config(c), 0.0, 1.0, num_streams=4,
                       dft_precision="f32", device="cpu")
    posteriors, lag = cfg.module.live_posteriors(eng)
    eng.ingest(audio)
    ref = cfg.module.reference(c, w, "live", audio, 1)[:, 0]
    assert lag == 0 and float((posteriors() - ref).abs().max()) < 1e-3


def _cfg():
    return harness.load_config("res8-hey-ff").data


def test_decision_rule_matches_the_programs_parallel_form():
    from howl_tpu_torch.inference.detect import smooth_and_detect

    c = _cfg()
    rng = np.random.default_rng(SEED)
    probs = torch.from_numpy(rng.dirichlet(np.full(4, 0.3), size=(16, 300)).astype(np.float32))
    valid = torch.ones(probs.shape[:2], dtype=torch.bool)
    ref = detect.decide(probs, valid, c["engine"], 62.5)
    got = smooth_and_detect(probs, np.arange(300) * 62.5, valid, port.engine_config(c))
    assert int(ref["fired"].sum()) > 0
    for key in ("labels", "fired", "detected", "first_fire_step"):
        assert torch.equal(ref[key].long(), got[key].long()), key


def test_decision_rule_matches_the_programs_scan_form():
    """The live engines' ``detect_step``, hop by hop, with the first hops
    invalid as the trunk engine pushes them before its first window."""
    from howl_tpu_torch.inference.detect import detect_step, init_state

    c = _cfg()
    cfg = port.engine_config(c)
    rng = np.random.default_rng(SEED + 1)
    probs = torch.from_numpy(rng.dirichlet(np.full(4, 0.3), size=(16, 200)).astype(np.float32))
    lag = 4
    state = init_state(16, 4, 1, 33, "cpu")
    labels, fired = [], []
    for j in range(200):
        k = j + 1 - lag
        state, lab, f = detect_step(state, probs[:, j], max(k, 0) * 62.5, k >= 0, cfg, 62.5)
        labels.append(lab)
        fired.append(f)
    valid = torch.from_numpy(np.arange(200) + 1 - lag >= 0)[None].expand(16, -1)
    ref = detect.decide(probs, valid, c["engine"], 62.5)
    assert int(ref["fired"].sum()) > 0
    assert torch.equal(ref["labels"], torch.stack(labels, 1).long())
    assert torch.equal(ref["fired"], torch.stack(fired, 1))
