"""The port's time-stretch augmentation (howl_tpu_torch/ops/timestretch.py)
against howl_tpu's, and its wiring into the training entry point.

* ``time_stretch`` within 1e-5 (absolute, on audio of peak 0.6) of JAX's at
  rates across [0.3, 1.7] and on a clip too short for the vocoder; both are
  the same numpy arithmetic, so they agree to the last bit in practice.
* ``TimestretchSampleAugment`` draws the same gate and rates at the same
  seed: the same output lengths, audio within 1e-5 and label timestamps
  scaled by the same 1/rate (exact).
* ``train.run --use-timestretch --device cpu`` runs two steps, stretching
  each step's sampled clips before the batchifier windows them: the clips
  the stretch saw and what it gave back equal JAX's
  ``TimestretchSampleAugment`` at the run's seed on the same clips in the
  same order (the entry point's order). ``--no-augment`` turns it off, as in
  the JAX entry point.
"""

import numpy as np
import pytest

from howl_tpu.data.common.label import FrameLabelData as JLabels
from howl_tpu.data.common.metadata import AudioClipMetadata as JMeta
from howl_tpu.data.common.sample import Sample as JSample
from howl_tpu.ops import timestretch as jts
from howl_tpu_torch.data.common.label import FrameLabelData as TLabels
from howl_tpu_torch.data.common.metadata import AudioClipMetadata as TMeta
from howl_tpu_torch.data.common.sample import Sample as TSample
from howl_tpu_torch.ops import timestretch as tts

SR = 16000
ATOL = 1e-5


def _audio(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tone = 0.4 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t) + 0.2 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
    return (tone + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("rate", [0.3, 0.55, 0.8, 1.0, 1.25, 1.7])
def test_time_stretch_matches_jax(rate):
    audio = _audio(int(rate * 100), 12000)
    got, want = tts.time_stretch(audio, rate), jts.time_stretch(audio, rate)
    assert got.dtype == np.float32 and got.shape == want.shape == (int(round(12000 / rate)),)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_short_clip_fallback_matches_jax():
    audio = _audio(1, 700)  # under n_fft // 2 + 1: linear resampling
    for rate in (0.5, 2.0):
        np.testing.assert_allclose(tts.time_stretch(audio, rate), jts.time_stretch(audio, rate), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="positive"):
        tts.time_stretch(audio, 0.0)


def _samples(meta, labels, sample):
    out = []
    for i in range(6):
        n = 8000 + 2000 * i
        label_data = labels({300.0 + 50 * i: 0, 700.0: 1}, [(0, 100.0)], [(0, [0, 1, 2])])
        out.append(sample(meta(path=f"/clips/{i}.wav", transcription="hey fire", end_timestamps=[]), _audio(i, n),
                          SR, label_data=label_data))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_augment_draws_as_jax(seed):
    taug, jaug = tts.TimestretchSampleAugment(seed=seed), jts.TimestretchSampleAugment(seed=seed)
    tsamples, jsamples = _samples(TMeta, TLabels, TSample), _samples(JMeta, JLabels, JSample)
    stretched = 0
    for _ in range(4):  # the gate (prob 0.8) and the per-clip rates, call after call
        tout, jout = taug(tsamples), jaug(jsamples)
        for t, j, orig in zip(tout, jout, tsamples, strict=True):
            assert t.audio_data.shape == j.audio_data.shape
            np.testing.assert_allclose(t.audio_data, j.audio_data, atol=ATOL, rtol=0)
            assert t.label_data.timestamp_label_map == j.label_data.timestamp_label_map
            stretched += t.audio_data.shape != orig.audio_data.shape
    assert stretched > 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.fixtures import make_wakeword_corpus

    return make_wakeword_corpus(tmp_path_factory.mktemp("ts") / "ww", n_positive=8, n_negative=8)


def _run_with_spy(monkeypatch, corpus, ws, extra):
    import howl_tpu_torch.training.run.train as ttrain
    from howl_tpu_torch.settings import SETTINGS

    calls = []

    class Spy(tts.TimestretchSampleAugment):
        def __call__(self, samples):
            out = super().__call__(samples)
            calls.append(([str(s.metadata.path) for s in samples], [s.audio_data for s in out],
                          [s.label_data.timestamp_label_map for s in out]))
            return out

    monkeypatch.setattr(ttrain, "TimestretchSampleAugment", Spy)
    for k, v in {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "BATCH_SIZE": "4",
                 "NUM_EPOCHS": "1", "MAX_WINDOW_SIZE_SECONDS": "0.5", "NUM_MELS": "40", "SEED": "3"}.items():
        monkeypatch.setenv(k, v)
    SETTINGS.reset()
    try:
        stats = ttrain.LoopStats()
        ttrain.run(["--model", "res8", "--workspace", str(ws), "-i", str(corpus), "--device", "cpu", "--eval-freq", "0",
                    "--steps-per-epoch", "2", "--use-timestretch", *extra], stats)
    finally:
        SETTINGS.reset()
    return calls, stats


def test_entry_point_stretches_sampled_clips_before_windowing(corpus, tmp_path, monkeypatch):
    calls, stats = _run_with_spy(monkeypatch, corpus, tmp_path / "ws", [])
    assert stats.steps == 2 and len(calls) == 2 and np.isfinite(stats.epoch_losses).all()
    from howl_tpu.context import InferenceContext
    from howl_tpu.data.dataset.dataset_loader import WakeWordDatasetLoader

    ctx = InferenceContext(vocab=["hey", "fire", "fox"])
    train, _, _ = WakeWordDatasetLoader().load_splits(corpus, sample_rate=SR, mono=True, frame_labeler=ctx.labeler)
    by_path = {str(train[i].metadata.path): train[i] for i in range(len(train))}
    jaug = jts.TimestretchSampleAugment(seed=3)  # the entry point's: SETTINGS.training.seed
    order = np.random.default_rng(3).permutation(len(train))  # the entry point's epoch order at its seed
    stretched = 0
    for step, (paths, audio, stamps) in enumerate(calls):
        assert paths == [str(train[int(order[step * 4 + j])].metadata.path) for j in range(4)]
        jout = jaug([by_path[p] for p in paths])
        for got, got_stamps, want, p in zip(audio, stamps, jout, paths, strict=True):
            assert got.shape == want.audio_data.shape
            np.testing.assert_allclose(got, want.audio_data, atol=ATOL, rtol=0)
            assert got_stamps == want.label_data.timestamp_label_map
            stretched += got.shape != by_path[p].audio_data.shape
    assert stretched > 0  # the run's clips were stretched, not passed through


def test_no_augment_turns_the_stretch_off(corpus, tmp_path, monkeypatch):
    calls, stats = _run_with_spy(monkeypatch, corpus, tmp_path / "ws", ["--no-augment"])
    assert stats.steps == 2 and calls == []
