"""The last public functions of howl_tpu with their counterparts at the same
paths in the port, each against JAX's on seeded inputs.

* ``root_path``, ``datasets_path``, ``workspaces_path``: the same paths.
* ``ops.frontend.dft_matrices``: JAX's arrays bit for bit, at three sizes.
* ``native.pcm_int16_to_float`` and ``native.wav_decode`` bit for bit and
  ``native.leading_silence_ms`` equal, on seeded PCM bytes, tones after
  silence and WAV bytes written with ``wave`` (mono and stereo; a
  malformed file is None), through the native library and, with the library
  missing, through the numpy path (``wav_decode`` then None, as in JAX).
* ``compat.torch_state_to_variables`` and the four family converters: a
  seeded castorini-layout state dict of each importable family gives JAX's
  variables tree, every leaf bit for bit; the other families raise
  ``NotImplementedError``, a missing tensor ``ValueError``, a two-layer
  LAS biLSTM ``NotImplementedError``, as in JAX.
"""

import io
import wave

import numpy as np
import pytest
import torch

import howl_tpu
import howl_tpu.compat as jcompat
import howl_tpu.native as jnative
import howl_tpu_torch
import howl_tpu_torch.compat as tcompat
import howl_tpu_torch.native as tnative
from howl_tpu.ops.frontend import dft_matrices as jax_dft_matrices
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.frontend import dft_matrices

FAMILIES = ("res8", "lstm", "seq-lstm", "gru", "las")


def test_root_paths_are_the_jax_packages():
    for name in ("root_path", "datasets_path", "workspaces_path"):
        assert getattr(howl_tpu_torch, name)() == getattr(howl_tpu, name)()
    assert (howl_tpu_torch.root_path() / "howl_tpu_torch" / "__init__.py").is_file()


@pytest.mark.parametrize("n_fft", [256, 400, 512])
def test_dft_matrices_are_jaxs_bit_for_bit(n_fft):
    for got, want in zip(dft_matrices(n_fft), jax_dft_matrices(n_fft)):
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (n_fft, n_fft // 2 + 1)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _wav_bytes(samples: np.ndarray, sample_rate: int, channels: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.astype("<i2").tobytes())
    return buf.getvalue()


def _tone_after_silence(rng, silence_s: float, sample_rate: int = 16000) -> np.ndarray:
    t = np.arange(int(0.5 * sample_rate)) / sample_rate
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t) + rng.normal(0, 0.01, t.size)
    quiet = rng.normal(0, 1e-4, int(silence_s * sample_rate))
    return np.concatenate([quiet, tone]).astype(np.float32)


@pytest.fixture(params=["native", "numpy"])
def library(request, monkeypatch):
    """Both packages through the native library, or both without it."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_ensure_built", lambda: None)
        monkeypatch.setattr(jnative, "_ensure_built", lambda: None)
    else:
        assert tnative.available() and jnative._ensure_built() is not None
    return request.param


def test_pcm_int16_to_float_is_jaxs_bit_for_bit(library, rng):
    pcm = np.concatenate([[-32768, 32767, 0], rng.integers(-32768, 32768, 4001)]).astype("<i2").tobytes()
    got, want = tnative.pcm_int16_to_float(pcm), jnative.pcm_int16_to_float(pcm)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() == -1.0 and np.abs(got).max() <= 1.0


@pytest.mark.parametrize("silence_s", [0.0, 0.12, 0.3])
def test_leading_silence_ms_equals_jaxs(library, rng, silence_s):
    audio = _tone_after_silence(rng, silence_s)
    for kwargs in ({}, {"frame_ms": 10, "threshold_db": -50.0}):
        got = tnative.leading_silence_ms(audio, **kwargs)
        assert got == jnative.leading_silence_ms(audio, **kwargs)
        assert isinstance(got, int) and abs(got - 1000 * silence_s) <= 2 * kwargs.get("frame_ms", 30)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_is_jaxs_bit_for_bit(library, rng, channels):
    samples = rng.integers(-32768, 32768, 3000 * channels)
    data = _wav_bytes(samples, 22050, channels)
    got, want = tnative.wav_decode(data), jnative.wav_decode(data)
    if library == "numpy":
        assert got is None and want is None
        return
    (audio, sr, ch), (j_audio, j_sr, j_ch) = got, want
    assert (sr, ch) == (j_sr, j_ch) == (22050, channels)
    assert np.array_equal(audio.view(np.uint32), j_audio.view(np.uint32))
    np.testing.assert_array_equal(audio, samples.astype(np.float32) / 32768.0)
    assert tnative.wav_decode(data[:40]) is None and jnative.wav_decode(data[:40]) is None  # malformed


def _reference_state_dict(name: str, seed: int) -> dict:
    """A castorini-layout state dict of ``name`` (the port's models carry the
    reference's names and shapes), every tensor seeded, both LSTM and GRU
    biases nonzero."""
    rng = np.random.default_rng(seed)
    template = create_model(name, num_labels=4).state_dict()
    out = {k: torch.from_numpy(rng.normal(0.0, 0.3, tuple(v.shape)).astype(np.float32)) if v.is_floating_point()
           else v.clone() for k, v in template.items()}
    if name == "las":  # the reference's LAS encoder holds conv1 and conv2 twice, one module each
        out.update({f"encoder.conv_encoder.{i}.{p}": out[f"encoder.conv{j}.{p}"] for i, j in ((0, 1), (4, 2))
                    for p in ("weight", "bias")})
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_torch_state_to_variables_is_jaxs_bit_for_bit(name):
    state_dict = _reference_state_dict(name, FAMILIES.index(name))
    family = {"seq-lstm": "lstm"}.get(name, name).replace("-", "_")
    for got, want in ((tcompat.torch_state_to_variables(name, state_dict),
                       jcompat.torch_state_to_variables(name, state_dict)),
                      (getattr(tcompat, f"{family}_torch_state_to_variables")(state_dict),
                       getattr(jcompat, f"{family}_torch_state_to_variables")(state_dict))):
        got, want = _leaves(got), _leaves(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32)), k


def test_torch_state_to_variables_refuses_as_jax_does():
    for name in ("mobilenet", "small-cnn", "seq-cnn"):
        for mod in (tcompat, jcompat):
            with pytest.raises(NotImplementedError, match="implemented for"):
                mod.torch_state_to_variables(name, {})
    partial = dict(_reference_state_dict("res8", 0))
    del partial["conv3.weight"]
    for mod in (tcompat, jcompat):
        with pytest.raises(ValueError, match="'conv3.weight'"):
            mod.torch_state_to_variables("res8", partial)
    two_layer = {**_reference_state_dict("las", 0), "encoder.lstm_encoder.weight_ih_l1": torch.zeros(1)}
    for mod in (tcompat, jcompat):
        with pytest.raises(NotImplementedError, match="multi-layer"):
            mod.las_torch_state_to_variables(two_layer)
