"""The port's log-mel frontend (howl_tpu_torch/ops/frontend*.py) vs howl_tpu.

The JAX kernel runs as its own tests run it on the CPU: Pallas interpret
mode. The port runs the plain PyTorch version of its CUDA kernel, which is
what the kernel's wrapper takes for a CPU tensor. Inputs come from seeded
numpy generators.

Tolerances: the float32 grade uses test_frontend_pallas.py's bound,
1e-3/std. So does the three-pass grade, "bf16x3" (the JAX kernel's
``precision=None``): both sides split the same float32 audio, W, power and
filterbank into the same bf16 parts, so only the order of the float32 sums
differs, as in the float32 grade; the grade's own error against float32,
~2^-17 relative, is the same on both sides. In the bf16 operand grades both sides round the same operands to
bf16, so the only difference is float32 accumulation order, which can flip
one bf16 rounding of the power: 2e-2/std. A bf16 output can flip its final
rounding for the same reason, so it adds one bf16 ulp of the output's
magnitude.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu.ops.frontend_pallas import log_mel_spectrogram_pallas
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops.frontend_cuda import (
    frontend_grade,
    log_mel_spectrogram_cuda,
    log_mel_spectrogram_plain,
)

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
JAX_PRECISION = {"f32": jax.lax.Precision.HIGHEST, "bf16x3": None, "bf16x2": "bf16x2", "bf16": "bf16"}
EXACT_SUMS = ("f32", "bf16x3")  # the grades whose sides differ only in the order of the float32 sums


def _audio(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(x).max()), 1e-30))) - 7)


def _jax_kernel(audio, n_mels, mean, std, grade, out_bf16, layout):
    out = log_mel_spectrogram_pallas(
        audio, jfe.FrontendConfig(n_mels=n_mels), mean, std, interpret=True,
        precision=JAX_PRECISION[grade], out_dtype=jnp.bfloat16 if out_bf16 else None, layout=layout,
    )
    return np.asarray(out.astype(jnp.float32))


def _port_plain(audio, n_mels, mean, std, grade, out_bf16, layout):
    out = log_mel_spectrogram_cuda(
        torch.from_numpy(audio), tfe.FrontendConfig(n_mels=n_mels), mean, std, precision=grade,
        out_dtype=torch.bfloat16 if out_bf16 else torch.float32, layout=layout,
    )
    return out.float().numpy()


# ---- the restated numpy builders are bit-identical ----


@pytest.mark.parametrize(
    "n_freqs,n_mels,sr,f_min,f_max",
    [(257, 40, 16000, 0.0, None), (257, 80, 16000, 0.0, None), (201, 40, 16000, 20.0, 7600.0), (513, 64, 22050, 0.0, 8000.0)],
)
def test_mel_filterbank_equal(n_freqs, n_mels, sr, f_min, f_max):
    np.testing.assert_array_equal(
        tfe.mel_filterbank(n_freqs, n_mels, sr, f_min, f_max), jfe.mel_filterbank(n_freqs, n_mels, sr, f_min, f_max)
    )
    f = np.linspace(0, sr / 2, 17)
    np.testing.assert_array_equal(tfe.hz_to_mel(f), jfe.hz_to_mel(f))
    np.testing.assert_array_equal(tfe.mel_to_hz(tfe.hz_to_mel(f)), jfe.mel_to_hz(jfe.hz_to_mel(f)))


@pytest.mark.parametrize("n_fft,n_bins", [(512, 256), (512, 257), (400, 200), (400, 201)])
def test_windowed_dft_matrix_and_hann_equal(n_fft, n_bins):
    np.testing.assert_array_equal(tfe.windowed_dft_matrix(n_fft, n_bins), jfe.windowed_dft_matrix(n_fft, n_bins))
    np.testing.assert_array_equal(tfe._hann_window(n_fft), jfe._hann_window(n_fft))


@pytest.mark.parametrize(
    "kw",
    [{}, {"n_mels": 40}, {"n_fft": 400}, {"n_fft": 511}, {"f_max": 9000.0}, {"f_max": 8000.0}, {"center": False}],
)
def test_config_geometry_equal(kw):
    t, j = tfe.FrontendConfig(**kw), jfe.FrontendConfig(**kw)
    assert tfe.nyquist_crop_bins(t) == jfe.nyquist_crop_bins(j)
    assert t.n_freqs == j.n_freqs
    for n in (0, 511, 512, 8000, 12345, 128000):
        assert t.num_frames(n) == j.num_frames(n)
    lengths = np.array([512, 8000, 16000])
    np.testing.assert_array_equal(t.compute_lengths(lengths).numpy(), np.asarray(j.compute_lengths(lengths)))


# ---- the plain log-mel chain (ops/frontend.py) vs the JAX chain ----


@pytest.mark.parametrize("n_mels", [40, 80])
def test_log_mel_chain_matches_jax(n_mels):
    audio = _audio(1, (2, 12345))
    for precision, atol in ((None, 1e-3), ("bf16", 2e-2)):
        ref = np.asarray(jfe.log_mel_spectrogram(audio, jfe.FrontendConfig(n_mels=n_mels), precision=precision))
        ours = tfe.log_mel_spectrogram(torch.from_numpy(audio), tfe.FrontendConfig(n_mels=n_mels), precision=precision)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), ref, atol=atol)


# ---- the kernel's plain version vs the JAX kernel ----


@pytest.mark.parametrize("n_mels", [40, 80])
@pytest.mark.parametrize("layout", ["tm", "fm"])
@pytest.mark.parametrize("grade", ["f32", "bf16x3", "bf16x2", "bf16"])
def test_plain_kernel_matches_pallas(grade, layout, n_mels):
    audio = _audio(2, (2, 16000))
    ref = np.asarray(jfe.log_mel_spectrogram(audio, jfe.FrontendConfig(n_mels=n_mels)))
    mean, std = float(ref.mean()), float(ref.std())
    want = _jax_kernel(audio, n_mels, mean, std, grade, False, layout)
    got = _port_plain(audio, n_mels, mean, std, grade, False, layout)
    assert got.shape == want.shape
    atol = (1e-3 if grade in EXACT_SUMS else 2e-2) / std
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("grade", ["f32", "bf16x3", "bf16x2", "bf16"])
def test_plain_kernel_bf16_output_matches_pallas(grade):
    audio = _audio(3, (2, 12000))
    mean, std = -4.0, 3.0
    want = _jax_kernel(audio, 40, mean, std, grade, True, "tm")
    got = _port_plain(audio, 40, mean, std, grade, True, "tm")
    assert got.shape == want.shape == (2, 61, 40)
    atol = (1e-3 if grade in EXACT_SUMS else 2e-2) / std + _bf16_ulp(want)
    np.testing.assert_allclose(got, want, atol=atol)


def test_plain_kernel_multicell_clip_matches_pallas():
    """64,000 samples -> 321 frames: spans several 128-frame cells of the JAX
    kernel and several frame tiles of the CUDA kernel."""
    audio = _audio(4, (1, 64000))
    want = _jax_kernel(audio, 40, 0.0, 1.0, "bf16", False, "tm")
    got = _port_plain(audio, 40, 0.0, 1.0, "bf16", False, "tm")
    assert got.shape == (1, 321, 40)
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("n_mels", [40, 80])
def test_plain_kernel_matches_torchaudio_golden(n_mels):
    """The float32 grade against the f64 torch.stft goldens, with
    test_golden_frontend.py's bounds: 3e-3 above the log-offset floor, 0.02
    everywhere."""
    gold = np.load(GOLDEN / f"frontend_logmel_{n_mels}.npy")
    audio = torch.from_numpy(np.load(GOLDEN / "frontend_input.npy"))
    cfg = tfe.FrontendConfig(n_mels=n_mels)
    for ours in (log_mel_spectrogram_plain(audio, cfg, precision="f32"), tfe.log_mel_spectrogram(audio, cfg)):
        err = np.abs(ours.numpy() - gold)
        assert ours.shape == gold.shape
        assert err.max() < 0.02
        assert err[gold > -10.0].max() < 3e-3


def test_plain_kernel_1d_input_and_bad_requests():
    audio = torch.from_numpy(_audio(5, 16000))
    out = log_mel_spectrogram_plain(audio, tfe.FrontendConfig(n_mels=40))
    assert out.shape == (1, 40, 81) and torch.isfinite(out).all()
    assert frontend_grade("f32") == frontend_grade("HIGHEST") == "f32"
    assert frontend_grade(None) == frontend_grade("high") == frontend_grade("bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="precision"):
        frontend_grade("tf32")
    with pytest.raises(ValueError, match="layout"):
        log_mel_spectrogram_plain(audio, layout="ft")
    with pytest.raises(TypeError, match="float32"):
        log_mel_spectrogram_plain(audio.double())
    with pytest.raises(ValueError, match="reflect"):
        log_mel_spectrogram_plain(audio[:100])


def test_precision_names_resolve_to_the_jax_kernels_grades():
    """None and "high" name the JAX kernel's three-pass grade, as its
    ``_passes_for`` maps None and Precision.HIGH to 3 passes; an engine's
    "auto" names the exact grade by name for float32 serving and "bf16" for
    bf16 serving; the live engines' ``dft_precision`` follows the JAX chain,
    where None is the exact grade."""
    from howl_tpu_torch.inference.config import serving_dft_precision
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.inference import EngineConfig

    assert [frontend_grade(p) for p in (None, "high", "HIGH", "bf16x3")] == ["bf16x3"] * 4
    assert [frontend_grade(p) for p in ("f32", "highest", "HIGHEST")] == ["f32"] * 3
    assert serving_dft_precision(None) == serving_dft_precision(torch.float32) == "f32"
    assert serving_dft_precision(torch.bfloat16) == "bf16"
    assert serving_dft_precision(None, None) is None  # an explicit request is served as asked
    for p in (None, "high", "auto"):
        eng = IncrementalOnlineEngine(create_model("res8", num_labels=4), create_model("res8", num_labels=4).state_dict(),
                                      EngineConfig(num_labels=4, negative_label=3), tfe.FrontendConfig(n_mels=40),
                                      dft_precision=p, device="cpu")
        assert frontend_grade(eng._dft_precision) == "f32", p


def test_three_pass_grade_is_nearer_float32_than_two_passes():
    """The grade's own error: bf16x3 drops only the lo x lo terms (~2^-17
    relative), bf16x2 keeps the audio and the power at bf16 (~2^-9)."""
    audio = torch.from_numpy(_audio(6, (2, 16000)))
    cfg = tfe.FrontendConfig(n_mels=40)
    exact = log_mel_spectrogram_plain(audio, cfg, precision="f32")
    err = {g: float((log_mel_spectrogram_plain(audio, cfg, precision=g) - exact).abs().max())
           for g in ("bf16x3", "bf16x2")}
    assert err["bf16x3"] < 1e-3 < err["bf16x2"], err
