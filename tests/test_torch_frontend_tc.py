"""The host side of the tensor-core log-mel frontend (howl_tpu_torch/ops/
frontend_cuda.py: routes, the hi/lo bf16 split, the shared-memory images of
W and the filterbank that ``csrc/frontend_tc.cu`` reads) vs howl_tpu.

The kernel itself runs only on the card (tests/test_torch_gpu.py). Here the
port runs the kernel's plain PyTorch version and the JAX kernel runs in
Pallas interpret mode. Tolerance of the two-pass grade, "bf16x2": both sides
round the same operands to bf16 and split W into the same hi and lo parts,
so the only difference is float32 accumulation order, which can flip one
bf16 rounding of the power: 2e-2/std, as in tests/test_torch_frontend.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu.ops.frontend_pallas import _split_bf16, log_mel_spectrogram_pallas
from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops import frontend_cuda as fc

torch.set_num_threads(1)

GEOMETRIES = {
    "512/200, 40 mels": dict(n_mels=40),
    "400/160, 40 mels": dict(n_fft=400, hop_length=160, n_mels=40),
    "512/200, 80 mels": dict(n_mels=80),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("n_fft,n_bins", [(512, 256), (400, 200)])
def test_split_bf16_equals_the_jax_split_bit_for_bit(n_fft, n_bins):
    w = tfe.windowed_dft_matrix(n_fft, n_bins)
    hi, lo = fc.split_bf16(w)
    jhi, jlo = _split_bf16(jfe.windowed_dft_matrix(n_fft, n_bins))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), jhi.view(np.int16))
    np.testing.assert_array_equal(_bits(lo), jlo.view(np.int16))
    # float32 holds hi + lo exactly: the FMA kernel's W for this grade is the sum of the plain version's two
    both = hi.double() + lo.double()
    np.testing.assert_array_equal(both.float().double().numpy(), both.numpy())
    if (n_fft, n_bins) == (512, 256):
        cfg, cpu = tfe.FrontendConfig(n_mels=40), torch.device("cpu")
        p_hi, p_lo = fc.frontend_w_passes(cfg, cpu)
        np.testing.assert_array_equal(p_hi.numpy(), hi.float().numpy())
        np.testing.assert_array_equal(p_lo.numpy(), lo.float().numpy())
        np.testing.assert_array_equal(fc.frontend_bases(cfg, "bf16x2", cpu)[0].double().numpy(), both.numpy())


@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("grade", ["bf16", "bf16x2"])
def test_w_image_round_trip_holds_every_element_once(name, grade):
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    n_bins = tfe.nyquist_crop_bins(cfg)
    w_img, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
    assert n_passes == {"bf16": 1, "bf16x2": 2}[grade] and n_halves == -(-n_bins // fc.TC_HALF_BINS)
    assert w_img.dtype == fb_img.dtype == torch.bfloat16
    assert w_img.numel() == n_passes * cfg.n_fft * n_halves * 2 * fc.TC_HALF_BINS
    tiles = fc.unpack_w_image(w_img, n_passes, cfg.n_fft, n_halves)
    np.testing.assert_array_equal(_bits(fc.pack_w_image(tiles)), _bits(w_img))

    # every column of [cos | -sin] sits in exactly one tile column; the rest are zero
    cols = fc.tc_tile_columns(n_bins)
    assert sorted(cols[cols >= 0]) == list(range(2 * n_bins)) and len(cols) == tiles.shape[-1]
    w = tfe.windowed_dft_matrix(cfg.n_fft, n_bins)
    want = fc.split_bf16(w) if grade == "bf16x2" else (torch.from_numpy(w).to(torch.bfloat16),)
    for p in range(n_passes):
        np.testing.assert_array_equal(_bits(tiles[p][:, cols >= 0]), _bits(want[p][:, cols[cols >= 0]]))
        assert not tiles[p][:, cols < 0].float().any()
    # re and im of a bin are 128 columns apart in one tile: they fall to one thread of the kernel
    for h in range(n_halves):
        re, im = cols[256 * h : 256 * h + 128], cols[256 * h + 128 : 256 * h + 256]
        assert ((im - re == n_bins) | (re < 0)).all() and ((re < 0) == (im < 0)).all()

    # pack is a permutation: distinct values stay distinct and in place under the stated formula
    ids = torch.arange(w_img.numel(), dtype=torch.int32).reshape(tiles.shape)
    img = fc.pack_w_image(ids)
    assert sorted(img.tolist()) == list(range(w_img.numel()))
    k16 = cfg.n_fft // 16
    for p, k, h, n in [(0, 0, 0, 0), (n_passes - 1, cfg.n_fft - 1, n_halves - 1, 255), (0, 77, n_halves - 1, 133)]:
        at = ((((h * n_passes + p) * k16 + k // 16) * 2 + (k % 16) // 8) * 32 + n // 8) * 64 + (n % 8) * 8 + k % 8
        assert img[at] == ids[p, k, 256 * h + n]
    # a stage of the ring, 64 rows of k of one tile, is one contiguous run of TC_STAGE_BYTES
    first = ids[0, :64, :256].reshape(-1)
    assert sorted(img[: fc.TC_STAGE_BYTES // 2].tolist()) == sorted(first.tolist())


@pytest.mark.parametrize("name", GEOMETRIES)
def test_fb_image_round_trip(name):
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    n_bins = tfe.nyquist_crop_bins(cfg)
    _, fb_img, n_halves, _, mel_n = fc.frontend_bases_tc(cfg, "bf16", torch.device("cpu"))
    assert mel_n in fc.TC_MEL_WIDTHS and mel_n >= cfg.n_mels
    fb = fc.unpack_fb_image(fb_img, mel_n)
    assert fb.shape == (n_halves * fc.TC_HALF_BINS, mel_n)
    np.testing.assert_array_equal(_bits(fc.pack_fb_image(fb)), _bits(fb_img))
    want = tfe.mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)[:n_bins]
    np.testing.assert_array_equal(_bits(fb[:n_bins, : cfg.n_mels]), _bits(torch.from_numpy(want).to(torch.bfloat16)))
    assert not fb[n_bins:].float().any() and not fb[:, cfg.n_mels :].float().any()
    k, n = 200 % fb.shape[0], mel_n - 7
    at = ((k // 16 * 2 + (k % 16) // 8) * (mel_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8
    assert fb_img[at] == fb[k, n]


@pytest.mark.parametrize(
    "kw,want",
    [
        (dict(n_mels=40), ("fma", "tc", "tc")),
        (dict(n_mels=80), ("fma", "tc", "tc")),
        (dict(n_fft=400, hop_length=160, n_mels=40), ("fma", "tc", "tc")),
        (dict(n_mels=64), ("fma", "tc", "tc")),
        (dict(n_mels=40, center=False), ("fma", "tc", "tc")),
        (dict(n_mels=40, hop_length=201), ("fma", "fma", "fma")),  # odd hop: a frame's sample pairs are not aligned
        (dict(n_mels=40, n_fft=511), ("fma", "fma", "fma")),  # no whole number of 16-row steps
        (dict(n_mels=41), ("fma", "fma", "fma")),  # rows of the output are no multiple of 16 bytes
        (dict(n_mels=128), ("fma", "fma", "fma")),  # wider than the mel product's compiled widths
        (dict(n_mels=40, hop_length=600), ("fma", "fma", "fma")),  # the span of 128 frames does not fit
    ],
)
def test_frontend_route_by_geometry_and_grade(kw, want):
    cfg = tfe.FrontendConfig(**kw)
    assert tuple(fc.frontend_route(cfg, g) for g in ("f32", "bf16x2", "bf16")) == want
    if want[-1] == "tc":
        assert fc.tc_shared_bytes(cfg) <= fc.TC_MAX_SHARED
    else:
        with pytest.raises(ValueError, match="does not serve"):
            fc.frontend_bases_tc(cfg, "bf16", torch.device("cpu"))
    with pytest.raises(ValueError, match="does not serve"):
        fc.frontend_bases_tc(cfg, "f32", torch.device("cpu"))
    with pytest.raises(ValueError, match="grade"):
        fc.frontend_route(cfg, "bf16x3")


@pytest.mark.parametrize("route", ["tc", "fma", "wgmma"])
def test_forced_route_needs_a_cuda_tensor(route):
    audio = torch.zeros((1, 4000))
    with pytest.raises(ValueError, match="route"):
        fc.log_mel_spectrogram_cuda(audio, tfe.FrontendConfig(n_mels=40), precision="bf16", route=route)
    assert fc.log_mel_spectrogram_cuda.launches == 0 and fc.log_mel_spectrogram_cuda.launches_tc == 0


def test_route_constants_are_the_cuda_sources():
    """``frontend_route`` sizes the block's shared memory from its own copies
    of the kernel's constants: they must be what the kernel is compiled with."""
    src = (_build.CSRC / "frontend_tc.cu").read_text()
    consts = {n: v for n, v in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, flags=re.M)}
    assert int(consts["kTile"]) == fc.TC_TILE and int(consts["kHalfBins"]) == fc.TC_HALF_BINS
    assert int(consts["kSlots"]) == fc.TC_SLOTS and int(consts["kMaxSmem"]) == fc.TC_MAX_SHARED
    assert consts["kStageBytes"] == "kStageSteps * kStepBytes" and int(consts["kStageSteps"]) == 4
    assert consts["kStepBytes"] == "16 * 2 * kHalfBins * 2" and fc.TC_STAGE_BYTES == 4 * 16 * 2 * fc.TC_HALF_BINS * 2
    assert sorted(int(n) for n in re.findall(r"launch<(\d+)>", src)) == sorted(fc.TC_MEL_WIDTHS)
    header = (_build.CSRC / "hopper_async.cuh").read_text()
    # the frontend's three product shapes (the header holds the trunk proto's, the stem fold's and M2's too)
    assert {40, 80, 256} <= {int(n) for n in re.findall(r"m64n(\d+)k16\.f32\.bf16\.bf16", header)}


@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("layout", ["tm", "fm"])
def test_plain_two_pass_grade_matches_pallas(name, layout):
    """The plain "bf16x2" is x @ W_hi + x @ W_lo, the JAX kernel's two passes."""
    kw = GEOMETRIES[name]
    audio = (np.random.default_rng(11).standard_normal((2, 9000)) * 0.1).astype(np.float32)
    ref = np.asarray(jfe.log_mel_spectrogram(audio, jfe.FrontendConfig(**kw)))
    mean, std = float(ref.mean()), float(ref.std())
    want = np.asarray(log_mel_spectrogram_pallas(
        audio, jfe.FrontendConfig(**kw), mean, std, interpret=True, precision="bf16x2", layout=layout,
    ).astype(jnp.float32))
    got = fc.log_mel_spectrogram_plain(
        torch.from_numpy(audio), tfe.FrontendConfig(**kw), mean, std, precision="bf16x2", layout=layout,
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2 / std)


def test_plain_two_pass_grade_is_nearer_float32_than_one_pass():
    """On the DFT product alone, hi + lo of W removes W's rounding: what is
    left is the audio's."""
    cfg = tfe.FrontendConfig(n_mels=40)
    w32, _ = fc.frontend_bases(cfg, "f32", torch.device("cpu"))
    w2, _ = fc.frontend_bases(cfg, "bf16x2", torch.device("cpu"))
    w1, _ = fc.frontend_bases(cfg, "bf16", torch.device("cpu"))
    assert float((w2 - w32).abs().max()) < 2.0**-16 * float(w32.abs().max())
    assert float((w1 - w32).abs().max()) > 2.0**-10 * float(w32.abs().max())
