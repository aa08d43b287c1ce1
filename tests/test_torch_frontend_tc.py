"""The host side of the tensor-core log-mel frontend (howl_tpu_torch/ops/
frontend_cuda.py: routes, the hi/lo and hi/mid/lo bf16 splits, the
shared-memory images of W and the filterbank that ``csrc/frontend_tc.cu``
reads) vs howl_tpu.

The kernel itself runs only on the card (tests/test_torch_gpu.py). Here the
port runs the kernel's plain PyTorch version and the JAX kernel runs in
Pallas interpret mode; a torch emulation of the kernel's three-pass and
six-pass decompositions, from the images it reads, is held against both. Tolerance of the two-pass grade, "bf16x2": both sides
round the same operands to bf16 and split W into the same hi and lo parts,
so the only difference is float32 accumulation order, which can flip one
bf16 rounding of the power: 2e-2/std, as in tests/test_torch_frontend.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu.ops.frontend_pallas import _split_bf16, log_mel_spectrogram_pallas
from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops import frontend_cuda as fc
from howl_tpu_torch.tools import probe_kernel_variants as probe

torch.set_num_threads(1)

GEOMETRIES = {
    "512/200, 40 mels": dict(n_mels=40),
    "400/160, 40 mels": dict(n_fft=400, hop_length=160, n_mels=40),
    "512/200, 80 mels": dict(n_mels=80),
    "256/80, 80 mels": dict(n_fft=256, hop_length=80, n_mels=80),
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
        p_hi, p_lo = fc.frontend_split_bases(cfg, cpu)[:2]
        np.testing.assert_array_equal(p_hi.numpy(), hi.float().numpy())
        np.testing.assert_array_equal(p_lo.numpy(), lo.float().numpy())
        np.testing.assert_array_equal(fc.frontend_bases(cfg, "bf16x2", cpu)[0].double().numpy(), both.numpy())


# the passes of W the "tc" kernel streams: "bf16x3" W_hi and W_lo, as "bf16x2"; "f32" W_hi, W_mid and W_lo
W_PASSES = {"bf16": 1, "bf16x2": 2, "bf16x3": 2, "f32": 3}


@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("grade", ["bf16", "bf16x2", "bf16x3", "f32"])
def test_w_image_round_trip_holds_every_element_once(name, grade):
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    if fc.frontend_route(cfg, grade) != "tc":  # "bf16x3" and "f32" at 512/200 with 80 mels: the FMA kernel's
        with pytest.raises(ValueError, match="does not serve"):
            fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
        return
    n_bins = tfe.nyquist_crop_bins(cfg)
    w_img, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
    assert n_passes == {"bf16": 1, "bf16x2": 2, "bf16x3": 3, "f32": 6}[grade] and n_halves == -(-n_bins // fc.TC_HALF_BINS)
    w_passes = W_PASSES[grade]
    assert w_img.dtype == fb_img.dtype == torch.bfloat16
    assert w_img.numel() == w_passes * cfg.n_fft * n_halves * 2 * fc.TC_HALF_BINS
    tiles = fc.unpack_w_image(w_img, w_passes, cfg.n_fft, n_halves)
    np.testing.assert_array_equal(_bits(fc.pack_w_image(tiles)), _bits(w_img))

    # every column of [cos | -sin] sits in exactly one tile column; the rest are zero
    cols = fc.tc_tile_columns(n_bins)
    assert sorted(cols[cols >= 0]) == list(range(2 * n_bins)) and len(cols) == tiles.shape[-1]
    w = tfe.windowed_dft_matrix(cfg.n_fft, n_bins)
    want = (torch.from_numpy(w).to(torch.bfloat16),) if grade == "bf16" else fc.split_bf16(w, w_passes)
    for p in range(w_passes):
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
    for p, k, h, n in [(0, 0, 0, 0), (w_passes - 1, cfg.n_fft - 1, n_halves - 1, 255), (0, 77, n_halves - 1, 133)]:
        at = ((((h * w_passes + p) * k16 + k // 16) * 2 + (k % 16) // 8) * 32 + n // 8) * 64 + (n % 8) * 8 + k % 8
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


@pytest.mark.parametrize("name", [n for n in GEOMETRIES if n != "512/200, 80 mels"])
def test_fb_image_of_the_three_pass_grade_holds_hi_then_lo(name):
    """The three-pass grade's filterbank operand: fb_hi's image, then
    fb_lo's, each ``pack_fb_image`` of a ``split_bf16`` part, one after the
    other as the kernel's single bulk copy lands them."""
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    n_bins = tfe.nyquist_crop_bins(cfg)
    _, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, "bf16x3", torch.device("cpu"))
    _, one_img, _, _, _ = fc.frontend_bases_tc(cfg, "bf16", torch.device("cpu"))
    assert n_passes == 3 and fb_img.numel() == 2 * one_img.numel() == 2 * n_halves * fc.TC_HALF_BINS * mel_n
    want = fc.split_bf16(tfe.mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)[:n_bins])
    for part, img in zip(want, fb_img.chunk(2)):
        fb = fc.unpack_fb_image(img, mel_n)
        np.testing.assert_array_equal(_bits(fc.pack_fb_image(fb)), _bits(img))
        np.testing.assert_array_equal(_bits(fb[:n_bins, : cfg.n_mels]), _bits(part))
        assert not fb[n_bins:].float().any() and not fb[:, cfg.n_mels :].float().any()
    np.testing.assert_array_equal(_bits(fb_img[: one_img.numel()]), _bits(one_img))  # fb_hi is the 1-pass image


def _parts(x: torch.Tensor, n: int) -> list:
    """The kernel's split of float32 ``x`` into n bf16 parts (as float32),
    each the bf16 rounding of what the ones before leave."""
    out = []
    for _ in range(n):
        out.append(tfe.round_bf16(x))
        x = x - out[-1]
    return out


def _emulate_tc(audio: torch.Tensor, cfg, mean: float, std: float, grade: str, out_dtype=torch.float32):
    """``csrc/frontend_tc.cu``'s decomposition in torch, "tm" layout, from
    the very images the kernel reads: the span split as it is loaded (the
    bf16 part, for "bf16x3" the remainder, for "f32" hi, mid and lo), per
    pass of W the x parts its stages multiply, in the kernel's order (W_hi:
    x_hi, then x_lo for "bf16x3", x_mid and x_lo for "f32"; W_mid: x_hi and
    x_mid; W_lo: x_hi), per 128-bin half the power split and the mel
    products against fb's images, then the epilogue."""
    cpu = torch.device("cpu")
    w_img, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, grade, cpu)
    w_passes, parts = W_PASSES[grade], fc.TC_PARTS[grade]
    tiles = fc.unpack_w_image(w_img, w_passes, cfg.n_fft, n_halves).float()
    fbs = [fc.unpack_fb_image(img, mel_n).float() for img in fb_img.chunk(parts)]
    n_frames = cfg.num_frames(audio.shape[-1])
    xs = _parts(tfe.center_pad(audio, cfg), max(parts, 1))
    frames = [x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames] for x in xs]
    # (x part, W pass) of every group of products: the kept terms are those of order at most the last part
    groups = [(0, p) for p in range(w_passes)] if parts == 1 else [
        (i, p) for p in range(w_passes) for i in range(parts - p)]
    acc = sum(frames[i] @ tiles[p] for i, p in groups)
    mel = torch.zeros(acc.shape[:-1] + (mel_n,))
    for h in range(n_halves):
        re = acc[..., 256 * h : 256 * h + 128]
        im = acc[..., 256 * h + 128 : 256 * h + 256]
        power = _parts(re * re + im * im, parts)
        rows = slice(128 * h, 128 * h + 128)
        for i, j in [(i, j) for j in range(parts) for i in range(parts - j)] if parts > 1 else [(0, 0)]:
            mel = mel + power[i] @ fbs[j][rows]
    mel = mel[..., : cfg.n_mels]
    if out_dtype == torch.bfloat16:
        mel = tfe.round_bf16(mel)
    m, inv_std = fc._zmuv_scalars(mean, std)
    return ((torch.log(mel + cfg.log_offset) - m) * inv_std).to(out_dtype)


@pytest.mark.parametrize("name", [n for n in GEOMETRIES if n != "512/200, 80 mels"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32out", "bf16out"])
def test_six_pass_tc_decomposition_matches_plain_and_pallas(name, out_dtype):
    """The "tc" kernel's exact grade: six products of the bf16 parts of the
    audio and W (x_hi, x_mid and x_lo against W_hi, x_hi and x_mid against
    W_mid, x_hi against W_lo) and the same six on the power and fb,
    emulated from its images, against the plain "f32" (the float32 product)
    and the JAX kernel at ``Precision.HIGHEST`` in interpret mode: what
    differs is the dropped terms and the order of the float32 sums, ~2^-24
    relative, held at the grade's 1e-3/std (plus one bf16 ulp for bf16
    output, as on the card). The emulation is nearer the plain "f32" than
    the three-pass grade's is."""
    kw = GEOMETRIES[name]
    cfg = tfe.FrontendConfig(**kw)
    audio = (np.random.default_rng(17).standard_normal((2, 9000)) * 0.1).astype(np.float32)
    mean, std = -3.0, 2.5
    got = _emulate_tc(torch.from_numpy(audio), cfg, mean, std, "f32", out_dtype).float()
    plain = fc.log_mel_spectrogram_plain(torch.from_numpy(audio), cfg, mean, std, precision="f32",
                                         out_dtype=out_dtype, layout="tm").float()
    pallas = torch.from_numpy(np.array(log_mel_spectrogram_pallas(
        audio, jfe.FrontendConfig(**kw), mean, std, interpret=True, precision=jax.lax.Precision.HIGHEST, layout="tm",
        out_dtype=jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32,
    ).astype(jnp.float32)))
    atol = 1e-3 / std + (2.0 ** (np.floor(np.log2(float(plain.abs().max()))) - 7) if out_dtype == torch.bfloat16 else 0)
    assert got.shape == plain.shape == pallas.shape
    assert float((got - plain).abs().max()) <= atol
    assert float((got - pallas).abs().max()) <= atol
    if out_dtype == torch.float32:
        x3 = _emulate_tc(torch.from_numpy(audio), cfg, mean, std, "bf16x3").float()
        assert float((got - plain).abs().max()) < float((x3 - plain).abs().max())


@pytest.mark.parametrize("name", [n for n in GEOMETRIES if n != "512/200, 80 mels"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32out", "bf16out"])
def test_three_pass_tc_decomposition_matches_plain_and_pallas(name, out_dtype):
    """The "tc" kernel's three products (x_hi and x_lo against W_hi, x_hi
    against W_lo) and three mel products, emulated from its images,
    against the plain "bf16x3" and the JAX kernel's default grade
    (``precision=None``) in interpret mode: the same products, the float32
    sums in another order, 1e-3/std (plus one bf16 ulp for bf16 output, as
    on the card). The 1-pass emulation is held the same way against the
    plain "bf16", at that grade's 2e-2/std."""
    kw = GEOMETRIES[name]
    cfg = tfe.FrontendConfig(**kw)
    audio = (np.random.default_rng(16).standard_normal((2, 9000)) * 0.1).astype(np.float32)
    mean, std = -3.0, 2.5
    got = _emulate_tc(torch.from_numpy(audio), cfg, mean, std, "bf16x3", out_dtype).float()
    plain = fc.log_mel_spectrogram_plain(torch.from_numpy(audio), cfg, mean, std, precision="bf16x3",
                                         out_dtype=out_dtype, layout="tm").float()
    pallas = torch.from_numpy(np.array(log_mel_spectrogram_pallas(
        audio, jfe.FrontendConfig(**kw), mean, std, interpret=True, precision=None, layout="tm",
        out_dtype=jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32,
    ).astype(jnp.float32)))
    atol = 1e-3 / std + (2.0 ** (np.floor(np.log2(float(plain.abs().max()))) - 7) if out_dtype == torch.bfloat16 else 0)
    assert got.shape == plain.shape == pallas.shape
    assert float((got - plain).abs().max()) <= atol
    assert float((got - pallas).abs().max()) <= atol
    one = _emulate_tc(torch.from_numpy(audio), cfg, mean, std, "bf16").float()
    want = fc.log_mel_spectrogram_plain(torch.from_numpy(audio), cfg, mean, std, precision="bf16", layout="tm")
    assert float((one - want).abs().max()) <= 2e-2 / std


# routes of the grades ("f32", "bf16x2", "bf16", "bf16x3")
@pytest.mark.parametrize(
    "kw,want",
    [
        (dict(n_mels=40), ("tc", "tc", "tc", "tc")),  # the serving geometry: every grade on "tc"
        (dict(n_mels=80), ("fma", "tc", "tc", "fma")),  # the three-pass block: 251,144 bytes; the six-pass 292,104
        (dict(n_fft=400, hop_length=160, n_mels=40), ("tc", "tc", "tc", "tc")),
        (dict(n_mels=64), ("fma", "tc", "tc", "fma")),  # mel width 80, as above
        (dict(n_mels=40, center=False), ("tc", "tc", "tc", "tc")),
        (dict(n_mels=40, hop_length=201), ("fma", "fma", "fma", "fma")),  # odd hop: a frame's sample pairs are not aligned
        (dict(n_mels=40, n_fft=511), ("fma", "fma", "fma", "fma")),  # no whole number of 16-row steps
        (dict(n_mels=41), ("fma", "fma", "fma", "fma")),  # rows of the output are no multiple of 16 bytes
        (dict(n_mels=128), ("fma", "fma", "fma", "fma")),  # wider than the mel product's compiled widths
        (dict(n_mels=40, hop_length=600), ("fma", "fma", "fma", "fma")),  # the span of 128 frames does not fit
        # the three-pass block: 230,376; the six-pass 271,336
        (dict(n_fft=400, hop_length=160, n_mels=80), ("fma", "tc", "tc", "tc")),
        (dict(n_fft=256, hop_length=80, n_mels=80), ("tc", "tc", "tc", "tc")),  # 128 bins: one half of fb, 168,680
    ],
)
def test_frontend_route_by_geometry_and_grade(kw, want):
    cfg = tfe.FrontendConfig(**kw)
    grades = ("f32", "bf16x2", "bf16", "bf16x3")
    assert tuple(fc.frontend_route(cfg, g) for g in grades) == want
    for grade, route in zip(grades, want):
        if route == "tc":
            assert fc.tc_shared_bytes(cfg, grade) <= fc.TC_MAX_SHARED
        else:
            with pytest.raises(ValueError, match="does not serve"):
                fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
    with pytest.raises(ValueError, match="grade"):
        fc.frontend_route(cfg, "bf16x4")


@pytest.mark.parametrize(
    "kw,want",
    [
        (dict(n_mels=40), 210_184),
        (dict(n_fft=400, hop_length=160, n_mels=40), 189_416),
        (dict(n_fft=400, hop_length=160, n_mels=80), 230_376),
        (dict(n_mels=80), 251_144),
    ],
)
def test_three_pass_block_is_reckoned_from_the_sources_constants(kw, want):
    """The three-pass grade's block: a ring of TC_SLOTS_X3 stages, fb_hi and
    fb_lo, the span's bf16 part and its remainder, and the barriers; the
    constants are the ones test_route_constants_are_the_cuda_sources holds
    against the source. At 512/200 with 80 mels it exceeds a block's 227 KB
    (the FMA kernel serves it); a third ring slot would not fit at 40 mels."""
    cfg = tfe.FrontendConfig(**kw)
    n_halves = -(-tfe.nyquist_crop_bins(cfg) // fc.TC_HALF_BINS)
    mel_n = next(n for n in fc.TC_MEL_WIDTHS if cfg.n_mels <= n)
    span = -(-((fc.TC_TILE - 1) * cfg.hop_length + cfg.n_fft) * 2 // 16) * 16
    fb = n_halves * fc.TC_HALF_BINS * mel_n * 2
    reckoned = fc.TC_SLOTS_X3 * fc.TC_STAGE_BYTES + 2 * fb + 2 * span + (2 * fc.TC_SLOTS_X3 + 1) * 8
    assert fc.tc_shared_bytes(cfg, "bf16x3") == reckoned == want
    assert (fc.frontend_route(cfg, "bf16x3") == "tc") == (want <= fc.TC_MAX_SHARED)
    if cfg.n_mels == 40 and cfg.n_fft == 512:
        assert reckoned + fc.TC_STAGE_BYTES + 16 > fc.TC_MAX_SHARED


@pytest.mark.parametrize(
    "kw,want",
    [
        (dict(n_mels=40), 230_664),
        (dict(n_fft=400, hop_length=160, n_mels=40), 209_896),
        (dict(n_fft=256, hop_length=80, n_mels=80), 168_680),
        (dict(n_mels=80), 292_104),
        (dict(n_fft=400, hop_length=160, n_mels=80), 271_336),
    ],
)
def test_six_pass_block_is_reckoned_from_the_sources_constants(kw, want):
    """The exact grade's block: a ring of TC_SLOTS_X3 stages, fb_hi, fb_mid
    and fb_lo, the span once in float32 (split as A is loaded), and the
    barriers. At 512/200 with 40 mels it fits a block with 1,784 bytes to
    spare; three bf16 spans in place of the float32 one would not fit."""
    cfg = tfe.FrontendConfig(**kw)
    n_halves = -(-tfe.nyquist_crop_bins(cfg) // fc.TC_HALF_BINS)
    mel_n = next(n for n in fc.TC_MEL_WIDTHS if cfg.n_mels <= n)
    samples = (fc.TC_TILE - 1) * cfg.hop_length + cfg.n_fft
    fb = n_halves * fc.TC_HALF_BINS * mel_n * 2
    reckoned = fc.TC_SLOTS_X3 * fc.TC_STAGE_BYTES + 3 * fb + -(-samples * 4 // 16) * 16 + (2 * fc.TC_SLOTS_X3 + 1) * 8
    assert fc.tc_shared_bytes(cfg, "f32") == reckoned == want
    assert (fc.frontend_route(cfg, "f32") == "tc") == (want <= fc.TC_MAX_SHARED)
    if cfg.n_mels == 40 and cfg.n_fft == 512:
        assert fc.TC_MAX_SHARED - reckoned == 1_784
        assert reckoned + -(-samples * 2 // 16) * 16 > fc.TC_MAX_SHARED


@pytest.mark.parametrize("name", [n for n in GEOMETRIES if n != "512/200, 80 mels"])
def test_fb_image_of_the_six_pass_grade_holds_hi_mid_then_lo(name):
    """The exact grade's filterbank operand: the images of fb_hi, fb_mid and
    fb_lo (``split_bf16(fb, 3)``) one after the other, as one bulk copy
    lands them; fb_hi's is the 1-pass image."""
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    n_bins = tfe.nyquist_crop_bins(cfg)
    _, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, "f32", torch.device("cpu"))
    _, one_img, _, _, _ = fc.frontend_bases_tc(cfg, "bf16", torch.device("cpu"))
    assert n_passes == 6 and fb_img.numel() == 3 * one_img.numel() == 3 * n_halves * fc.TC_HALF_BINS * mel_n
    want = fc.split_bf16(tfe.mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)[:n_bins], 3)
    for part, img in zip(want, fb_img.chunk(3)):
        fb = fc.unpack_fb_image(img, mel_n)
        np.testing.assert_array_equal(_bits(fb[:n_bins, : cfg.n_mels]), _bits(part))
        assert not fb[n_bins:].float().any() and not fb[:, cfg.n_mels :].float().any()
    np.testing.assert_array_equal(_bits(fb_img[: one_img.numel()]), _bits(one_img))


@pytest.mark.parametrize("what", ["audio", "W", "fb"])
def test_three_way_split_reconstructs_float32(what):
    """hi + mid + lo of ``split_bf16(a, 3)``: each part a bf16 value, the sum
    within 2^-24 of |a| (the relative error of float32's own rounding) over
    the ranges the kernel splits: audio at the scale of the tests' and the
    card's clips (and a loud one), the windowed DFT basis, the filterbank;
    the first two parts are ``split_bf16``'s hi and lo rounding."""
    rng = np.random.default_rng(24)
    if what == "audio":
        a = np.concatenate([rng.standard_normal(20000) * 0.1, rng.uniform(-1, 1, 2000),
                            rng.standard_normal(2000) * 1e-4]).astype(np.float32)
    elif what == "W":
        a = tfe.windowed_dft_matrix(512, 256).reshape(-1)
    else:
        a = tfe.mel_filterbank(257, 40, 16000, 0.0, 8000.0).reshape(-1)
    hi, mid, lo = fc.split_bf16(a, 3)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), _bits(fc.split_bf16(a)[0]))
    x = torch.from_numpy(np.asarray(a, np.float32)).double()
    total = hi.double() + mid.double() + lo.double()
    assert bool(((total - x).abs() <= 2.0**-24 * x.abs()).all())
    assert bool((lo.double().abs() <= 2.0**-14 * x.abs() + 1e-38).all())  # each part ~2^-8 of the one before


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
    assert "kTile" not in consts and int(consts["kHalfBins"]) == fc.TC_HALF_BINS  # the tile is a template parameter
    assert int(consts["kSlots"]) == fc.TC_SLOTS and int(consts["kMaxSmem"]) == fc.TC_MAX_SHARED
    assert int(consts["kSlotsX3"]) == fc.TC_SLOTS_X3
    assert consts["kStageBytes"] == "kStageSteps * kStepBytes" and int(consts["kStageSteps"]) == 4
    assert consts["kStepBytes"] == "16 * 2 * kHalfBins * 2" and fc.TC_STAGE_BYTES == 4 * 16 * 2 * fc.TC_HALF_BINS * 2
    # the instances the entry point dispatches to: (mel width, tile), each for every count of the operands'
    # parts, 1 ("bf16", "bf16x2"), 2 ("bf16x3"), 3 ("f32"); the default tile among them at every width
    instances = re.findall(r"mel_n == (\d+) && frame_tile == (\d+)\) fn = instance<(\d+), (\d+)>\(parts\)", src)
    assert all(m == m2 and t == t2 for m, t, m2, t2 in instances)
    tiles = {}
    for m, t, _, _ in instances:
        tiles.setdefault(int(m), []).append(int(t))
    assert {m: tuple(t) for m, t in tiles.items()} == fc.TC_TILES and sorted(tiles) == sorted(fc.TC_MEL_WIDTHS)
    assert all(fc.TC_TILE in t for t in fc.TC_TILES.values())
    parts = re.findall(r"launch<kMelN, (\d), kTile>", src)
    assert sorted(map(int, parts)) == sorted(set(fc.TC_PARTS.values())) == [1, 2, 3]
    # the span a tile reads: (tile - 1) * hop + n_fft samples, as tc_shared_bytes reckons it
    assert "return (kTile - 1) * hop + n_fft;" in src
    fma = (_build.CSRC / "frontend.cu").read_text()
    assert re.findall(r"frame_tile == (\d+) \? launch<(\d+)>", fma) == [(str(t), str(t)) for t in fc.FMA_TILES]
    assert fc.FMA_TILE in fc.FMA_TILES
    assert int(re.search(r"^constexpr int kChunk = (\d+);", fma, flags=re.M).group(1)) == fc.FMA_CHUNK
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


@pytest.mark.parametrize("variant", sorted(probe.K1_X3_EDITS))
def test_probe_variants_edit_the_source_once(variant):
    """Each variant of the three-pass probe (``probe_kernel_variants --probe
    k1-x3``) applies to ``csrc/frontend_tc.cu`` as it is."""
    source, edits, _ = probe.PROBES["k1-x3"]
    assert source == _build.CSRC / "frontend_tc.cu" and edits is probe.K1_X3_EDITS
    text = probe.apply_edits(source.read_text(), edits[variant], variant)
    assert (text == source.read_text()) == (variant == "as it is")


@pytest.mark.parametrize("variant", sorted(probe.K1_F32_EDITS))
def test_six_pass_probe_variants_edit_the_source_once(variant):
    """Each variant of the six-pass probe (``probe_kernel_variants --probe
    k1-f32``) applies to ``csrc/frontend_tc.cu`` as it is; the three cuts
    of work each add one to the cuts of the one before, and the last
    variant, alone, takes out the waits between a stage's groups."""
    source, edits, _ = probe.PROBES["k1-f32"]
    assert source == _build.CSRC / "frontend_tc.cu" and edits is probe.K1_F32_EDITS
    text = probe.apply_edits(source.read_text(), edits[variant], variant)
    assert (text == source.read_text()) == (variant == "as it is")
    cuts = list(probe.K1_F32_EDITS.values())[:4]
    assert all(cuts[i + 1][: len(cuts[i])] == cuts[i] and len(cuts[i + 1]) == len(cuts[i]) + 1 for i in range(3))
    assert len(probe.K1_F32_EDITS["no wait between groups"]) == 1
