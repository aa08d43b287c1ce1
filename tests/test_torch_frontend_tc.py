"""The host side of the tensor-core log-mel frontend (howl_tpu_torch/ops/
frontend_cuda.py: routes, the hi/lo bf16 split, the shared-memory images of
W and the filterbank that ``csrc/frontend_tc.cu`` reads) vs howl_tpu.

The kernel itself runs only on the card (tests/test_torch_gpu.py). Here the
port runs the kernel's plain PyTorch version and the JAX kernel runs in
Pallas interpret mode; a torch emulation of the kernel's three-pass
decomposition, from the images it reads, is held against both. Tolerance of the two-pass grade, "bf16x2": both sides
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
from howl_tpu_torch.tools import probe_kernel_variants as probe

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
        p_hi, p_lo = fc.frontend_split_bases(cfg, cpu)[:2]
        np.testing.assert_array_equal(p_hi.numpy(), hi.float().numpy())
        np.testing.assert_array_equal(p_lo.numpy(), lo.float().numpy())
        np.testing.assert_array_equal(fc.frontend_bases(cfg, "bf16x2", cpu)[0].double().numpy(), both.numpy())


@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("grade", ["bf16", "bf16x2", "bf16x3"])
def test_w_image_round_trip_holds_every_element_once(name, grade):
    cfg = tfe.FrontendConfig(**GEOMETRIES[name])
    if fc.frontend_route(cfg, grade) != "tc":  # "bf16x3" at 512/200 with 80 mels: the FMA kernel's
        with pytest.raises(ValueError, match="does not serve"):
            fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
        return
    n_bins = tfe.nyquist_crop_bins(cfg)
    w_img, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
    assert n_passes == {"bf16": 1, "bf16x2": 2, "bf16x3": 3}[grade] and n_halves == -(-n_bins // fc.TC_HALF_BINS)
    w_passes = min(n_passes, 2)  # "bf16x3" streams W_hi and W_lo, as "bf16x2"
    assert w_img.dtype == fb_img.dtype == torch.bfloat16
    assert w_img.numel() == w_passes * cfg.n_fft * n_halves * 2 * fc.TC_HALF_BINS
    tiles = fc.unpack_w_image(w_img, w_passes, cfg.n_fft, n_halves)
    np.testing.assert_array_equal(_bits(fc.pack_w_image(tiles)), _bits(w_img))

    # every column of [cos | -sin] sits in exactly one tile column; the rest are zero
    cols = fc.tc_tile_columns(n_bins)
    assert sorted(cols[cols >= 0]) == list(range(2 * n_bins)) and len(cols) == tiles.shape[-1]
    w = tfe.windowed_dft_matrix(cfg.n_fft, n_bins)
    want = (torch.from_numpy(w).to(torch.bfloat16),) if grade == "bf16" else fc.split_bf16(w)
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


def _emulate_tc(audio: torch.Tensor, cfg, mean: float, std: float, grade: str, out_dtype=torch.float32):
    """``csrc/frontend_tc.cu``'s decomposition in torch, "tm" layout, from
    the very images the kernel reads: the span split as it is loaded (the
    bf16 part, and for "bf16x3" the remainder), one product a pass of W (for
    "bf16x3" a second one on W_hi's pass, with the remainder), per 128-bin
    half the power split and the mel products against fb's images, then the
    epilogue."""
    cpu = torch.device("cpu")
    w_img, fb_img, n_halves, n_passes, mel_n = fc.frontend_bases_tc(cfg, grade, cpu)
    tiles = fc.unpack_w_image(w_img, min(n_passes, 2), cfg.n_fft, n_halves).float()
    fbs = [fc.unpack_fb_image(img, mel_n).float() for img in fb_img.chunk(2 if grade == "bf16x3" else 1)]
    padded = tfe.center_pad(audio, cfg)
    x_hi = tfe.round_bf16(padded)
    x_lo = tfe.round_bf16(padded - x_hi)
    n_frames = cfg.num_frames(audio.shape[-1])
    frames = [x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames] for x in (x_hi, x_lo)]
    acc = sum(frames[0] @ tiles[p] for p in range(min(n_passes, 2)))
    if grade == "bf16x3":
        acc = acc + frames[1] @ tiles[0]
    mel = torch.zeros(acc.shape[:-1] + (mel_n,))
    for h in range(n_halves):
        re = acc[..., 256 * h : 256 * h + 128]
        im = acc[..., 256 * h + 128 : 256 * h + 256]
        power = re * re + im * im
        p_hi = tfe.round_bf16(power)
        rows = slice(128 * h, 128 * h + 128)
        mel = mel + p_hi @ fbs[0][rows]
        if grade == "bf16x3":
            mel = mel + tfe.round_bf16(power - p_hi) @ fbs[0][rows] + p_hi @ fbs[1][rows]
    mel = mel[..., : cfg.n_mels]
    if out_dtype == torch.bfloat16:
        mel = tfe.round_bf16(mel)
    m, inv_std = fc._zmuv_scalars(mean, std)
    return ((torch.log(mel + cfg.log_offset) - m) * inv_std).to(out_dtype)


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
        (dict(n_mels=40), ("fma", "tc", "tc", "tc")),  # the serving geometry: all three bf16 grades on "tc"
        (dict(n_mels=80), ("fma", "tc", "tc", "fma")),  # the three-pass block: 251,144 bytes
        (dict(n_fft=400, hop_length=160, n_mels=40), ("fma", "tc", "tc", "tc")),
        (dict(n_mels=64), ("fma", "tc", "tc", "fma")),  # mel width 80, as above
        (dict(n_mels=40, center=False), ("fma", "tc", "tc", "tc")),
        (dict(n_mels=40, hop_length=201), ("fma", "fma", "fma", "fma")),  # odd hop: a frame's sample pairs are not aligned
        (dict(n_mels=40, n_fft=511), ("fma", "fma", "fma", "fma")),  # no whole number of 16-row steps
        (dict(n_mels=41), ("fma", "fma", "fma", "fma")),  # rows of the output are no multiple of 16 bytes
        (dict(n_mels=128), ("fma", "fma", "fma", "fma")),  # wider than the mel product's compiled widths
        (dict(n_mels=40, hop_length=600), ("fma", "fma", "fma", "fma")),  # the span of 128 frames does not fit
        (dict(n_fft=400, hop_length=160, n_mels=80), ("fma", "tc", "tc", "tc")),  # the three-pass block: 230,376
    ],
)
def test_frontend_route_by_geometry_and_grade(kw, want):
    cfg = tfe.FrontendConfig(**kw)
    assert tuple(fc.frontend_route(cfg, g) for g in ("f32", "bf16x2", "bf16", "bf16x3")) == want
    for grade, route in zip(("bf16", "bf16x3"), want[2:]):
        if route == "tc":
            assert fc.tc_shared_bytes(cfg, grade) <= fc.TC_MAX_SHARED
        else:
            with pytest.raises(ValueError, match="does not serve"):
                fc.frontend_bases_tc(cfg, grade, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not serve"):
        fc.frontend_bases_tc(cfg, "f32", torch.device("cpu"))
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
    assert int(consts["kSlotsX3"]) == fc.TC_SLOTS_X3
    assert consts["kStageBytes"] == "kStageSteps * kStepBytes" and int(consts["kStageSteps"]) == 4
    assert consts["kStepBytes"] == "16 * 2 * kHalfBins * 2" and fc.TC_STAGE_BYTES == 4 * 16 * 2 * fc.TC_HALF_BINS * 2
    # each mel width compiled with and without the three-pass grade
    widths = re.findall(r"launch<(\d+), (true|false)>", src)
    assert sorted({int(n) for n, _ in widths}) == sorted(fc.TC_MEL_WIDTHS) and len(set(widths)) == 2 * len(fc.TC_MEL_WIDTHS)
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
