"""The host side of the tensor-core res8 stem ("tc", ``csrc/stem_tc.cu``) and
of the banded-fold stem proto T2 (``csrc/stem_fold.cu``) vs howl_tpu.

The kernels run only on the card (tests/test_torch_gpu.py). Here: the route
rule, the (16, 48) tap image the stem kernel's A fragments come from, a
torch emulation of the stem kernel's decomposition (the im2col of the mels in
the image's tap order @ the unpacked image -> ReLU -> the kernel's pool
order) against the port's plain version and against the JAX Pallas stem in
interpret mode, T2's swizzled W image, and the constants the CUDA sources
share with Python. Inputs come from seeded numpy generators.

Tolerances: float32 1e-5 (tests/test_stem_pallas.py's bound); bf16 one bf16
ulp of the output's magnitude, where the float32 sums in another order flip
one rounding at the store.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from howl_tpu.ops.stem_pallas import fold_stem_weights as jax_fold_stem_weights
from howl_tpu.ops.stem_pallas import res8_stem_pallas
from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops import stem_cuda as sc
from howl_tpu_torch.tools import trunk_kernels as tk

torch.set_num_threads(1)


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(np.asarray(x, np.float32)).max()), 1e-30))) - 7)


def _inputs(seed, batch, t_frames, n_mels, ch=45):
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((batch, t_frames, n_mels)) * 0.7).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 1, ch)) / 3.0).astype(np.float32)
    return mel, kernel


def emulate_tc(mel: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The stem kernel's decomposition in torch: B = the mels' im2col over the
    image's 16 k (the nine taps in ``TC_TAP_ORDER``, zeros after), products
    against the unpacked tap image in float32, ReLU per frame, the three
    frames of a window added in order, then the window's bins as ((0 + 1) +
    (2 + 3)) and times float32(1/12), rounded to the mels' dtype once."""
    b, t, n_mels = mel.shape
    ch = taps.shape[-1]
    a = sc.pack_tap_image(taps).float()  # (16, 48): bf16 taps
    xp = F.pad(mel.float(), (1, 1, 1, 1))
    cols = [xp[:, 1 + dt : 1 + dt + t, 1 + df : 1 + df + n_mels] for dt, df in sc.TC_TAP_ORDER]
    cols += [torch.zeros_like(cols[0])] * (sc.TC_K - len(cols))
    pre = torch.relu(torch.stack(cols, -1) @ a)  # (B, T, n_mels, 48)
    t_out = t // 3
    rows = pre[:, : 3 * t_out].reshape(b, t_out, 3, n_mels, sc.TC_N)
    acc = (rows[:, :, 0] + rows[:, :, 1]) + rows[:, :, 2]
    win = acc.reshape(b, t_out, n_mels // 4, 4, sc.TC_N)
    y = ((win[..., 0, :] + win[..., 1, :]) + (win[..., 2, :] + win[..., 3, :])) * np.float32(1.0 / 12.0)
    return y[..., :ch].to(mel.dtype)


# ---- the route ----


@pytest.mark.parametrize(
    "dtype,n_mels,ch,pool,want",
    [
        (torch.bfloat16, 40, 45, (3, 4), "tc"),
        (torch.bfloat16, 36, 45, (3, 4), "tc"),
        (torch.bfloat16, 80, 48, (3, 4), "tc"),
        (torch.bfloat16, 128, 48, (3, 4), "tc"),
        (torch.bfloat16, 132, 48, (3, 4), "fma"),
        (torch.bfloat16, 40, 16, (3, 4), "tc"),
        (torch.float32, 40, 45, (3, 4), "fma"),
        (torch.bfloat16, 40, 49, (3, 4), "fma"),
        (torch.bfloat16, 40, 45, (2, 4), "fma"),
        (torch.bfloat16, 40, 45, (3, 2), "fma"),
        (torch.bfloat16, 4096, 48, (3, 4), "fma"),
    ],
)
def test_stem_route_by_dtype_and_geometry(dtype, n_mels, ch, pool, want):
    assert sc.stem_route(dtype, n_mels, ch, pool) == want


def test_stem_route_takes_a_warp_per_eight_bins_up_to_16():
    assert sc.stem_route(torch.bfloat16, sc.TC_MAX_BINS, 48) == "tc"
    assert sc.stem_route(torch.bfloat16, sc.TC_MAX_BINS + 4, 48) == "fma"
    assert sc.stem_route(torch.bfloat16, 4, 48) == "tc" and sc.stem_route(torch.bfloat16, 40, 0) == "fma"


@pytest.mark.parametrize("route", ["tc", "fma", "wgmma"])
def test_forced_route_needs_a_cuda_tensor(route):
    mel, taps = torch.zeros((1, 9, 40), dtype=torch.bfloat16), torch.zeros((3, 3, 45))
    with pytest.raises(ValueError, match="route"):
        sc.res8_stem_cuda(mel, taps, route=route)
    assert sc.res8_stem_cuda.launches == 0 and sc.res8_stem_cuda.launches_tc == 0


def test_cpu_tensor_takes_the_plain_version_on_every_dtype():
    mel, kernel = _inputs(0, 2, 12, 40)
    taps = sc.fold_stem_weights(kernel)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(mel).to(dtype)
        assert torch.equal(sc.res8_stem_cuda(x, taps), sc.res8_stem_plain(x, taps))
    assert sc.res8_stem_cuda.launches == 0


# ---- the tap image ----


@pytest.mark.parametrize("ch", [45, 48, 7])
def test_tap_image_holds_the_taps_in_the_kernels_order(ch):
    _, kernel = _inputs(ch, 1, 3, 40, ch)
    taps = sc.fold_stem_weights(kernel)
    img = sc.pack_tap_image(taps)
    assert img.shape == (sc.TC_K, sc.TC_N) == (16, 48) and img.dtype == torch.bfloat16
    for k, (dt, df) in enumerate(sc.TC_TAP_ORDER):
        assert torch.equal(img[k, :ch], taps[dt + 1, df + 1].to(torch.bfloat16))
    assert not img[9:].any() and not img[:, ch:].any()  # k 9-15 and channels ch-47 are zero
    assert sorted(sc.TC_TAP_ORDER) == [(dt, df) for dt in (-1, 0, 1) for df in (-1, 0, 1)]


def test_tap_image_round_trip_is_exact_for_bf16_taps():
    _, kernel = _inputs(3, 1, 3, 40)
    taps = sc.fold_stem_weights(kernel).to(torch.bfloat16).float()
    assert torch.equal(sc.unpack_tap_image(sc.pack_tap_image(taps), 45), taps)


def test_tap_image_refuses_more_channels_than_the_kernel_has():
    with pytest.raises(ValueError, match="48"):
        sc.pack_tap_image(torch.zeros((3, 3, 49)))


def test_packed_operand_packs_again_after_an_in_place_change():
    calls = []

    def pack(t):
        calls.append(1)
        return t * 2

    x = torch.ones(4)
    first = _build.packed_operand(pack, x)
    assert _build.packed_operand(pack, x) is first and len(calls) == 1
    x.add_(1)
    assert torch.equal(_build.packed_operand(pack, x), torch.full((4,), 4.0)) and len(calls) == 2
    y = torch.ones(4)
    assert torch.equal(_build.packed_operand(pack, y), torch.full((4,), 2.0)) and len(calls) == 3


# ---- the kernel's decomposition against the plain version and the Pallas stem ----


@pytest.mark.parametrize("t_frames", [9, 10, 11, 50, 100])
@pytest.mark.parametrize("n_mels", [40, 36])
def test_emulation_matches_plain_f32(t_frames, n_mels):
    mel, kernel = _inputs(t_frames * n_mels, 3, t_frames, n_mels)
    taps = sc.fold_stem_weights(kernel, n_mels=n_mels).to(torch.bfloat16).float()
    x = torch.from_numpy(mel).to(torch.bfloat16).float()
    ours, plain = emulate_tc(x, taps), sc.res8_stem_plain(x, taps)
    assert ours.shape == plain.shape == (3, t_frames // 3, n_mels // 4, 45)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=1e-5)


@pytest.mark.parametrize("t_frames", [9, 10, 11, 50, 100])
@pytest.mark.parametrize("n_mels", [40, 36])
def test_emulation_matches_plain_bf16(t_frames, n_mels):
    mel, kernel = _inputs(t_frames * n_mels + 1, 3, t_frames, n_mels)
    taps = sc.fold_stem_weights(kernel, n_mels=n_mels).to(torch.bfloat16).float()
    x = torch.from_numpy(mel).to(torch.bfloat16)
    ours, plain = emulate_tc(x, taps), sc.res8_stem_plain(x, taps)
    assert ours.dtype == plain.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), plain.float().numpy(), atol=_bf16_ulp(plain.float()))


@pytest.mark.parametrize("t_frames", [10, 41, 100])
def test_emulation_matches_pallas_bf16(t_frames):
    mel, kernel = _inputs(t_frames + 7, 2, t_frames, 40)
    mel16 = jnp.asarray(mel, jnp.bfloat16)
    pallas = np.asarray(
        res8_stem_pallas(mel16, jnp.asarray(jax_fold_stem_weights(kernel), jnp.bfloat16), interpret=True)
        .astype(jnp.float32)
    )
    taps = sc.fold_stem_weights(kernel).to(torch.bfloat16).float()
    ours = emulate_tc(torch.from_numpy(np.array(mel16.astype(jnp.float32))).to(torch.bfloat16), taps)
    assert ours.dtype == torch.bfloat16 and ours.shape == pallas.shape
    np.testing.assert_allclose(ours.float().numpy(), pallas, atol=_bf16_ulp(pallas))


@pytest.mark.parametrize("t_frames", [10, 41, 100])
def test_emulation_matches_pallas_f32(t_frames):
    """With bf16-valued mels and taps in float32, the kernel's products are
    exact and only the order of the float32 sums differs from the Pallas
    stem's."""
    mel, kernel = _inputs(t_frames + 11, 2, t_frames, 40)
    mel = np.array(jnp.asarray(mel, jnp.bfloat16).astype(jnp.float32))
    kernel = np.asarray(jnp.asarray(kernel, jnp.bfloat16).astype(jnp.float32))
    pallas = np.asarray(res8_stem_pallas(jnp.asarray(mel), jnp.asarray(jax_fold_stem_weights(kernel)), interpret=True))
    ours = emulate_tc(torch.from_numpy(mel), sc.fold_stem_weights(kernel))
    np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-5)


# ---- T2's W image ----


def test_fold_image_round_trip_holds_every_element_once():
    w = torch.arange(tk.STEM_K * 4 * tk.STEM_N, dtype=torch.float32).reshape(tk.STEM_K, -1) + 1
    img = tk.pack_fold_image(w)
    assert img.numel() == tk.FOLD_SLICES * tk.FOLD_K_PAD * 4 * tk.FOLD_SLICE
    back = tk.unpack_fold_image(img)
    assert torch.equal(back[: tk.STEM_K], w) and not back[tk.STEM_K :].any()  # k 120-127 zero
    assert int((img == 0).sum()) == tk.FOLD_SLICES * (tk.FOLD_K_PAD - tk.STEM_K) * 4 * tk.FOLD_SLICE
    assert torch.equal(torch.sort(img[img > 0]).values, w.reshape(-1))


@pytest.mark.parametrize("k,col", [(0, 0), (7, 1), (8, 33), (63, 511), (64, 512), (119, 2047), (100, 1234)])
def test_fold_image_places_an_element_where_the_descriptor_reads_it(k, col):
    w = torch.zeros((tk.STEM_K, 4 * tk.STEM_N))
    w[k, col] = 1.0
    (where,) = torch.nonzero(tk.pack_fold_image(w)).reshape(-1).tolist()
    j, s, nl = col // tk.STEM_N, col % tk.STEM_N // tk.FOLD_SLICE, col % tk.FOLD_SLICE
    n = tk.FOLD_SLICE * j + nl
    byte = s * 32768 + (k // 64) * 16384 + n * 128 + 16 * ((k % 64 // 8) ^ (n % 8)) + 2 * (k % 8)
    assert 2 * where == byte


def test_fold_image_of_bf16_weights_stays_bf16():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((tk.STEM_K, 4 * tk.STEM_N)).astype(np.float32) * 0.1).bfloat16()
    img = tk.pack_fold_image(w)
    assert img.dtype == torch.bfloat16 and torch.equal(tk.unpack_fold_image(img)[: tk.STEM_K], w)


# ---- what the CUDA sources share with Python ----


def _constants(name):
    src = (_build.CSRC / name).read_text()
    return src, {n: v for n, v in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, flags=re.M)}


def test_stem_tc_constants_are_the_cuda_source():
    src, c = _constants("stem_tc.cu")
    assert int(c["kN"]) == sc.TC_N and int(c["kMaxBins"]) == sc.TC_MAX_BINS
    assert "mma.sync.aligned.m16n8k16" in src and sc.TC_K == 16
    assert (int(c["kPoolT"]), int(c["kPoolF"])) == sc.TC_POOL
    dt = [int(v) for v in re.search(r"kTapDt\[9\] = \{([^}]*)\}", src).group(1).split(",")]
    df = [int(v) for v in re.search(r"kTapDf\[9\] = \{([^}]*)\}", src).group(1).split(",")]
    assert list(zip(dt, df)) == list(sc.TC_TAP_ORDER)
    # the entry refuses what stem_route refuses, and a block of the largest geometry fits a block's shared memory
    assert "n_mels % kPoolF != 0 || n_mels > kMaxBins || ch < 1 || ch > kN" in src
    rows, stride = 3 * int(c["kTile"]) + 2, sc.TC_MAX_BINS + 2 * int(c["kColPad"])
    assert rows * stride * 2 + int(c["kTile"]) * sc.TC_MAX_BINS // 4 * sc.TC_N * 2 + 16 <= int(c["kMaxSmem"])
    assert "kRows * row_stride(n_mels) * 2" in src and "kTile * (n_mels / kPoolF) * ch * 2 + 16" in src


def test_stem_fold_constants_are_the_cuda_source():
    src, c = _constants("stem_fold.cu")
    assert int(c["kKIn"]) == tk.STEM_K and int(c["kKPad"]) == tk.FOLD_K_PAD and int(c["kNOut"]) == tk.STEM_N
    assert int(c["kSliceCols"]) == tk.FOLD_SLICE and c["kSlices"] == "kNOut / kSliceCols"
    assert c["kWBlockBytes"] == "64 * kN * 2" and c["kN"] == "kJ * kSliceCols" and int(c["kJ"]) == 4
    header = (_build.CSRC / "hopper_async.cuh").read_text()  # the wgmma and swizzle helpers it includes
    assert '#include "hopper_async.cuh"' in src and "wgmma_m64n128k16(" in src and "desc_sw128(" in src
    assert "m64n128k16.f32.bf16.bf16" in header and "(static_cast<uint64_t>(1) << 62)" in header  # 128-byte swizzle
