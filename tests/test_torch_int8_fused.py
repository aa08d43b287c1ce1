"""The fused int8 trunk's host side (howl_tpu_torch/ops/int8_trunk.py,
csrc/int8_trunk_fused.cu), on the CPU: the packed weight image, the kernel's
walk over its s8 slot rows, the tile schedule with a shrinking halo, the
route and the wrapper.

The kernel runs only on a card (tests/test_torch_gpu.py holds it against the
plain version there). Here its decomposition is emulated in torch and held
against the plain version and howl_tpu's int8 trunk. Inputs are seeded numpy.

Tolerances:
* the s32 sums of the emulated walk: exact (integers), against
  ``int8_conv_sums_plain``;
* the emulated tile schedule: bit for bit against
  ``residual_features_int8_plain`` (the same operations on the same values);
* against howl_tpu's ``residual_features_int8`` at the same activation
  scales: float32 within 1e-5 absolute, bf16 within 2 bf16 ulps of each
  output (tests/test_torch_int8_trunk.py's bounds and reasons).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import int8_trunk as jint8
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.ops import int8_trunk as tint8
from howl_tpu_torch.tools import probe_kernel_variants as probe
from tests.test_torch_engine import _variables

torch.set_num_threads(1)

SOURCE = Path(tint8.__file__).resolve().parent.parent / "csrc" / "int8_trunk_fused.cu"
TT = tint8.FUSED_TILE_FRAMES
HALO = tint8.FUSED_HALO


def _bf16_ulps(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the magnitude of each element (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _s8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.fixture(scope="module")
def weights():
    variables = _variables(51)
    return variables, res8_variables_to_state_dict(variables)


def _params(state, seed, shape, scale=1.0):
    """Quantized params with the activation scales calibrated on relu'd
    normal activations of ``shape`` (some saturate: the margin is 1.1)."""
    y = np.maximum(np.random.default_rng(seed).standard_normal(shape), 0).astype(np.float32) * scale
    return y, tint8.quantize_residual_trunk(state, tint8.calibrate_act_scales(torch.from_numpy(y), state))


# ---- the packed image ----


def _image_as_b(img: torch.Tensor) -> torch.Tensor:
    """The (14, 32, 48) B operand of each k32 step, read from the image as
    the kernel's K-major descriptors read it: k core kc at 768 bytes, n core
    nc at 128, byte 16 (n % 8) + k % 16."""
    s, k, n = torch.meshgrid(torch.arange(14), torch.arange(32), torch.arange(48), indexing="ij")
    at = s * tint8.FUSED_STEP_BYTES + (k // 16) * 768 + (n // 8) * 128 + (n % 8) * 16 + k % 16
    return img.view(torch.int8)[at]


@pytest.mark.parametrize("c", [45, 48, 13])
def test_pack_w_image_wgmma_places_every_weight_once(c):
    w = _s8(np.random.default_rng(c), (3, 3, c, c))
    img = tint8.pack_w_image_wgmma(w)
    assert img.dtype == torch.uint8 and img.numel() == tint8.FUSED_W_IMAGE_BYTES == 21504
    b = _image_as_b(img)
    want = torch.zeros((14, 32, 48), dtype=torch.int8)
    for step in range(14):
        for half, core in enumerate(tint8.fused_step_cores(step)):
            if core is None:
                continue  # the last step's second core: 16 zero rows
            tap, column = divmod(core, 3)
            full = torch.zeros((48, 48), dtype=torch.int8)
            full[:c, :c] = w[tap // 3, tap % 3]
            want[step, 16 * half : 16 * half + 16] = full[16 * column : 16 * column + 16]
    assert torch.equal(b, want)
    # every weight once, every other byte zero
    assert int((img != 0).sum()) == int((w != 0).sum())
    assert sorted(img.view(torch.int8)[img != 0].tolist()) == sorted(w[w != 0].tolist())


def test_pack_w_image_wgmma_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="int8"):
        tint8.pack_w_image_wgmma(torch.zeros((3, 3, 45, 45)))
    with pytest.raises(ValueError, match="48 channels"):
        tint8.pack_w_image_wgmma(torch.zeros((3, 3, 49, 49), dtype=torch.int8))


# ---- the kernel's walk: slot rows, chunk columns, taps as descriptor starts ----


def _slot_buffer(xq: torch.Tensor, b: int, a: int, tt: int, garbage: torch.Tensor) -> torch.Tensor:
    """Buffer 0 of the tile at frame a as the kernel's quantize pass leaves it,
    and the next region of shared memory after it: (4 columns, rows, 16
    bytes), row kGuard + q for tile row q (frame a - 6 + q // (F + 2), slot
    q % (F + 2)), the channels 16 k .. 16 k + 15 of a position in column k,
    zeros in the slots, past C and outside the clip; the guard, the rows past
    the span and the fourth column keep whatever ``garbage`` holds."""
    _, t_n, f_n, c = xq.shape
    s = f_n + 2
    buf = garbage.clone()
    span = torch.zeros((tt + 2 * HALO, s, 48), dtype=torch.int8)
    lo, hi = max(a - HALO, 0), min(a + tt + HALO, t_n)
    span[lo - (a - HALO) : hi - (a - HALO), 1 : f_n + 1, :c] = xq[b, lo:hi]
    rows = span.reshape(-1, 48)
    for k in range(3):
        buf[k, tint8.FUSED_GUARD : tint8.FUSED_GUARD + rows.shape[0]] = rows[:, 16 * k : 16 * k + 16]
    return buf


def _tap_rows(tap: int, s: int) -> int:
    return s * (tap // 3 - 1) + (tap % 3 - 1)


def _walk(buf: torch.Tensor, img: torch.Tensor, n_f: int, first: int, count: int) -> torch.Tensor:
    """Layer rows [first, first + count) of the kernel's products, in whole
    m64 tiles as the warpgroups take them, read as the kernel's descriptors
    address shared memory: for each of the 14 k32 steps, A's first k core is
    its core's column at its tap's row shift (F + 2) dt + df, the second k
    core the leading offset further on, computed as the kernel computes it
    (a column on; two columns on less the taps' shift where the step
    crosses taps), and B is read from the image; s32 sums (rows, 48)."""
    s = n_f + 2
    col_bytes = buf.shape[1] * 16
    flat = buf.reshape(-1)
    b_steps = _image_as_b(img).long()
    rows = first + torch.arange(64 * ((count + 63) // 64))
    acc = torch.zeros((rows.numel(), 48), dtype=torch.long)
    for step in range(14):
        core, second = tint8.fused_step_cores(step)
        tap = core // 3
        crosses = second is not None and second < core
        lead = 2 * col_bytes - 16 * (_tap_rows(tap, s) - _tap_rows(tap - 1, s)) if crosses else col_bytes
        start = (core % 3) * col_bytes + (tint8.FUSED_GUARD + rows + _tap_rows(tap, s)) * 16
        k = torch.arange(16)
        a = torch.cat([flat[start[:, None] + k], flat[start[:, None] + lead + k]], dim=1).long()  # k cores 0, 1
        if second is not None:  # where the core is real, the offset lands on its column at its tap's shift
            want = (second % 3) * col_bytes + (tint8.FUSED_GUARD + rows + _tap_rows(second // 3, s)) * 16
            assert torch.equal(start + lead, want), step
        acc += a @ b_steps[step]
    return acc[:count]


@pytest.mark.parametrize("t_n", [1, 5, 42, 43, 44, 45, 213])
@pytest.mark.parametrize("n_f", [8, 10])
def test_kernel_walk_gives_the_exact_sums(t_n, n_f):
    """Layer 1 of every tile through the emulated walk equals the plain s32
    sums at every position of its frames inside the clip, with garbage in
    the rows the span does not fill."""
    rng = np.random.default_rng(t_n * 10 + n_f)
    xq = _s8(rng, (2, t_n, n_f, 45))
    w = _s8(rng, (3, 3, 45, 45))
    want = tint8.int8_conv_sums_plain(xq, w)
    img = tint8.pack_w_image_wgmma(w)
    tt, s = TT[torch.bfloat16], n_f + 2
    first, count = tint8.fused_layer_rows(1, n_f, tt)
    n_rows = tint8.FUSED_GUARD + first + 64 * ((count + 63) // 64) + s + 1
    seen = torch.zeros((2, t_n), dtype=torch.bool)
    for b in range(2):
        for a in range(0, t_n, tt):
            garbage = _s8(rng, (4, n_rows, 16))
            acc = _walk(_slot_buffer(xq, b, a, tt, garbage), img, n_f, first, count)
            q = first + torch.arange(count)
            fr, slot = a - HALO + q // s, q % s
            keep = (slot >= 1) & (slot <= n_f) & (fr >= 0) & (fr < t_n)
            got = acc[keep, :45].int()
            assert torch.equal(got, want[b, fr[keep], slot[keep] - 1]), (b, a)
            seen[b, fr[keep].unique()] = True
    assert bool(seen.all())


# ---- the tile schedule with a shrinking halo ----


def _halo_trunk(y: torch.Tensor, p, cdt, tt: int, zero_outside: bool = True) -> torch.Tensor:
    """The fused kernel's schedule in plain torch: tiles of ``tt`` frames;
    the tile at frame a takes frames [a - 6, a + tt + 6) of y (zeros outside
    the clip), and layer L, ``int8_conv_layer_plain`` on its input's frames,
    keeps frames [a - 6 + L, a + tt + 6 - L): one frame less each side. After
    every layer the frames outside the clip are zeroed (SAME padding), as the
    kernel's epilogue writes them back as zeros. The residual is y, then the
    pre-BN sums of layers 2 and 4, over the same frames."""
    x_all = y.to(cdt)
    b_n, t_n, f_n, c = x_all.shape
    out = torch.empty_like(x_all)
    for b in range(b_n):
        for a in range(0, t_n, tt):
            lo = a - HALO
            frames = torch.arange(lo, a + tt + HALO)
            inside = (frames >= 0) & (frames < t_n)
            x = torch.zeros((1, frames.numel(), f_n, c), dtype=cdt)
            x[0, inside] = x_all[b, frames[inside]]
            res = x.clone()  # frame-indexed from lo: y, then pre_2, then pre_4
            for i in range(tint8.N_LAYERS):
                n = x.shape[1]
                start = i  # x holds frames [lo + i, lo + i + n)
                residual = res[:, start : start + n] if (i + 1) % 2 == 0 else None
                o, pre = tint8.int8_conv_layer_plain(x, p.w_i8[i], p.act_scale[i], p.w_scale[i], p.bn_scale[i],
                                                     p.bn_shift[i], residual)
                x = o[:, 1:-1].clone()
                if zero_outside:
                    x[0, ~inside[start + 1 : start + n - 1]] = 0
                if (i + 1) in (2, 4):
                    res[:, start + 1 : start + n - 1] = pre[:, 1:-1]
            keep = min(tt, t_n - a)
            out[b, a : a + keep] = x[0, :keep]
    return out


def _schedule_cases():
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tt = TT[dtype]
        for t_n in (1, 5, tt - 1, tt, tt + 1, 2 * tt + 1, 2 * tt - 1):
            cases.append((dtype, t_n))
    return cases


@pytest.mark.parametrize("n_f", [10, 8])
@pytest.mark.parametrize("dtype,t_n", _schedule_cases(), ids=lambda v: str(v).replace("torch.", ""))
def test_halo_schedule_equals_the_plain_trunk(weights, dtype, t_n, n_f):
    _, state = weights
    y, p = _params(state, t_n * 7 + n_f, (2, t_n, n_f, 45), 1.5)
    y = torch.from_numpy(y)
    want = tint8.residual_features_int8_plain(y, p, dtype)
    got = _halo_trunk(y, p, dtype, TT[dtype])
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_halo_schedule_needs_the_out_of_clip_rows_zeroed_after_every_layer(weights, dtype):
    """The trap: zeroing the frames outside the clip only in layer 1's input
    is not enough. Without the zeros after every layer the tiles at the
    clip's ends come out wrong."""
    _, state = weights
    t_n = TT[dtype] + 1
    y, p = _params(state, 3, (1, t_n, 10, 45), 1.5)
    y = torch.from_numpy(y)
    want = tint8.residual_features_int8_plain(y, p, dtype)
    wrong = _halo_trunk(y, p, dtype, TT[dtype], zero_outside=False)
    bad = (wrong != want).flatten(2).any(-1)[0]
    assert bool(bad[0]) and bool(bad[-1])  # the first and the last frame of the clip


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_n", [5, 44, 45])
def test_halo_schedule_matches_jax(weights, dtype, t_n):
    variables, state = weights
    y = (np.random.default_rng(t_n).standard_normal((2, t_n, 10, 45)) * 0.5).astype(np.float32)
    scales = jint8.calibrate_act_scales(jnp.asarray(y), variables)  # the same scales on both sides
    jdt, tdt = (None, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jint8.residual_features_int8(jnp.asarray(y), jint8.quantize_residual_trunk(variables, scales),
                                                   compute_dtype=jdt).astype(jnp.float32))
    got = _halo_trunk(torch.from_numpy(y), tint8.quantize_residual_trunk(state, scales), tdt, TT[tdt]).float().numpy()
    err = np.abs(got - want)
    if dtype == "f32":
        assert err.max() <= 1e-5
    else:
        assert (err <= 2 * _bf16_ulps(want)).all(), err.max()


def test_tiles_cover_the_serving_clip_with_little_halo():
    """213 frames: 5 bf16 tiles of 43 (215 frames), 9 float32 tiles of 24
    (216). A tile's six layers compute tt + 5 frames each on average: 12 % more
    than the bf16 tile keeps, 21 % more than the float32 one."""
    assert -(-213 // TT[torch.bfloat16]) == 5 and -(-213 // TT[torch.float32]) == 9
    for dtype, extra in ((torch.bfloat16, 0.12), (torch.float32, 0.21)):
        tt = TT[dtype]
        frames = [tint8.fused_layer_rows(layer, 10, tt)[1] / 12 for layer in range(1, 7)]
        assert frames == [tt + 12 - 2 * layer for layer in range(1, 7)]
        assert sum(frames) / 6 / tt == pytest.approx(1 + extra, abs=0.005)


# ---- the route, the shared memory, the constants of the source ----


def test_route_table():
    bf16, f32 = torch.bfloat16, torch.float32
    assert tint8.int8_trunk_route(bf16, 10, 45) == "fused"  # the serving geometry
    assert tint8.int8_trunk_route(f32, 10, 45) == "fused"
    assert tint8.int8_trunk_route(bf16, 8, 45) == tint8.int8_trunk_route(f32, 8, 48) == "fused"
    assert tint8.int8_trunk_route(bf16, 11, 45) == "fused"  # bf16 holds one bin more than float32
    for dtype, n_f, c in ((bf16, 12, 45), (f32, 11, 45), (bf16, 17, 45), (bf16, 64, 45), (bf16, 10, 49),
                          (torch.float16, 10, 45)):
        assert tint8.int8_trunk_route(dtype, n_f, c) == "layer", (dtype, n_f, c)


def test_shared_bytes_of_the_serving_geometry():
    """Two weight slots, two s8 buffers (3 columns of 696 rows in bf16, 480 in
    float32), y's staging run, the residual over layer 2's frames (each
    region a multiple of 128 bytes), the tables and the barriers; under
    227 KB."""
    assert 6 * 51 * 10 * 8 * 2 == 48960  # the bf16 residual, 49,024 rounded up
    assert tint8.fused_shared_bytes(torch.bfloat16, 10, 45) == (
        2 * 21504 + 2 * 3 * 696 * 16 + 49536 + 49024 + 3456 + 16) == 211856
    assert tint8.fused_shared_bytes(torch.float32, 10, 45) == (
        2 * 21504 + 2 * 3 * 480 * 16 + 64896 + 6 * 32 * 10 * 8 * 4 + 3456 + 16) == 218896
    assert all(tint8.fused_shared_bytes(torch.bfloat16, n_f, c) <= tint8.MAX_SHARED_BYTES
               for n_f in range(1, 11) for c in range(1, 49))
    assert tint8.fused_shared_bytes(torch.bfloat16, 10, 0) is None


def test_constants_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))

    assert const("kHalo") == HALO and const("kCores") == tint8.FUSED_CORES and const("kGuard") == tint8.FUSED_GUARD
    assert "constexpr int kSteps = (kCores + 1) / 2;" in src and tint8.FUSED_K_STEPS == 14
    assert const("kCPad") == tint8.C_PAD and const("kMaxSmem") == tint8.MAX_SHARED_BYTES
    tiles = re.findall(r"struct Tile<(\w+)> \{\s*static constexpr int kT = (\d+), kWG = \d+;", src)
    assert {k: int(v) for k, v in tiles} == {"__nv_bfloat16": TT[torch.bfloat16], "float": TT[torch.float32]}
    # the step's first core: the later one where the pair crosses taps, as fused_step_cores gives it
    assert "return (2 * s) % 3 == 2 && 2 * s + 1 < kCores;" in src and "step_crosses(s) ? 2 * s + 1 : 2 * s" in src
    assert "m64n48k32.s32.s8.s8" in (SOURCE.parent / "hopper_async.cuh").read_text()


def test_kernel_conversions_by_float_addition_are_exact():
    """The epilogue's two integer conversions, in float32 arithmetic as the
    kernel does them: max(a, 0) as 2^23 + a less 2^23 for every sum the
    convs can give, and the quantize as the low byte of 1.5 x 2^23 + clip(x)
    against clip(round_half_even(x)), ties included."""
    a = np.concatenate([np.arange(-300, 70000), np.arange(6532245 - 70000, 6532246)]).astype(np.int32)
    as_float = (np.maximum(a, 0) + 0x4B000000).view(np.float32) - np.float32(8388608.0)
    np.testing.assert_array_equal(as_float, np.maximum(a, 0).astype(np.float32))
    rng = np.random.default_rng(0)
    x = np.concatenate([np.arange(-260, 261) / 2, rng.uniform(-200, 200, 100000), [1e30, -1e30, 126.5, -127.5]])
    x = x.astype(np.float32)
    low_byte = ((np.clip(x, -127, 127) + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(low_byte, np.clip(np.round(x), -127, 127).astype(np.int8))


@pytest.mark.parametrize("variant", sorted(probe.INT8_FUSED_EDITS))
def test_probe_variants_edit_the_source_once(variant):
    """Each variant of the kernel's probe applies to the source as it is."""
    source, edits, _ = probe.PROBES["int8-fused"]
    assert source == SOURCE
    text = probe.apply_edits(SOURCE.read_text(), probe.INT8_FUSED_EDITS[variant], variant)
    assert (text == SOURCE.read_text()) == (variant == "as it is")


# ---- the wrapper and the route on the CPU ----


def test_fused_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing(weights):
    _, state = weights
    y, p = _params(state, 9, (2, 9, 10, 45))
    y = torch.from_numpy(y)
    before = tint8.int8_trunk_fused_cuda.launches
    for dtype in (None, torch.bfloat16):
        got = tint8.int8_trunk_fused_cuda(y, p, dtype)
        assert got.dtype == (dtype or torch.float32)
        assert torch.equal(got, tint8.residual_features_int8_plain(y, p, dtype))
    assert tint8.int8_trunk_fused_cuda.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        tint8.int8_trunk_fused_cuda(y.clone().requires_grad_(), p)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tint8.int8_trunk_fused_cuda(y.to("meta"), p)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_residual_features_int8_follows_the_route_and_route_forces_one(weights, monkeypatch, dtype):
    _, state = weights
    y, p = _params(state, 11, (1, 7, 10, 45))
    y = torch.from_numpy(y)
    calls = {"fused": 0, "layer": 0}
    fused, layer = tint8.int8_trunk_fused_cuda, tint8.int8_conv_layer_cuda

    def count_fused(*a, **kw):
        calls["fused"] += 1
        return fused(*a, **kw)

    def count_layer(*a, **kw):
        calls["layer"] += 1
        return layer(*a, **kw)

    monkeypatch.setattr(tint8, "int8_trunk_fused_cuda", count_fused)
    monkeypatch.setattr(tint8, "int8_conv_layer_cuda", count_layer)
    want = tint8.residual_features_int8_plain(y, p, dtype)
    assert torch.equal(tint8.residual_features_int8(y, p, dtype), want) and calls == {"fused": 1, "layer": 0}
    assert torch.equal(tint8.residual_features_int8(y, p, dtype, route="layer"), want)
    assert calls == {"fused": 1, "layer": 6}
    assert torch.equal(tint8.residual_features_int8(y, p, dtype, route="fused"), want) and calls["fused"] == 2
    # a geometry the fused kernel does not hold goes to the layer kernel
    wide = torch.from_numpy(_params(state, 12, (1, 3, 12, 45))[0])
    tint8.residual_features_int8(wide, p, dtype)
    assert calls == {"fused": 2, "layer": 12}
    with pytest.raises(ValueError, match="route must be one of"):
        tint8.residual_features_int8(y, p, dtype, route="cudnn")
