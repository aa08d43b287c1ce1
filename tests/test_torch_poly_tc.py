"""The host side of the frontend study's polyphase kernel M3
(``csrc/micro_poly.cu``, ``wgmma`` with A read by descriptor) vs howl_tpu.

The kernel runs only on the card (tests/test_torch_gpu.py). Here:
- its W image (``pack_poly_w_image``): round trip, and every element where
  the B descriptor of its pass and k16 step reads it, W_0's and W_1's zero
  chunk rows zero;
- a torch emulation of its A: a tile's 130 hop rows rounded to bf16,
  chunk-major without swizzle (25 chunks of 8 samples and a chunk of zeros),
  rows past the clip zero; each warpgroup's operand for shift j and k16 step
  kk read back through the descriptor's offsets rebuilds hb[t0 + 64 wg + j +
  m, 16 kk + k], the zero chunk included;
- that emulation's whole product, 33 k16 steps a pass (13 + 13 + 7), two
  passes of 256 columns, every pass from zero, against ``poly_plain`` and
  against the JAX tool's recorded Pallas body in interpret mode, n_dots 1
  and 3, within 1e-5 of the output's largest magnitude (the bound of
  tests/test_torch_pallas_micro.py: only the order of the float32 sums
  differs);
- the constants that ``csrc/micro_poly.cu`` shares with Python, and
  ``csrc/micro_common.cuh`` holding only what the stream kernels use.
Inputs come from seeded numpy generators.
"""

import contextlib
import importlib
import io
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from howl_tpu_torch.ops import _build
from howl_tpu_torch.tools import frontend_micro_kernels as fm

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU_GEOM = fm.micro_geometry(4, 2.0)  # the JAX tool's CPU size: 4 clips of 2 s
S = 0.3125  # the nonzero scalar of the comparisons
HOP, TILE = 200, fm.POLY_FB
SPAN = TILE + 2  # hop rows a tile reads
STEPS = sum(fm.POLY_STEPS)  # 33 k16 steps a pass
STEP_ELEMS = 16 * fm.POLY_PASS_N  # bf16 elements of a step of the W image


def _seeded(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * np.float32(0.1)


def _w(seed) -> torch.Tensor:
    return torch.from_numpy(_seeded((512, 512), seed) * np.float32(4.0)).bfloat16()


def _step(q):
    """Shift j and k16 step kk of step q of a pass."""
    j = 0 if q < fm.POLY_STEPS[0] else 1 if q < sum(fm.POLY_STEPS[:2]) else 2
    return j, q - sum(fm.POLY_STEPS[:j])


# ---- W's image ----


def test_poly_k_rows_are_the_w_blocks_in_step_order():
    w = _w(1)
    kr = fm.poly_k_rows(w)
    assert tuple(kr.shape) == (16 * STEPS, 512) == (528, 512)
    assert torch.equal(kr[:200], w[:200]) and torch.equal(kr[208:408], w[200:400]) and torch.equal(kr[416:], w[400:])
    assert not kr[200:208].any() and not kr[408:416].any()  # the rows the zero chunk meets


def test_poly_w_image_round_trip_holds_every_element_once():
    w = torch.arange(512 * 512, dtype=torch.float32).reshape(512, 512) + 1
    img = fm.pack_poly_w_image(w)
    assert img.numel() == 2 * STEPS * STEP_ELEMS and torch.equal(fm.unpack_poly_w_image(img), w)
    assert int((img == 0).sum()) == 16 * 512 and torch.equal(img[img != 0].sort().values, w.reshape(-1))
    wb = _w(2)
    assert torch.equal(fm.unpack_poly_w_image(fm.pack_poly_w_image(wb)), wb)


def _b_read(img, hp, q):
    """The (16, 256) B operand of step q of pass hp as the K-major descriptor
    without swizzle reads it: start at the step, cores of 8 n by 8 k (128
    bytes), the next 8 k 4 KB further (leading offset), the next 8 n 128
    bytes further (stride offset)."""
    k = torch.arange(16)[:, None]
    n = torch.arange(fm.POLY_PASS_N)[None, :]
    return img[(hp * STEPS + q) * STEP_ELEMS + (k // 8) * 2048 + (n // 8) * 64 + (n % 8) * 8 + k % 8]


@pytest.mark.parametrize("row,col", [(0, 0), (7, 255), (8, 256), (199, 511), (200, 3), (399, 128), (400, 77),
                                     (511, 300), (263, 19)])
def test_poly_w_image_places_an_element_where_the_descriptor_reads_it(row, col):
    """W's row 200 j + 16 kk + k lies in step (j, kk) of pass col // 256 at k."""
    w = _w(3)
    img = fm.pack_poly_w_image(w)
    j, r = row // HOP, row % HOP
    q = sum(fm.POLY_STEPS[:j]) + r // 16
    assert _b_read(img, col // 256, q)[r % 16, col % 256] == w[row, col]


def test_poly_w_image_steps_hold_zeros_past_each_block():
    img = fm.pack_poly_w_image(_w(4))
    for hp in range(2):
        for j in (0, 1):  # step 12 of W_0 and W_1: samples 192-199, then the zero chunk's 8 rows
            assert not _b_read(img, hp, sum(fm.POLY_STEPS[:j]) + 12)[8:].any()


# ---- A, the tile's hop rows ----


def _a_buffer(h, s, b, t0, rows):
    """The tile's A buffer as the kernel rounds it: hop rows t0 .. t0 + 129 of
    clip b, bf16(h + s), rows at or past ``rows`` zero, chunk-major: element
    (r, 8 c + e) at c * 130 * 8 + r * 8 + e; chunk 25 zero."""
    span = torch.zeros((SPAN, fm.POLY_CHUNKS * 8), dtype=torch.bfloat16)
    n = max(0, min(SPAN, rows - t0))
    span[:n, :HOP] = (h[b, t0 : t0 + n] + s).to(torch.bfloat16)
    return span.reshape(SPAN, fm.POLY_CHUNKS, 8).permute(1, 0, 2).reshape(-1)


def _a_read(flat, wg, j, kk):
    """The (64, 16) A operand of warpgroup wg for shift j and step kk as its
    descriptor reads it: start at chunk 2 kk's column, row 64 wg + j; leading
    offset one chunk column (130 rows of 16 bytes), stride offset 128 bytes."""
    m = torch.arange(64)[:, None]
    k = torch.arange(16)[None, :]
    return flat[(2 * kk + k // 8) * SPAN * 8 + (64 * wg + j + m) * 8 + k % 8]


@pytest.mark.parametrize("t0,rows", [(0, 256), (128, 256), (0, 66), (128, 131), (0, 130)],
                         ids=["inside", "last-tile", "short-clip", "one-frame-tile", "exact-span"])
def test_a_read_by_descriptor_is_the_shifted_hop_rows(t0, rows):
    h = torch.from_numpy(_seeded((2, 258, HOP), 5))
    flat = _a_buffer(h, S, 1, t0, rows)
    hb = torch.zeros((SPAN + 2, 16 * fm.POLY_STEPS[0]), dtype=torch.bfloat16)  # samples and the zero chunk
    n = max(0, min(SPAN, rows - t0))
    hb[:n, :HOP] = (h[1, t0 : t0 + n] + S).to(torch.bfloat16)
    for wg in range(2):
        for j in range(3):
            for kk in range(fm.POLY_STEPS[j]):
                got = _a_read(flat, wg, j, kk)
                assert torch.equal(got, hb[64 * wg + j : 64 * wg + j + 64, 16 * kk : 16 * kk + 16]), (wg, j, kk)


# ---- the whole product ----


def emulate_m3(h, w, s, t_pad, n_dots):
    """The kernel's arithmetic tile by tile: A by descriptor, W from its
    image by descriptor, float32 sums over the 33 steps of a pass, every
    pass from zero, the last pass's columns 0-127 kept."""
    b_clips, rows, _ = h.shape
    img = fm.pack_poly_w_image(w)
    bs = [[_b_read(img, hp, q).float() for q in range(STEPS)] for hp in range(2)]
    out = torch.zeros((b_clips, t_pad, fm.OUT_COLS))
    for b in range(b_clips):
        for t0 in range(0, t_pad, TILE):
            flat = _a_buffer(h, s, b, t0, rows)
            for wg in range(2):
                for _ in range(n_dots):
                    passes = []
                    for hp in range(2):
                        acc = torch.zeros((64, fm.POLY_PASS_N))
                        for q in range(STEPS):
                            acc += _a_read(flat, wg, *_step(q)).float() @ bs[hp][q]
                        passes.append(acc)
                n = min(64, t_pad - t0 - 64 * wg)
                if n > 0:
                    out[b, t0 + 64 * wg : t0 + 64 * wg + n] = passes[0][:n, : fm.OUT_COLS]
    return out


@pytest.mark.parametrize("n_dots", [1, 3])
@pytest.mark.parametrize("batch,rows,t_pad", [(4, 256, 128), (1, 131, 129), (2, 102, 100), (1, 66, 64)],
                         ids=["cpu-study", "one-frame-in-the-last-tile", "t_pad-plus-2-rows", "short"])
def test_emulation_matches_plain(batch, rows, t_pad, n_dots):
    h = torch.from_numpy(_seeded((batch, rows, HOP), 6 + rows))
    w = _w(7)
    want = fm.poly_plain(h, w, S, t_pad, n_dots)
    got = emulate_m3(h, w, S, t_pad, n_dots)
    assert got.shape == want.shape == (batch, t_pad, fm.OUT_COLS) and float(want.abs().max()) > 1.0
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.fixture(scope="module")
def recorded():
    """The JAX tool's pallas_call calls at its CPU size (tests/test_torch_pallas_micro.py's recorder):
    stream, gemm x1 and x3, poly x1 and x3."""
    calls = []

    def recorder(kernel, **kw):
        def run(*args):
            calls.append((kernel, kw, args))
            return jnp.zeros(kw["out_shape"].shape, kw["out_shape"].dtype)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(TOOLS))
        mp.setattr(pl, "pallas_call", recorder)
        tool = importlib.import_module("bench_pallas_micro")
        with contextlib.redirect_stdout(io.StringIO()):
            tool.main()
    sys.modules.pop("bench_pallas_micro", None)
    assert len(calls) == 5
    return calls


def _torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("n_dots", [1, 3])
def test_emulation_matches_the_pallas_kernel(recorded, n_dots):
    kernel, kw, args = recorded[3 if n_dots == 1 else 4]
    g = CPU_GEOM
    h = _seeded((g.batch, g.rows, g.hop), 23)
    w_js = args[2:5]
    want = np.asarray(pl.pallas_call(kernel, **kw, interpret=True)(
        jnp.asarray(h), jnp.asarray(h), *w_js, jnp.asarray([S], jnp.float32)))
    w = torch.cat([_torch_bf16(wj) for wj in w_js])[: g.n_fft]  # the blocks stacked are W over its zero rows
    got = emulate_m3(torch.from_numpy(h), w, S, g.t_pad, n_dots).numpy()
    assert got.shape == want.shape == (g.batch, g.t_pad, fm.OUT_COLS) and np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---- what the CUDA sources share with Python ----


def _constants(name):
    src = (_build.CSRC / name).read_text()
    return src, {n: v for n, v in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, flags=re.M)}


def test_micro_poly_constants_are_the_cuda_source():
    src, c = _constants("micro_poly.cu")
    assert int(c["kTile"]) == fm.POLY_FB and c["kSpanRows"] == "kTile + 2" and int(c["kHop"]) == HOP
    assert int(c["kPassN"]) == fm.POLY_PASS_N and int(c["kChunks"]) == fm.POLY_CHUNKS and int(c["kOutCols"]) == fm.OUT_COLS
    assert (int(c["kSteps01"]), int(c["kSteps01"]), int(c["kSteps2"])) == fm.POLY_STEPS
    assert c["kSteps"] == "2 * kSteps01 + kSteps2" and c["kStepBytes"] == "16 * kPassN * 2"
    assert c["kChunkBytes"] == "kSpanRows * 16" and c["kABytes"] == "kChunks * kChunkBytes"
    # W stages end on whole steps and H stages on whole rows; the next tile's H stages are all rounded during
    # this tile's first two passes, so n_dots 1 stages a tile ahead too
    w_stages, h_stages = STEPS // int(c["kStageSteps"]), SPAN // int(c["kHRows"])
    assert w_stages * int(c["kStageSteps"]) == STEPS and h_stages * int(c["kHRows"]) == SPAN
    assert h_stages * (2 * w_stages // h_stages) <= 2 * w_stages
    assert "wgmma_m64n256k16_ss" in src and "bulk_load" in src and "__fadd_rn" in src and "__floats2bfloat162_rn" in src
    assert "mma.sync" not in src and "ldmatrix" not in src and '#include "micro_common.cuh"' not in src


def test_micro_common_keeps_only_what_the_stream_kernels_use():
    header = (_build.CSRC / "micro_common.cuh").read_text()
    for gone in ("product_512", "ldmatrix", "mma.sync", "stage_convert", "kBStride", "kRingBytes"):
        assert gone not in header, gone
    for kept in ("void stage_f32(", "void cp_async16(", "kStageFloats = 8192", "kOutCols = 128", "kNfft = 512"):
        assert kept in header, kept
    users = sorted(p.name for p in _build.CSRC.glob("*.cu") if '#include "micro_common.cuh"' in p.read_text())
    assert users == ["micro_stream.cu"]
    stream = (_build.CSRC / "micro_stream.cu").read_text()
    assert "stage_f32(" in stream and "kStageFloats" in stream
