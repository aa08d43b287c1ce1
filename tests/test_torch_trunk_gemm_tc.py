"""The host side of the tensor-core trunk proto T1 (``csrc/trunk_proto.cu``)
and of the frontend study's GEMM M2 (``csrc/micro_gemm.cu``) vs howl_tpu.

The kernels run only on the card (tests/test_torch_gpu.py). Here:
- T1's weight image and pool image (each thread's ``wgmma`` A fragments),
  round trips and the places the kernel reads;
- a torch emulation of T1's activation layout: 12 slot rows a pooled frame
  (zero slots each side of its 10 positions), chunk-major 16-byte rows, and
  the nine taps as start offsets 12 dt + df of one descriptor, which must
  build ``_taps_im2col`` exactly;
- a torch emulation of the whole kernel, tile by tile with the shrinking
  halo (layer L computes frames [a - 5 + L, a + 49 - L) of the tile at frame
  a), its two buffers and the pool product over slot rows, against
  ``trunk_proto_plain`` in float32 within 1e-5 of the output's largest
  magnitude (only the order of the float32 sums may differ; r6 too, for pos
  values that cut a tile) and against the JAX tool's Pallas body in
  interpret mode within 2e-3 (tests/test_torch_trunk_micro.py's bound: bf16
  x and res after every layer, sums in other orders);
- M2's swizzled W image and its A image, into which the kernel rounds
  x + s (ties to even);
- the constants the CUDA sources share with Python, and the probe tool's
  rule that an edit's text must occur once in the source it patches.
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
import torch.nn.functional as F
from jax.experimental import pallas as pl

from howl_tpu_torch.ops import _build
from howl_tpu_torch.tools import frontend_micro_kernels as fm
from howl_tpu_torch.tools import probe_kernel_variants as probe
from howl_tpu_torch.tools import trunk_kernels as tk

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
T, S = tk.TRUNK_TILE, tk.TRUNK_SLOTS
K_STEPS = tk.TRUNK_POOL_STEPS  # k16 steps of a tile's pool product


def _trunk_operands(seed, b, pos_pad, n_win_pad=128, tail=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, pos_pad, 48)).astype(np.float32) * 0.5
    ws = rng.standard_normal((6, 432, 48)).astype(np.float32) * 0.05
    pool_t = (rng.uniform(size=(n_win_pad, pos_pad)) < 0.05).astype(np.float32)
    scale = rng.uniform(0.8, 1.0, (8, 48)).astype(np.float32)
    shift = rng.uniform(-0.05, 0.05, (8, 48)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    if not tail:
        xt[:, -7:] = 0
    return xt, torch.from_numpy(ws).bfloat16(), torch.from_numpy(pool_t).bfloat16(), torch.from_numpy(scale), \
        torch.from_numpy(shift)


# ---- T1's images ----


def test_trunk_w_image_round_trip_and_places():
    ws = torch.arange(6 * 432 * 48, dtype=torch.float32).reshape(6, 432, 48)
    img = tk.pack_trunk_w_image(ws)
    assert img.numel() == 6 * 432 * 48 and torch.equal(tk.unpack_trunk_w_image(img), ws)
    for layer, k, n in [(0, 0, 0), (1, 7, 9), (2, 8, 47), (5, 431, 40), (3, 200, 17)]:
        assert img[layer * 20736 + (k // 8) * 384 + (n // 8) * 64 + (n % 8) * 8 + k % 8] == ws[layer, k, n]


@pytest.mark.parametrize("pos_pad,n_tiles", [(16, 1), (440, 1), (448, 2), (640, 2), (2176, 5), (2640, 6)])
def test_trunk_tiles_cover_the_clip(pos_pad, n_tiles):
    assert tk.trunk_tiles(pos_pad) == n_tiles
    p, valid = tk.trunk_slot_rows(pos_pad)
    assert torch.equal(p[valid], torch.arange(pos_pad))  # every position once, in order


def _pool_from_fragments(img, n_tiles):
    """The (128, n_tiles * 528) A of the pool product as the kernel's threads
    hold it: for tile j, step ks and warpgroup wg, thread 32 w + 4 g + t loads
    the 16 bytes at ((j * 33 + ks) * 2 + wg) * 128 + its index, registers e =
    0..3 of two bf16 each; a0 = A[16 w + g][2t, 2t + 1], a1 = A[16 w + g +
    8][2t, 2t + 1], a2 = A[16 w + g][2t + 8, 2t + 9], a3 = A[16 w + g + 8][2t +
    8, 2t + 9] (hopper_async.cuh)."""
    f = img.reshape(n_tiles, K_STEPS, 2, 128, 4, 2)
    a = torch.zeros((128, n_tiles * T * S), dtype=img.dtype)
    thr = torch.arange(128)
    w, g, t = thr // 32, thr % 32 // 4, thr % 4
    j = torch.arange(n_tiles)[:, None, None]
    ks = torch.arange(K_STEPS)[None, :, None]
    for wg in range(2):
        for e in range(4):
            for h in range(2):
                rows = (64 * wg + 16 * w + g + 8 * (e % 2))[None, None, :]
                cols = T * S * j + 16 * ks + (2 * t + 8 * (e // 2) + h)[None, None, :]
                a[rows.expand(n_tiles, K_STEPS, 128), cols.expand(n_tiles, K_STEPS, 128)] = f[:, :, wg, :, e, h]
    return a


@pytest.mark.parametrize("n_win_pad,pos_pad", [(128, 2176), (128, 640), (64, 448), (16, 16)])
def test_trunk_pool_image_holds_pool_t_on_the_slot_rows(n_win_pad, pos_pad):
    rng = np.random.default_rng(pos_pad)
    pool_t = torch.from_numpy(rng.standard_normal((n_win_pad, pos_pad)).astype(np.float32)).bfloat16()
    img = tk.pack_trunk_pool_image(pool_t)
    n_tiles = tk.trunk_tiles(pos_pad)
    assert img.dtype == torch.bfloat16 and img.numel() == n_tiles * K_STEPS * 2 * 128 * 8
    back = tk.unpack_trunk_pool_image(img, pos_pad)
    assert torch.equal(back[:n_win_pad], pool_t) and not back[n_win_pad:].any()
    a = _pool_from_fragments(img, n_tiles)
    p, valid = tk.trunk_slot_rows(pos_pad)
    assert torch.equal(a[:n_win_pad, valid], pool_t[:, p[valid]])
    assert not a[:, ~valid].any() and not a[n_win_pad:].any()


# ---- T1's activation layout ----


def _slot_rows(x, frame0, n_frames, pos_pad):
    """(B, P, 48) -> (B, 12 n_frames, 48): frames [frame0, frame0 + n_frames)
    in slot rows, zero at the slots and outside [0, pos_pad)."""
    q = torch.arange(S * n_frames)
    fr, slot = frame0 + q // S, q % S
    p = fr * tk.F_OUT + slot - 1
    valid = (slot >= 1) & (slot <= tk.F_OUT) & (fr >= 0) & (p < pos_pad)
    out = torch.zeros((x.shape[0], q.numel(), x.shape[2]), dtype=x.dtype)
    out[:, valid] = x[:, p[valid]]
    return out


def _chunk_major(rows):
    """(R, 48) -> the flat buffer: element (r, c) at (c // 8) * R * 8 + r * 8 + c % 8."""
    return rows.reshape(rows.shape[0], 6, 8).permute(1, 0, 2).reshape(-1)


def _descriptor_read(flat, n_buf_rows, start, n_rows, k0):
    """The (n_rows, 16) A operand of one k16 step as a K-major descriptor
    without swizzle reads it: core matrices of 8 rows by 8 k, 128 contiguous
    bytes from row ``start`` of chunk k0 // 8, the next 8 k one chunk column
    (the leading offset) further, the next 8 rows 128 bytes further (the
    stride offset)."""
    m = torch.arange(n_rows)[:, None]
    k = torch.arange(16)[None, :]
    return flat[(k0 // 8 + k // 8) * n_buf_rows * 8 + (start + m) * 8 + k % 8]


@pytest.mark.parametrize("pos_pad", [640, 2176, 32])
def test_slot_layout_taps_are_start_offsets_building_the_im2col(pos_pad):
    x, *_ = _trunk_operands(pos_pad, 2, pos_pad)
    n_frames = -(-pos_pad // tk.F_OUT)
    want = tk._taps_im2col(x)
    p, valid = tk.trunk_slot_rows(pos_pad)
    p, valid = p[: S * n_frames], valid[: S * n_frames]
    for i in range(x.shape[0]):
        rows = F.pad(_slot_rows(x[i : i + 1], -1, n_frames + 2, pos_pad)[0], (0, 0, 1, 1))  # a guard row each end
        flat, n_buf = _chunk_major(rows), rows.shape[0]
        first = 1 + S  # frame 0, slot 0
        cols = []
        for ks in range(27):
            dt, df = tk.TAPS[ks // 3]
            cols.append(_descriptor_read(flat, n_buf, first + S * dt + df, S * n_frames, 16 * (ks % 3)))
        im = torch.cat(cols, dim=1)  # (12 n_frames, 432) in the kernel's k order: tap, then channel
        assert torch.equal(im[valid], want[i, p[valid]])


# ---- T1's whole schedule ----


def _kernel_roles(layer, full_build):
    """(taps' buffer, res's buffer, the buffer written, whether it is stored) of a layer."""
    if full_build:
        return layer % 2, 0, 0 if layer % 2 else 1, True
    return 0, 0 if layer == 1 else 1, 1, layer % 2 == 1


def emulate_t1(x, ws, pool_t, scale, shift, pos, full_build=True):
    """T1 as the kernel computes it, in float32 with bf16 x, res and r6:
    tiles of 44 frames, layer L over the slot rows of frames [a - 5 + L,
    a + 49 - L), taps read as shifted rows of the two buffers, the epilogue's
    keep = slot 1-10 and 0 <= p < pos, r6 kept at slots 1-10 below pos_pad,
    the pool product over the tile's slot rows from the pool image's
    fragments. Returns (out (B, n_win_pad, 48), r6 (B, pos_pad, 48))."""
    b, pos_pad, _ = x.shape
    n_win_pad = pool_t.shape[0]
    n_tiles = tk.trunk_tiles(pos_pad)
    w = tk.unpack_trunk_w_image(tk.pack_trunk_w_image(ws)).float()
    a_pool = _pool_from_fragments(tk.pack_trunk_pool_image(pool_t), n_tiles).float()
    pooled = torch.zeros((b, 128, 48))
    r6_all = torch.zeros((b, pos_pad, 48))
    for j in range(n_tiles):
        a = j * T
        bufs = [_slot_rows(x, a - 6, T + 12, pos_pad), torch.zeros((b, S * (T + 12), 48), dtype=torch.bfloat16)]
        for layer in range(6):
            src, res, dst, store = _kernel_roles(layer, full_build)
            r0, n = S * (layer + 1), S * (T + 10 - 2 * layer)
            padded = F.pad(bufs[src], (0, 0, 13, 13))
            im = torch.cat([padded[:, 13 + r0 + S * dt + df : 13 + r0 + S * dt + df + n] for dt, df in tk.TAPS], -1)
            y = torch.relu(im.float() @ w[layer])
            r = r0 + torch.arange(n)
            slot = r % S
            p = (a - 6 + r // S) * tk.F_OUT + slot - 1
            if layer % 2:
                y = y + bufs[res][:, r0 : r0 + n].float()
            if layer < 5:
                keep = ((slot >= 1) & (slot <= tk.F_OUT) & (p >= 0) & (p < pos))[:, None]
                xn = torch.where(keep, (y - shift[layer]) * scale[layer], torch.zeros(())).to(torch.bfloat16)
                if store:
                    bufs[dst][:, r0 : r0 + n] = xn
            else:
                keep = (slot >= 1) & (slot <= tk.F_OUT) & (p < pos_pad)
                r6 = torch.where(keep[:, None], y, torch.zeros(())).to(torch.bfloat16).float()
                r6_all[:, p[keep]] = y[:, keep]
                pooled = pooled + a_pool[:, T * S * j : T * S * (j + 1)] @ r6
    return ((pooled - shift[6]) * scale[7])[:, :n_win_pad], r6_all


def plain_r6(x, ws, bn_scale, bn_shift, pos, full_build=True):
    """r6 of trunk_proto_plain, before its rounding to bf16."""
    keep = (torch.arange(x.shape[1]) < pos)[:, None]
    w32 = ws.float()
    im = tk._taps_im2col(x).float()
    res = x
    for layer in range(6):
        if full_build and layer > 0:
            im = tk._taps_im2col(x).float()
        r = torch.relu(im @ w32[layer])
        if layer % 2 == 1:
            r = r + res.float()
        if layer < 5:
            x = torch.where(keep, (r - bn_shift[layer]) * bn_scale[layer], torch.zeros(())).to(torch.bfloat16)
            if layer % 2 == 1:
                res = x
    return r


@pytest.mark.parametrize("full_build", [True, False], ids=["full-build", "gemm-only"])
@pytest.mark.parametrize("pos_pad,pos", [(640, 530), (640, 640), (2176, 2130), (1280, 441), (1280, 879), (448, 445)])
def test_emulation_matches_plain_f32(full_build, pos_pad, pos):
    """Tiles of 44 frames with a six-frame halo give the whole clip's r6 and
    output, for pos values inside a tile, on a tile's edge (440, 880) and
    where the clip ends inside a frame."""
    ops = _trunk_operands(pos_pad + pos, 2, pos_pad)
    x, ws, pool_t, scale, shift = ops
    got, r6 = emulate_t1(*ops, pos, full_build)
    want = tk.trunk_proto_plain(*ops, pos, full_build)
    assert got.shape == want.shape == (2, 128, 48)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    want_r6 = plain_r6(x, ws, scale, shift, pos, full_build)
    assert float((r6 - want_r6).abs().max()) <= 1e-5 * float(want_r6.abs().max())


@pytest.fixture(scope="module")
def recorded():
    """The JAX tool's pallas_call calls at its CPU size (tests/test_torch_trunk_micro.py's recorder)."""
    calls = []

    def recorder(kernel, **kw):
        def run(*args):
            calls.append((kernel, kw, args))
            return jnp.zeros(kw["out_shape"].shape, kw["out_shape"].dtype)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(TOOLS))
        mp.setattr(pl, "pallas_call", recorder)
        tool = importlib.import_module("bench_trunk_kernel_micro")
        with contextlib.redirect_stdout(io.StringIO()):
            tool.main([])
    sys.modules.pop("bench_trunk_kernel_micro", None)
    assert len(calls) == 3
    return calls


def _torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("variant", ["full-build", "gemm-only"])
def test_emulation_matches_the_pallas_kernel(recorded, variant):
    kernel, kw, args = recorded[0 if variant == "full-build" else 1]
    geom = tk.trunk_geometry(2.0)
    x = np.random.default_rng(5).standard_normal((4, geom.pos_pad, tk.CH_PAD)).astype(np.float32) * 0.5
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pl.pallas_call(kernel, **kw)(xj, *args[1:]))
    got, _ = emulate_t1(
        _torch(xj, torch.bfloat16), torch.stack([_torch(w, torch.bfloat16) for w in args[1:7]]),
        _torch(args[7], torch.bfloat16), _torch(args[8]), _torch(args[9]), geom.pos, variant == "full-build",
    )
    assert got.shape == want.shape and np.abs(want).max() > 1.0
    assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()


# ---- M2's images ----


def test_gemm_w_image_round_trip_holds_every_element_once():
    w = torch.arange(512 * 512, dtype=torch.float32).reshape(512, 512)
    img = fm.pack_gemm_w_image(w)
    assert img.numel() == 512 * 512 and torch.equal(fm.unpack_gemm_w_image(img), w)
    assert torch.equal(torch.sort(img).values, w.reshape(-1))


@pytest.mark.parametrize("k,n", [(0, 0), (7, 1), (8, 9), (63, 255), (64, 256), (511, 511), (300, 77)])
def test_gemm_w_image_places_an_element_where_the_descriptor_reads_it(k, n):
    w = torch.zeros((512, 512))
    w[k, n] = 1.0
    (where,) = torch.nonzero(fm.pack_gemm_w_image(w)).reshape(-1).tolist()
    h, nl, kb = n // 256, n % 256, k // 64
    assert 2 * where == (8 * h + kb) * 32768 + nl * 128 + 16 * ((k % 64 // 8) ^ (nl % 8)) + 2 * (k % 8)


def _a_image(x, s):
    """The kernel's A image of a tile: bf16(x + s) of row m, column k at byte
    (k // 64) * 16384 + m * 128 + 16 * ((k % 64 // 8) ^ (m % 8)) + 2 * (k % 8)."""
    xb = (x + np.float32(s)).to(torch.bfloat16)
    img = torch.zeros(128 * 512, dtype=torch.bfloat16)
    m = torch.arange(x.shape[0])[:, None]
    k = torch.arange(512)[None, :]
    byte = (k // 64) * 16384 + m * 128 + 16 * ((k % 64 // 8) ^ (m % 8)) + 2 * (k % 8)
    img[byte // 2] = xb
    return img


def test_gemm_a_image_read_through_the_descriptor_is_x_plus_s_rounded():
    """Ties round to even: 1 + 2^-8 and 1 + 3 * 2^-8 lie half-way between two
    bf16 values. Read back as a K-major 128-byte-swizzled operand: a k16 step
    ks of warpgroup wg starts at (ks // 4) * 16384 + wg * 8192 + (ks % 4) * 32."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((128, 512)).astype(np.float32))
    x[:, 0], x[:, 1] = 1.0, 1.0 + 2.0**-7
    img = _a_image(x, 2.0**-8)
    back = torch.zeros((128, 512), dtype=torch.bfloat16)
    for wg in range(2):
        for ks in range(32):
            start = (ks // 4) * 16384 + wg * 8192 + (ks % 4) * 32
            m = torch.arange(64)[:, None]
            k = torch.arange(16)[None, :]
            # byte of (m, k) from the descriptor's start: row m of its atom, chunk (start's chunk + k // 8) ^ (m % 8)
            chunk = ((start % 128) // 16 + k // 8) ^ (m % 8)
            byte = start - start % 128 + m * 128 + 16 * chunk + 2 * (k % 8)
            back[64 * wg + m, 16 * ks + k] = img[byte // 2]
    assert torch.equal(back, (x + 2.0**-8).to(torch.bfloat16))
    assert back[0, 0].item() == 1.0 and back[0, 1].item() == 1.0 + 2.0**-6


def test_gemm_cpu_route_is_the_plain_version_and_rounds_ties_to_even():
    w = torch.eye(512).to(torch.bfloat16)
    x = torch.zeros((64, 512))
    x[:, 0], x[:, 1], x[:, 2] = 1.0, 1.0 + 2.0**-7, 0.5
    before = fm.gemm_cuda.launches
    got = fm.gemm_cuda(x, w, 2.0**-8, 3)
    assert fm.gemm_cuda.launches == before and torch.equal(got, fm.gemm_plain(x, w, 2.0**-8, 3))
    assert got[5, 0].item() == 3.0 and got[5, 1].item() == 3 * (1.0 + 2.0**-6) and got[5, 2].item() == 3 * (0.5 + 2.0**-8)


def test_packed_operand_keeps_an_image_per_tensor():
    """Legs 3 and 4 of the trunk study alternate two weight tensors: neither
    may be packed again inside the timed chain."""
    calls = []

    def pack(t):
        calls.append(1)
        return t + 1

    a, b = torch.zeros(3), torch.ones(3)
    for _ in range(3):
        _build.packed_operand(pack, a)
        _build.packed_operand(pack, b)
    assert len(calls) == 2
    b.mul_(2)
    assert torch.equal(_build.packed_operand(pack, b), torch.full((3,), 3.0)) and len(calls) == 3
    key = (pack, id(a))
    assert key in _build._packed
    del a
    assert key not in _build._packed  # the image goes with its tensor


# ---- what the CUDA sources share with Python ----


def _constants(name):
    src = (_build.CSRC / name).read_text()
    return src, {n: v for n, v in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, flags=re.M)}


def test_trunk_proto_constants_are_the_cuda_source():
    src, c = _constants("trunk_proto.cu")
    assert int(c["kT"]) == tk.TRUNK_TILE and int(c["kSlots"]) == tk.TRUNK_SLOTS and int(c["kCh"]) == tk.CH_PAD
    assert int(c["kFOut"]) == tk.F_OUT and int(c["kHalo"]) == 6 and c["kR6Rows"] == "kSlots * kT"
    assert c["kPoolSteps"] == "kR6Rows / 16" and tk.TRUNK_POOL_STEPS == 33
    assert c["kKCoreBytes"] == "kChunks * 128" and c["kChunks"] == "kCh / 8"
    assert "wgmma_m64n48k16_ss" in src and "wgmma_m64n48k16_rs" in src and "bulk_load" in src
    header = (_build.CSRC / "hopper_async.cuh").read_text()
    assert "m64n48k16.f32.bf16.bf16" in header and "m64n256k16.f32.bf16.bf16" in header
    assert "n_win_pad > 128" in src and tk.TRUNK_POOL_WINDOWS == 128


def test_micro_gemm_constants_are_the_cuda_source():
    src, c = _constants("micro_gemm.cu")
    assert int(c["kPassN"]) == fm.GEMM_PASS_N and int(c["kStageK"]) == fm.GEMM_STAGE_K and int(c["kNfft"]) == 512
    assert int(c["kOutCols"]) == fm.OUT_COLS and int(c["kRows"]) == 128 and c["kWStageBytes"] == "kPassN * 128"
    assert "wgmma_m64n256k16_ss" in src and "desc_sw128" in src and "__fadd_rn" in src
    assert '#include "micro_common.cuh"' not in src


def test_stem_fold_still_reads_the_shared_swizzle_helpers():
    src = (_build.CSRC / "stem_fold.cu").read_text()
    header = (_build.CSRC / "hopper_async.cuh").read_text()
    assert '#include "hopper_async.cuh"' in src and "desc_sw128(" in src and "wgmma_m64n128k16(" in src
    assert "uint64_t desc_sw128(" in header and "void wgmma_m64n128k16(" in header
    assert "uint64_t desc_sw128(" not in src  # one definition, in the header


@pytest.mark.parametrize("count", [0, 1, 2])
def test_probe_edit_must_match_once(count):
    text = "a = 1;\n" + "b = 2;\n" * count
    if count == 1:
        assert probe.apply_edits(text, [("b = 2;", "b = 2 * (n < 0);")], "v") == "a = 1;\nb = 2 * (n < 0);\n"
    else:
        with pytest.raises(ValueError, match=f"occurs {count} times"):
            probe.apply_edits(text, [("b = 2;", "b = 3;")], "v")
