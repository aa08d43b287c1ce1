"""The port's device-memory bandwidth sweep (howl_tpu_torch/tools/) vs the JAX tool.

The JAX tool ``tools/bench_hbm_sweep.py`` builds its Pallas kernels inside
``main``. A module-scoped fixture runs that ``main`` on the CPU (16 MB, the
full list) with ``pallas_call`` replaced by a recorder, which keeps each
call's kernel body, keyword arguments and arguments and returns zeros. The
tests then run the recorded bodies of the auto-read, auto-copy, stream-repro,
manual-read, manual-write, manual-copy and whole-array-copy kernels through
the real ``pallas_call`` in interpret mode on seeded numpy input with a
nonzero scalar that is no bf16 number, and hold the port's plain versions
against them.

Tolerance: 0 everywhere but one place. Each function is a copy, a fill, one
add in the array's dtype or a float32 sum in a stated order, so every
comparison is bit for bit, in float32 and in bf16. The manual read's library
call sums as a tree and is held to 1e-4 absolute (16 corners of unit normals:
a few float32 ulps of a sum near 10).
"""

import contextlib
import importlib
import io
import itertools
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from howl_tpu_torch.tools import _study
from howl_tpu_torch.tools import bench_hbm_sweep as port_tool
from howl_tpu_torch.tools import hbm_sweep_kernels as hk
from howl_tpu_torch.tools import probe_kernel_variants as probe

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU_GEOM = hk.sweep_geometry(16)  # the JAX tool's CPU size
S = 0.3  # the nonzero scalar of the comparisons: bf16 rounds it to 0.30078125
# the JAX tool's legs in the order it times them, one per two recorded traces (the short and the long chain)
LEGS = (["stream"] + [f"read f32 {bn}" for bn in port_tool.BNS] + [f"copy f32 {bn}" for bn in port_tool.BNS]
        + [f"{mode} bf16 {bn}" for bn in port_tool.BF16_BNS for mode in ("read", "copy")]
        + [f"manual {mode} f32 {k} {cb}" for mode in ("read", "write", "copy") for k in port_tool.MANUAL_KS
           for cb in port_tool.MANUAL_CBS]
        + [f"manual {mode} {tag} {k} {cb}" for mode, tag, k, cb in port_tool.MANUAL_SINGLES])


def _record(argv):
    """(the JAX tool's pallas_call calls at its CPU size as (kernel, keyword
    arguments, arguments), the lines the tool printed) for ``main(argv)``."""
    calls = []

    def recorder(kernel, **kw):
        def run(*args):
            calls.append((kernel, kw, args))
            shape = kw["out_shape"]
            if isinstance(shape, (list, tuple)):
                return [jnp.zeros(one.shape, one.dtype) for one in shape]
            return jnp.zeros(shape.shape, shape.dtype)

        return run

    # The recorded kernels do nothing, so the tool's two chains can take the same time to the clock's last
    # digit, and it divides by their difference. Its own view of the clock (not the process's) ticks in
    # growing steps instead: the long chain always reads longer than the short one.
    ticks = itertools.accumulate(itertools.count(1))
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(TOOLS))
        mp.setattr(pl, "pallas_call", recorder)
        tool = importlib.import_module("bench_hbm_sweep")
        mp.setattr(tool, "time", types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
        with contextlib.redirect_stdout(printed):
            tool.main(argv)
    sys.modules.pop("bench_hbm_sweep", None)
    return calls, printed.getvalue().splitlines()


@pytest.fixture(scope="module")
def recorded():
    """({leg: (kernel, keyword arguments, arguments)} of the JAX tool's full
    list, the lines the tool printed)."""
    calls, lines = _record([])
    assert len(calls) == 2 * (len(LEGS) + 1) and len(LEGS) == 15 + 25
    legs = dict(zip(LEGS, calls[::2]))
    legs["hbm2hbm"] = calls[-1]
    return legs, lines


def _seeded(rows, dtype, seed):
    """(the JAX array, the torch tensor) of one seeded numpy draw, rounded to ``dtype`` by each side."""
    x = np.random.default_rng(seed).standard_normal((rows, hk.COLS)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _scalar(dtype):
    return jnp.asarray([S], jnp.float32).astype(dtype)


def _assert_same_bits(got: torch.Tensor, want) -> None:
    """Bit for bit: a bf16 value widens to float32 exactly, so equal float32 bits are equal bf16 bits."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy().view(np.int32), want.view(np.int32))


def _rows(dtype) -> int:
    return CPU_GEOM.rows_bf16 if dtype == "bf16" else CPU_GEOM.rows_f32


BLOCK_CASES = [("f32", 256), ("f32", 4096), ("bf16", 1024), ("bf16", 4096)]


def test_geometry_equals_the_jax_tools(recorded):
    legs, _ = recorded
    assert (CPU_GEOM.rows_f32, CPU_GEOM.rows_bf16, CPU_GEOM.bytes_total) == (8192, 16384, 16 << 20)
    for dtype, bn in BLOCK_CASES:
        rows = _rows(dtype)
        for mode, out_shape in (("read", (rows // bn * hk.CORNER_ROWS, hk.OUT_COLS)), ("copy", (rows, hk.COLS))):
            _, kw, args = legs[f"{mode} {dtype} {bn}"]
            assert kw["grid"] == (rows // bn,) and tuple(args[0].shape) == (rows, hk.COLS)
            assert tuple(kw["out_shape"].shape) == out_shape and kw["out_shape"].dtype == args[0].dtype == args[1].dtype
    _, kw, args = legs["stream"]
    assert kw["grid"] == (8192 // port_tool.STREAM_BN,) and tuple(kw["out_shape"].shape) == (8192, hk.OUT_COLS)
    _, kw, args = legs["hbm2hbm"]
    assert [tuple(one.shape) for one in kw["out_shape"]] == [(8192, hk.COLS), hk.DONE_SHAPE]
    full = hk.sweep_geometry(256)
    assert (full.rows_f32, full.rows_bf16, full.bytes_total) == (131072, 262144, 268435456)
    assert hk.sweep_geometry(17).rows_f32 == 8192  # cut to a multiple of 4096 rows, as the JAX tool cuts
    for leg, (_, kw, args) in legs.items():
        if leg.startswith("manual"):
            _, mode, dtype, k, cb = leg.split()
            shapes = kw["out_shape"] if mode != "read" else [None, kw["out_shape"]]
            assert tuple(shapes[-1].shape) == hk.DONE_SHAPE and shapes[-1].dtype == jnp.float32
            assert kw["scratch_shapes"][0].shape == (int(k), int(cb), hk.COLS)
            if mode != "read":
                assert tuple(shapes[0].shape) == (_rows(dtype), hk.COLS)
            if mode != "write":
                assert tuple(args[1].shape) == (_rows(dtype), hk.COLS)


def test_inputs_equal_the_jax_tools_draws():
    geom, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    want = np.random.default_rng(0).standard_normal((geom.rows_f32, hk.COLS)).astype(np.float32)
    np.testing.assert_array_equal(x32.numpy(), want)
    want16 = jax.jit(lambda a: jnp.concatenate([a, a], 0).astype(jnp.bfloat16))(jnp.asarray(want))
    assert x16.dtype == torch.bfloat16
    _assert_same_bits(x16, want16)


@pytest.mark.parametrize("dtype,bn", BLOCK_CASES)
def test_auto_read_plain_matches_the_pallas_kernel_bitwise(recorded, dtype, bn):
    kernel, kw, _ = recorded[0][f"read {dtype} {bn}"]
    xj, xt = _seeded(_rows(dtype), dtype, 31)
    want = pl.pallas_call(kernel, **kw, interpret=True)(xj, _scalar(xj.dtype))
    got = hk.auto_read_plain(xt, bn, S)
    assert got.dtype == xt.dtype
    _assert_same_bits(got, want)
    assert not np.array_equal(got.float().numpy(), hk.auto_read_plain(xt, bn, 0.0).float().numpy())


@pytest.mark.parametrize("dtype,bn", BLOCK_CASES)
def test_auto_copy_plain_matches_the_pallas_kernel_bitwise(recorded, dtype, bn):
    kernel, kw, _ = recorded[0][f"copy {dtype} {bn}"]
    xj, xt = _seeded(_rows(dtype), dtype, 32)
    want = pl.pallas_call(kernel, **kw, interpret=True)(xj, _scalar(xj.dtype))
    got = hk.auto_copy_plain(xt, S)
    assert got.dtype == xt.dtype
    _assert_same_bits(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stream_repro_plain_matches_the_pallas_kernel_bitwise(recorded, dtype):
    """The tool runs this leg in float32 only; its body and block specs take
    bf16 as they are, with the grid and the output shape of the bf16 array."""
    kernel, kw, _ = recorded[0]["stream"]
    xj, xt = _seeded(_rows(dtype), dtype, 33)
    kw = dict(kw, grid=(xj.shape[0] // port_tool.STREAM_BN,),
              out_shape=jax.ShapeDtypeStruct((xj.shape[0], hk.OUT_COLS), xj.dtype))
    want = pl.pallas_call(kernel, **kw, interpret=True)(xj, _scalar(xj.dtype))
    got = hk.stream_repro_plain(xt, S)
    assert got.dtype == xt.dtype
    _assert_same_bits(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hbm2hbm_plain_matches_the_pallas_kernel_bitwise(recorded, dtype):
    kernel, kw, _ = recorded[0]["hbm2hbm"]
    xj, xt = _seeded(_rows(dtype), dtype, 34)
    kw = dict(kw, out_shape=[jax.ShapeDtypeStruct(xj.shape, xj.dtype), kw["out_shape"][1]])
    want, want_done = pl.pallas_call(kernel, **kw, interpret=True)(jnp.asarray([S], jnp.float32), xj)
    got, done = hk.hbm2hbm_plain(xt, S)
    assert got.dtype == xt.dtype and got.data_ptr() != xt.data_ptr() and done.dtype == torch.float32
    _assert_same_bits(got, want)
    _assert_same_bits(done, want_done)


RING_CASES = [("f32", 2, 512), ("f32", 3, 1024), ("f32", 8, 512), ("bf16", 3, 1024)]
S32 = jnp.asarray([S], jnp.float32)  # the manual kernels take the scalar in float32, whatever the array's dtype


@pytest.mark.parametrize("dtype,k,cb", RING_CASES)
def test_manual_read_plain_matches_the_pallas_kernel_bitwise(recorded, dtype, k, cb):
    kernel, kw, _ = recorded[0][f"manual read {dtype} {k} {cb}"]
    xj, xt = _seeded(_rows(dtype), dtype, 35)
    want = pl.pallas_call(kernel, **kw, interpret=True)(S32, xj)
    got = hk.manual_read_plain(xt, k, cb, S)
    assert got.dtype == torch.float32
    _assert_same_bits(got, want)
    assert not np.array_equal(got.numpy(), hk.manual_read_plain(xt, k, cb, 0.0).numpy())


def _write_record(recorded, dtype, k, cb):
    """The recorded write body with its big output kept: the JAX tool's
    ``run`` throws it away. The tool writes in float32 at k = 2, 3, 4 only.
    Its body takes bf16 with the output's and the ring's dtype replaced, and
    another depth with the ``k`` its code closes over replaced (the same code
    object, one cell of its closure swapped) and a ring of that many slots."""
    from jax.experimental.pallas import tpu as pltpu

    kernel, kw, _ = recorded[0][f"manual write f32 {min(k, 4)} {cb}"]
    if k > 4:
        cells = dict(zip(kernel.__code__.co_freevars, kernel.__closure__))
        assert cells["k"].cell_contents == 4
        cells["k"] = types.CellType(k)
        kernel = types.FunctionType(kernel.__code__, kernel.__globals__, kernel.__name__, kernel.__defaults__,
                                    tuple(cells[name] for name in kernel.__code__.co_freevars))
    big, done = kw["out_shape"]
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kw = dict(kw, out_shape=[jax.ShapeDtypeStruct(big.shape, jdtype), done],
              scratch_shapes=[pltpu.VMEM((k, cb, hk.COLS), jdtype), pltpu.SemaphoreType.DMA((k,))])
    return kernel, kw


@pytest.mark.parametrize("dtype,k,cb", RING_CASES)
def test_manual_write_plain_matches_the_pallas_kernel_bitwise(recorded, dtype, k, cb):
    kernel, kw = _write_record(recorded, dtype, k, cb)
    want, want_done = pl.pallas_call(kernel, **kw, interpret=True)(S32)
    xt = torch.empty((CPU_GEOM.rows_f32, hk.COLS), dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    got, done = hk.manual_write_plain(xt, k, cb, S)
    assert got.dtype == xt.dtype and got.is_contiguous() and done.dtype == torch.float32
    _assert_same_bits(got, want)  # the whole array, not only ``done``
    _assert_same_bits(done, want_done)
    assert got[0, 0].item() != got[cb, 0].item()  # the chunk index reaches the array


@pytest.mark.parametrize("dtype,k,cb", RING_CASES)
def test_manual_copy_plain_matches_the_pallas_kernel_bitwise(recorded, dtype, k, cb):
    kernel, kw, _ = recorded[0][f"manual copy {dtype} {k} {cb}"]
    xj, xt = _seeded(_rows(dtype), dtype, 36)
    want, want_done = pl.pallas_call(kernel, **kw, interpret=True)(S32, xj)
    got, done = hk.manual_copy_plain(xt, k, cb, S)
    assert got.dtype == xt.dtype and got.data_ptr() != xt.data_ptr() and done.dtype == torch.float32
    _assert_same_bits(got, want)
    _assert_same_bits(done, want_done)


def test_manual_read_sums_in_chunk_order():
    """The float32 sum is sequential, so its order is part of the function:
    the same corners added from the last chunk to the first give other bits."""
    _, xt = _seeded(4096, "f32", 37)
    got = hk.manual_read_plain(xt, 2, 8, S)
    corners = xt.view(-1, 8, hk.COLS)[:, :, : hk.OUT_COLS]
    want = torch.full(hk.DONE_SHAPE, S)
    backwards = want.clone()
    for i in range(corners.shape[0]):
        want += corners[i]
        backwards += corners[-1 - i]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got.view(torch.int32), backwards.view(torch.int32))
    torch.testing.assert_close(got, backwards, rtol=0, atol=1e-3)
    # one chunk height for all: the chunks' corners are rows i * cb .. i * cb + 8, so another cb is another function
    assert not torch.equal(got, hk.manual_read_plain(xt, 2, 16, S))
    assert torch.equal(got, hk.manual_read_plain(xt, 7, 8, S))  # the ring depth changes nothing


def test_manual_write_fills_chunk_i_with_the_float32_sum_cast_afterwards():
    """dtype(float32(s) + float32(i)): in bf16 chunk 300 holds 300 (300.3
    rounded), and chunk 257 holds 258: 257 is no bf16 number, and a bf16 add
    of a bf16 index would have started from 256."""
    x = torch.empty((301 * 8, hk.COLS), dtype=torch.bfloat16)
    out, done = hk.manual_write_plain(x, 2, 8, S)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert out[300 * 8, 0].item() == 300.0 and out[257 * 8 + 7, 511].item() == 258.0
    assert out[0, 0].item() == 0.30078125 and out[8, 5].item() == 1.296875
    assert bool((out.view(301, -1) == out.view(301, -1)[:, :1]).all())  # one value per chunk
    assert bool((done == np.float32(S)).all())
    out32, _ = hk.manual_write_plain(x.float(), 3, 8, S)
    want = (np.float32(S) + np.arange(301, dtype=np.float32)).astype(np.float32)
    np.testing.assert_array_equal(out32[::8, 3].numpy(), want)
    np.testing.assert_array_equal(hk.chunk_values(x.float(), 8, S).numpy(), want)


def test_ring_geometry_says_what_k_and_cb_mean_on_the_card():
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    assert hk.STAGE_BYTES == 8 * hk.COLS * 4 and (hk.MIN_K, hk.MAX_K) == (2, 8)
    g = hk.ring_geometry(x32, 3, 512, "read")
    assert g == {"k": 3, "cb": 512, "bf16": False, "stage_bytes": 16384, "stages": 1024, "stages_per_chunk": 64,
                 "schedule": "chunk", "ctas": 16, "stages_per_cta": 64, "bytes_in_flight_per_cta": 3 * 16384}
    assert hk.ring_geometry(x32, 3, 512, "write") == g
    g = hk.ring_geometry(x16, 8, 1024, "read")
    assert (g["ctas"], g["stages_per_cta"], g["bytes_in_flight_per_cta"], g["bf16"]) == (16, 64, 131072, True)
    # a bf16 chunk of 24 rows is one stage and a half; a ring deeper than the chunk is not filled
    g = hk.ring_geometry(x16[:3144], 4, 24, "write")
    assert (g["ctas"], g["stages_per_cta"], g["bytes_in_flight_per_cta"], g["stages"]) == (131, 2, 32768, 262)


def test_copy_ring_geometry_is_a_sweep_of_the_chunks_stages():
    """The copy's stages (a bf16 chunk of 24 rows: a whole stage and a half
    one) are swept by every CTA that fits the card, known there only: a chain
    per slot, one stage in flight each."""
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    g = hk.ring_geometry(x32, 2, 512, "copy")
    assert g == {"k": 2, "cb": 512, "bf16": False, "stage_bytes": 16384, "stages": 1024, "stages_per_chunk": 64,
                 "schedule": "sweep", "ctas": None, "stages_per_cta": None, "bytes_in_flight_per_cta": 2 * 16384}
    g = hk.ring_geometry(x16[:3144], 8, 24, "copy")
    assert (g["stages"], g["stages_per_chunk"], g["bytes_in_flight_per_cta"]) == (262, 2, 8 * 16384)
    # on a card of 132 SMs: the grid is every CTA that fits, no more than there are stages, one for no stages
    on = hk.ring_on_card(hk.ring_geometry(x32, 2, 512, "copy"), 6, 132)
    assert (on["ctas"], on["stages_per_cta"], on["ctas_per_sm"]) == (792, 2, 6)
    assert hk.ring_on_card(g, 1, 132)["ctas"] == 132 and hk.ring_on_card(g, 7, 132)["ctas"] == 262
    assert hk.ring_on_card(hk.ring_geometry(x32[:0], 2, 8, "copy"), 7, 132)["ctas"] == 1
    # the read's and write's CTAs stay one a chunk on the card
    read = hk.ring_geometry(x32, 2, 512, "read")
    assert hk.ring_on_card(read, 7, 132) == dict(read, ctas_per_sm=7)


def test_block_geometry_says_what_bn_means_on_the_card():
    """The read and the stream leg: one CTA a block, walking it in stages of
    32 KB; the copy: one CTA a stage of 8 KB, whatever bn."""
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    assert (hk.BLOCK_STAGE_BYTES, hk.COPY_STAGE_BYTES, hk.BLOCK_CTAS_PER_SM, hk.COPY_CTAS_PER_SM) == (32768, 8192, 2, 4)
    g = hk.block_geometry(x32, 256, "read")
    assert g == {"bn": 256, "bf16": False, "stage_bytes": 32768, "stages": 512, "stages_per_block": 16,
                 "last_stage_bytes": 32768, "schedule": "block", "ctas": 32, "stages_per_cta": 16, "ctas_per_sm": 2}
    assert hk.block_geometry(x32, 256, "stream") == g
    g = hk.block_geometry(x32, 256, "copy")
    assert g == {"bn": 256, "bf16": False, "stage_bytes": 8192, "stages": 2048, "stages_per_block": 64,
                 "last_stage_bytes": 8192, "schedule": "stage", "ctas": 2048, "stages_per_cta": 1, "ctas_per_sm": 4}
    # the copy's grid follows the array's bytes alone: the same at every block height, in either dtype
    for x, bns in ((x32, port_tool.BNS), (x16, port_tool.BF16_BNS)):
        assert {hk.block_geometry(x, bn, "copy")["ctas"] for bn in bns} == {2048}
    assert [hk.block_geometry(x32, bn, "read")["ctas"] for bn in port_tool.BNS] == [32, 16, 8, 4, 2]
    assert hk.block_geometry(x16, 4096, "read")["stages_per_cta"] == 128


def test_block_geometry_of_short_stages_and_low_blocks():
    """A read block that is no whole number of 32 KB stages ends in a short
    one, and a block lower than a stage is one short stage; every copy block
    is a whole number of 8 KB stages, down to 8 rows of bf16."""
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    odd32, odd16 = x32[:3144], x16[:3144]
    g = hk.block_geometry(odd32, 24, "read")  # 48 KB blocks: a whole stage and a half one
    assert (g["ctas"], g["stages"], g["stages_per_block"], g["last_stage_bytes"]) == (131, 262, 2, 16384)
    g = hk.block_geometry(odd16, 24, "stream")  # 24 KB blocks: one short stage each
    assert (g["ctas"], g["stages_per_block"], g["last_stage_bytes"]) == (131, 1, 24576)
    g = hk.block_geometry(x32, 8, "read")  # 16 KB blocks, below a stage
    assert (g["ctas"], g["stages_per_block"], g["last_stage_bytes"]) == (1024, 1, 16384)
    assert [hk.block_geometry(odd32, 24, "copy")[key] for key in ("ctas", "stages_per_block")] == [786, 6]
    assert [hk.block_geometry(odd16, 24, "copy")[key] for key in ("ctas", "stages_per_block")] == [393, 3]
    low = hk.block_geometry(x16, 8, "copy")  # 8 KB blocks, the lowest: one whole stage each
    assert (low["stages_per_block"], low["last_stage_bytes"], low["ctas"]) == (1, 8192, 2048)
    for x in (x32, x16):
        for bn in range(8, 4097, 8):
            if x.shape[0] % bn == 0:
                g = hk.block_geometry(x, bn, "copy")
                assert g["last_stage_bytes"] == g["stage_bytes"] and g["stages"] * 8192 == x.numel() * x.element_size()
    assert hk.block_geometry(x32[:0], 8, "copy")["ctas"] == 0
    with pytest.raises(ValueError, match="'read', 'copy' or 'stream'"):
        hk.block_geometry(x32, 256, "write")
    with pytest.raises(ValueError, match="multiple of 8"):
        hk.block_geometry(x32, 12, "copy")
    with pytest.raises(ValueError, match="whole number of blocks"):
        hk.block_geometry(odd32, 256, "read")


def test_block_stage_sizes_are_the_kernels():
    """The geometry's stage sizes and CTAs to an SM are the ones the CUDA
    sources use."""
    csrc = Path(hk.__file__).resolve().parent.parent / "csrc"
    common, copy = (csrc / "hbm_common.cuh").read_text(), (csrc / "hbm_auto_copy.cu").read_text()
    assert f"constexpr int kStageBytes = {hk.BLOCK_STAGE_BYTES};" in common and "constexpr int kStages = 3;" in common
    assert hk.BLOCK_CTAS_PER_SM == 228 // (3 * 32 + 1)  # 96 KB rings and the KB the card keeps back for each CTA
    for line in ("constexpr int kCopyThreads = 256;", "constexpr int kCopyLoads = 2;",
                 "constexpr int kCopyStageBytes = kCopyThreads * kCopyLoads * 16;",
                 f"constexpr int kCopyCtasPerSm = {hk.COPY_CTAS_PER_SM};"):
        assert line in copy
    assert hk.COPY_STAGE_BYTES == 256 * 2 * 16
    assert "launch_block_walk" not in copy and "walk_block" not in copy


def test_port_tool_prints_what_bn_means_on_the_card_on_the_block_legs():
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        records, _ = port_tool.run(16, 1, True, 0, torch.device("cpu"))
    _, x32, _ = port_tool.make_inputs(16, 0, torch.device("cpu"))
    legs = {"auto read": "read", "auto copy": "copy", "stream-264-repro": "stream"}
    block_legs = [r for r in records if r["config"].startswith(tuple(legs))]
    assert len(block_legs) == 1 + 2 * len(port_tool.QUICK_BNS)
    for rec in block_legs:
        leg = next(leg for name, leg in legs.items() if rec["config"].startswith(name))
        bn = int(rec["config"].split("bn=")[1].split()[0])
        assert rec["block"] == hk.block_geometry(x32, bn, leg) and rec["ring"] is None
        line = next(line for line in printed.getvalue().splitlines() if line.startswith(rec["config"] + " "))
        g = rec["block"]
        want = (f"on the card {g['ctas']} CTAs, one a stage of 8192 B, {g['stages_per_block']} stages a block, "
                "4 CTAs to an SM" if leg == "copy" else
                f"on the card {g['ctas']} CTAs, one a block of {g['stages_per_block']} stages of 32768 B, 2 CTAs to an SM")
        assert line.endswith(want)
    assert all(r["block"] is None for r in records if r not in block_legs)


def test_bf16_legs_round_the_scalar_before_the_add():
    """0.3 becomes 0.30078125 first; added to 256 in bf16 (ulp 2) it is lost,
    and 1 + 2^-8 ties to the even neighbour."""
    x = torch.zeros((8, hk.COLS), dtype=torch.bfloat16)
    x[:, 1], x[:, 2], x[:, 3] = 256.0, 1.0, 1.0 + 2.0**-7
    got = hk.auto_copy_plain(x, S)
    assert got[0, 0].item() == 0.30078125 and got[0, 1].item() == 256.0
    tie = hk.stream_repro_plain(x, 2.0**-8)
    assert tie[0, 2].item() == 1.0 and tie[0, 3].item() == 1.0 + 2.0**-6
    assert hk.auto_read_plain(x.float(), 8, S)[0, 0].item() == np.float32(S)


def test_wrappers_take_the_plain_route_on_the_cpu():
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    wrappers = (hk.auto_read_cuda, hk.auto_copy_cuda, hk.stream_repro_cuda, hk.hbm2hbm_cuda)
    before = [fn.launches for fn in wrappers]
    for x, bn in ((x32, 256), (x16, 4096)):
        torch.testing.assert_close(hk.auto_read_cuda(x, bn, S), hk.auto_read_plain(x, bn, S), rtol=0, atol=0)
        torch.testing.assert_close(hk.auto_copy_cuda(x, bn, S), hk.auto_copy_plain(x, S), rtol=0, atol=0)
        torch.testing.assert_close(hk.stream_repro_cuda(x, bn, S), hk.stream_repro_plain(x, S), rtol=0, atol=0)
        out, done = hk.hbm2hbm_cuda(x, S)
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr() and bool((done == np.float32(S)).all())
    assert [fn.launches for fn in wrappers] == before  # kernel launches only


def test_manual_wrappers_take_the_plain_route_on_the_cpu():
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    wrappers = (hk.manual_read_cuda, hk.manual_write_cuda, hk.manual_copy_cuda)
    before = [fn.launches for fn in wrappers]
    for x, k, cb in ((x32, 2, 512), (x16, 8, 1024), (x16[:3144], 3, 24)):
        got, want = hk.manual_read_cuda(x, k, cb, S), hk.manual_read_plain(x, k, cb, S)
        assert got.dtype == torch.float32 and torch.equal(got.view(torch.int32), want.view(torch.int32))
        out, done = hk.manual_write_cuda(x, k, cb, S)
        want, _ = hk.manual_write_plain(x, k, cb, S)
        assert out.dtype == x.dtype and torch.equal(out, want) and bool((done == np.float32(S)).all())
        out, done = hk.manual_copy_cuda(x, k, cb, S)
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr() and bool((done == np.float32(S)).all())
    assert [fn.launches for fn in wrappers] == before  # kernel launches only
    assert [fn.__name__ for fn in wrappers] == ["manual_read_cuda", "manual_write_cuda", "manual_copy_cuda"]


@pytest.mark.parametrize("name", ["manual_read_cuda", "manual_write_cuda", "manual_copy_cuda"])
def test_manual_wrappers_refuse_grad_wrong_operands_rings_and_other_devices(name):
    fn = getattr(hk, name)
    x = torch.zeros((64, hk.COLS))
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x.clone().requires_grad_(), 2, 8, S)
    for bad in (x.double(), x.half(), x.int()):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(bad, 2, 8, S)
    for bad in (torch.zeros((64, 256)), torch.zeros((2, 32, hk.COLS)), torch.zeros(hk.COLS)):
        with pytest.raises(ValueError, match=r"\(rows, 512\)"):
            fn(bad, 2, 8, S)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((hk.COLS, 64)).t(), 2, 8, S)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(torch.zeros(64 * hk.COLS + 1)[1:].view(64, hk.COLS), 2, 8, S)
    with pytest.raises(TypeError, match="Python number"):
        fn(x, 2, 8, torch.tensor(S))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fn(x.to("meta"), 2, 8, S)
    # the JAX tool's loop over rows // cb chunks would leave the last 16 rows out
    with pytest.raises(ValueError, match="whole number of chunks"):
        fn(x, 2, 24, S)
    for bad_cb in (0, 4, 12, 8.0):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(x, 2, bad_cb, S)
    for bad_k in (1, 0, -2, 2.0):  # k = 1 would deadlock the read: it starts k - 1 copies ahead
        with pytest.raises(ValueError, match="at least 2"):
            fn(x, bad_k, 8, S)
    for bad_k in (9, 16):  # no rounding to a depth the kernels have
        with pytest.raises(ValueError, match="from 2 to 8"):
            fn(x, bad_k, 8, S)
    plain = getattr(hk, name.replace("_cuda", "_plain"))
    plain(x, 9, 8, S)  # the function is defined at any depth; the kernels' ring is not
    with pytest.raises(ValueError, match="at least 2"):
        plain(x, 1, 8, S)
    with pytest.raises(ValueError, match="whole number of chunks"):
        plain(x, 2, 24, S)


@pytest.mark.parametrize("name", ["auto_read_cuda", "auto_copy_cuda", "stream_repro_cuda", "hbm2hbm_cuda"])
def test_wrappers_refuse_grad_wrong_operands_and_other_devices(name):
    fn = getattr(hk, name)
    call = (lambda x, bn=8, s=S: fn(x, s)) if name == "hbm2hbm_cuda" else (lambda x, bn=8, s=S: fn(x, bn, s))
    x = torch.zeros((64, hk.COLS))
    assert fn.__name__ == name
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_())
    for bad in (x.double(), x.half(), x.int()):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call(bad)
    for bad in (torch.zeros((64, 256)), torch.zeros((2, 32, hk.COLS)), torch.zeros(hk.COLS)):
        with pytest.raises(ValueError, match=r"\(rows, 512\)"):
            call(bad)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros((hk.COLS, 64)).t())
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(torch.zeros(64 * hk.COLS + 1)[1:].view(64, hk.COLS))
    with pytest.raises(TypeError, match="Python number"):
        call(x, s=torch.tensor(S))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(x.to("meta"))
    if name != "hbm2hbm_cuda":
        # the JAX tool's grid of rows // bn blocks would leave the last 16 rows unwritten
        with pytest.raises(ValueError, match="whole number of blocks"):
            call(x, bn=24)
        for bad_bn in (0, 4, 12, 8.0):
            with pytest.raises(ValueError, match="multiple of 8"):
                call(x, bn=bad_bn)


@pytest.mark.parametrize("bn", [256, 4096])
def test_read_library_call_is_the_plain_read_bit_for_bit(bn):
    """The read leg's library leg adds over a strided view of the corners; the
    plain version gathers them first."""
    _, x32, _ = port_tool.make_inputs(16, 0, torch.device("cpu"))
    got, want = port_tool.auto_read_library(x32, bn, S), hk.auto_read_plain(x32, bn, S)
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("cb", [512, 1024])
def test_manual_library_calls_compute_the_manual_legs_functions(cb):
    """The read's library call sums the corners as a tree: close to the
    sequential sum, not bit for bit. The write's is a broadcast copy of the
    chunk values: bit for bit."""
    _, x32, _ = port_tool.make_inputs(16, 0, torch.device("cpu"))
    torch.testing.assert_close(port_tool.manual_read_library(x32, cb, S), hk.manual_read_plain(x32, 2, cb, S),
                               rtol=0, atol=1e-4)
    want, _ = hk.manual_write_plain(x32, 2, cb, S)
    got = port_tool.manual_write_library(torch.empty_like(x32), hk.chunk_values(x32, cb, S), cb)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_port_tool_prints_the_jax_tools_legs_in_its_order_on_the_cpu(recorded, capsys, tmp_path):
    out_file = tmp_path / "sweep.json"
    records = port_tool.main(["--device", "cpu", "--json", str(out_file)])
    out = capsys.readouterr().out
    assert "16 MB" in out and "(8192, 512)" in out and "chains of 2 and 8" in out
    jax_names = [line.split(":")[0].rstrip() for line in recorded[1] if "ms/iter" in line]
    assert len(jax_names) == 2 + len(LEGS) + 1
    want = [n.replace("xla", "torch") for n in jax_names]  # every leg of the JAX tool, the manual ones included
    study = [r for r in records if not r["library"]]
    assert [r["config"] for r in study] == want
    manual = [r for r in study if r["config"].startswith("manual")]
    assert len(manual) == 25 and "not ported" not in out
    _, x32, x16 = port_tool.make_inputs(16, 0, torch.device("cpu"))
    arrays = {"f32": x32, "bf16": x16}
    for rec in manual:  # a manual leg's line says what its k and cb mean on the card
        ring = rec["ring"]
        line = next(line for line in out.splitlines() if line.startswith(rec["config"] + " "))
        assert f"k={ring['k']} cb={ring['cb']}" in rec["config"] and ring["ctas_per_sm"] is None
        mode, tag = rec["config"].split()[1:3]
        assert ring == dict(hk.ring_geometry(arrays[tag], ring["k"], ring["cb"], mode), ctas_per_sm=None)
        where = (f"{ring['stages']} stages of 16384 B swept by every CTA that fits the card" if mode == "copy"
                 else f"{ring['ctas']} CTAs, a chunk each")
        assert f"on the card {where}, k={ring['k']} slots of 16384 B, {ring['bytes_in_flight_per_cta']} B in flight" in line
    assert all(r["ring"] is None for r in records if not r["config"].startswith("manual"))
    assert [r["library"] for r in records] == [False] * len(want) + [True] * 6
    for rec in records:
        assert rec["config"] in out and np.isfinite(rec["ms_per_iter"]) and rec["plain_ms_per_iter"] is None
        assert rec["route"] in ("torch, cpu", "plain, cpu")
    assert sum(r["route"] == "plain, cpu" for r in records) == len(LEGS) + 1
    best = max(study, key=lambda r: r["gbps"])
    assert f"best: {best['config']}" in out
    assert json.loads(out_file.read_text()) == records


def test_quick_runs_the_jax_tools_coarse_subset():
    with contextlib.redirect_stdout(io.StringIO()):
        records, tally = port_tool.run(16, 1, True, 0, torch.device("cpu"))
    names = [r["config"] for r in records if not r["library"]]
    calls, lines = _record(["--quick"])
    jax_names = [line.split(":")[0].rstrip() for line in lines if "ms/iter" in line]
    assert names == [n.replace("xla", "torch") for n in jax_names] and len(calls) == 2 * (len(names) - 2)
    assert names[3:7] == ["auto read  f32 bn=512", "auto read  f32 bn=2048", "auto copy  f32 bn=512",
                          "auto copy  f32 bn=2048"]
    assert names[7:] == [f"manual {mode:5s} f32 k={k} cb=1024" for mode in ("read", "write", "copy") for k in (2, 4)] + [
        "hbm->hbm whole-array DMA (r+w)"]
    assert list(tally) == ["auto_read", "auto_copy", "stream_repro", "manual_read", "manual_write", "manual_copy", "hbm2hbm"]
    assert tally == dict.fromkeys(port_tool.KERNELS, 0)  # nothing launches on the CPU


class _FakeClock:
    """A clock that only the chains advance."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_slope_ms_cancels_a_fixed_cost_and_returns_the_per_iteration_time():
    clock, calls = _FakeClock(), []

    def make_chain(n):
        def chain():
            calls.append(n)
            clock.now += 0.031 + n * 0.002  # 31 ms once per chain, 2 ms per iteration

        return chain

    slope, mean = _study.slope_ms(make_chain, 8, 32, 3, torch.device("cpu"), clock)
    assert slope == pytest.approx(2.0, abs=1e-9)
    assert mean == pytest.approx(2.0 + 31.0 / 32, abs=1e-9)  # the plain mean keeps the fixed cost
    assert calls == [8] + [8, 32] * 3  # one warm-up of the short chain, then three pairs


def test_slope_turns_times_in_the_given_order_and_takes_medians():
    clock, order = _FakeClock(), []
    cost = {"plain": iter([0.001, 0.001, 0.009]), "kernel": iter([0.004, 0.002, 0.003])}

    def maker(who):
        def make_chain(n):
            def chain():
                order.append((who, n))
                if n == 4 and len(order) > 2:  # each turn's long chain takes that turn's cost per iteration
                    clock.now += 4 * next(cost[who])

            return chain

        return make_chain

    got = _study.slope_turns({"plain": maker("plain"), "kernel": maker("kernel")}, port_tool.TURNS, 1, 4,
                             torch.device("cpu"), clock)
    assert [who for who, n in order[2:] if n == 4] == list(port_tool.TURNS)
    assert order[:2] == [("plain", 1), ("kernel", 1)]
    assert got["plain"][1] == pytest.approx(1.0) and got["kernel"][1] == pytest.approx(3.0)


@pytest.mark.parametrize("variant", sorted(probe.HBM_COPY_EDITS))
def test_copy_probe_variants_edit_the_sources_once(variant):
    """Each variant of ``probe_kernel_variants --probe hbm-copy`` applies to
    the two copy sources as they are, each edit once among both; the levers'
    variants each take one cut fewer than the one before."""
    sources, edits, _ = probe.PROBES["hbm-copy"]
    assert [src.name for src in sources] == ["hbm_manual_copy.cu", "hbm2hbm.cu"] and edits is probe.HBM_COPY_EDITS
    texts = {src: src.read_text() for src in sources}
    edited = probe.edit_sources(texts, edits[variant], variant)
    changed = {src.name for src in sources if edited[src] != texts[src]}
    want = {"as it is": set(), "+ sweep, evict-first": {"hbm2hbm.cu"}}.get(variant, {"hbm_manual_copy.cu", "hbm2hbm.cu"})
    assert changed == want
    levers = [edits["no levers"], edits["+ sweep"], edits["+ sweep, evict-first"], edits["as it is"]]
    assert all(set(levers[i + 1]) < set(levers[i]) for i in range(3))


@pytest.mark.parametrize("variant", sorted(probe.AUTO_COPY_EDITS))
def test_auto_copy_probe_variants_edit_the_source_once(variant):
    """Each variant of ``probe_kernel_variants --probe auto-copy`` applies to
    the auto copy's source as it is, each edit once; the levers' variants
    take their cuts off one at a time: the block grid, then the path through
    shared memory, then the cap of four CTAs an SM, then the policy."""
    source, edits, _ = probe.PROBES["auto-copy"]
    assert source.name == "hbm_auto_copy.cu" and edits is probe.AUTO_COPY_EDITS
    text = source.read_text()
    edited = probe.apply_edits(text, edits[variant], variant)
    assert (edited == text) == (variant == "as it is")
    none, stage, registers, capped = (edits[v] for v in ("no levers", "+ a CTA a stage", "+ registers", "+ four CTAs an SM"))
    assert set(stage) < set(none) and len(none) - len(stage) == 2
    assert registers[1:] == stage[1:] and registers[0][0] == stage[0][0] and registers[0] != stage[0]
    assert set(capped) < set(registers) and len(registers) - len(capped) == 1
    assert ("cp_async16" in edited) == (variant in ("no levers", "+ a CTA a stage"))
    assert ("cudaOccupancyMaxActiveBlocksPerMultiprocessor" in edited) == (variant == "persistent grid")
    assert ("const int cap_bytes = 0;" in edited) == (variant in ("no levers", "+ a CTA a stage", "+ registers",
                                                                  "one load a thread"))


def test_probe_edits_of_several_sources_must_match_once_among_them_all(tmp_path):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    texts = {a: "x = 1;\ny = 2;\n", b: "y = 2;\nz = 3;\n"}
    assert probe.edit_sources(texts, [("z = 3;", "z = 4;")], "v") == {a: texts[a], b: "y = 2;\nz = 4;\n"}
    with pytest.raises(ValueError, match="occurs 2 times"):
        probe.edit_sources(texts, [("y = 2;", "y = 5;")], "v")
    with pytest.raises(ValueError, match="occurs 0 times"):
        probe.edit_sources(texts, [("w = 0;", "w = 1;")], "v")
    assert probe.probe_sources(a) == (a,) and probe.probe_sources((a, b)) == (a, b)
