"""The port's device-memory bandwidth sweep (howl_tpu_torch/tools/) vs the JAX tool.

The JAX tool ``tools/bench_hbm_sweep.py`` builds its Pallas kernels inside
``main``. A module-scoped fixture runs that ``main`` on the CPU (16 MB, the
full list) with ``pallas_call`` replaced by a recorder, which keeps each
call's kernel body, keyword arguments and arguments and returns zeros. The
tests then run the recorded bodies of the auto-read, auto-copy, stream-repro
and whole-array-copy kernels through the real ``pallas_call`` in interpret
mode on seeded numpy input with a nonzero scalar that is no bf16 number, and
hold the port's plain versions against them.

Tolerance: 0 everywhere. Each function is a copy or one add in the array's
dtype, so every comparison is bit for bit, in float32 and in bf16.
"""

import contextlib
import importlib
import io
import json
import sys
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

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU_GEOM = hk.sweep_geometry(16)  # the JAX tool's CPU size
S = 0.3  # the nonzero scalar of the comparisons: bf16 rounds it to 0.30078125
# the JAX tool's legs in the order it times them, one per two recorded traces (the short and the long chain)
LEGS = (["stream"] + [f"read f32 {bn}" for bn in port_tool.BNS] + [f"copy f32 {bn}" for bn in port_tool.BNS]
        + [f"{mode} bf16 {bn}" for bn in port_tool.BF16_BNS for mode in ("read", "copy")])
N_MANUAL_LEGS = 25


@pytest.fixture(scope="module")
def recorded():
    """({leg: (kernel, keyword arguments, arguments)} of the JAX tool's
    pallas_call calls at its CPU size, the lines the tool printed)."""
    calls = []

    def recorder(kernel, **kw):
        def run(*args):
            calls.append((kernel, kw, args))
            shape = kw["out_shape"]
            if isinstance(shape, (list, tuple)):
                return [jnp.zeros(one.shape, one.dtype) for one in shape]
            return jnp.zeros(shape.shape, shape.dtype)

        return run

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(TOOLS))
        mp.setattr(pl, "pallas_call", recorder)
        tool = importlib.import_module("bench_hbm_sweep")
        with contextlib.redirect_stdout(printed):
            tool.main([])
    sys.modules.pop("bench_hbm_sweep", None)
    assert len(calls) == 2 * (len(LEGS) + N_MANUAL_LEGS + 1)
    legs = dict(zip(LEGS, calls[::2]))
    legs["hbm2hbm"] = calls[-1]
    return legs, printed.getvalue().splitlines()


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


def test_port_tool_prints_the_jax_tools_legs_in_its_order_on_the_cpu(recorded, capsys, tmp_path):
    out_file = tmp_path / "sweep.json"
    records = port_tool.main(["--device", "cpu", "--json", str(out_file)])
    out = capsys.readouterr().out
    assert "16 MB" in out and "(8192, 512)" in out and "chains of 2 and 8" in out
    jax_names = [line.split(":")[0].rstrip() for line in recorded[1] if "ms/iter" in line]
    assert len(jax_names) == 2 + len(LEGS) + N_MANUAL_LEGS + 1
    want = [n.replace("xla", "torch") for n in jax_names if not n.startswith("manual")]
    study = [r for r in records if not r["library"]]
    assert [r["config"] for r in study] == want
    assert not any(r["config"].startswith("manual") for r in records)
    assert "not ported yet" in out and "rows 12-14" in out and sum("manual" in line for line in out.splitlines()) == 1
    assert [r["library"] for r in records] == [False] * len(want) + [True] * 4
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
    assert names[3:] == ["auto read  f32 bn=512", "auto read  f32 bn=2048", "auto copy  f32 bn=512",
                         "auto copy  f32 bn=2048", "hbm->hbm whole-array DMA (r+w)"]
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
