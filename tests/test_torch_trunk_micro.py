"""The port's trunk-kernel study (howl_tpu_torch/tools/) vs the JAX tool.

The JAX tool ``tools/bench_trunk_kernel_micro.py`` builds its two Pallas
kernels inside ``main``. A module-scoped fixture runs that ``main`` on the
CPU with ``pallas_call`` replaced by a recorder, which keeps each call's
kernel body, keyword arguments and arguments and returns zeros. The tests
then run the recorded kernel bodies through the real ``pallas_call`` in
interpret mode (as the tool does on the CPU) on seeded inputs, with the
tool's own weights, and hold the port's plain versions against them.

Tolerances, as multiples of the output's largest magnitude:
- the trunk proto, 2e-3: x and res are rounded to bf16 after every layer,
  and the two sides sum each layer's 432 products in other orders, so a
  float32 difference can flip a bf16 rounding, which the later layers and
  the 130-position window sums carry on; measured 1.7e-4 (full build) and
  8e-5 (gemm-only) here;
- the stem proto in float32, 1e-5: only the summation order differs;
- the stem proto in bf16, one bf16 ulp of that magnitude, where the order
  flips the final rounding.
"""

import contextlib
import importlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from howl_tpu_torch.tools import bench_trunk_kernel_micro as port_tool
from howl_tpu_torch.tools import trunk_kernels as tk

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU_GEOM = tk.trunk_geometry(2.0)  # the JAX tool's CPU size: 4 clips of 2 s


@pytest.fixture(scope="module")
def recorded():
    """The JAX tool's pallas_call calls at its CPU size: a list of (kernel,
    keyword arguments, arguments), the proto, its gemm-only variant, the
    stem proto."""
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


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(x).max()), 1e-30))) - 7)


def test_pool_matrix_and_geometry_equal_the_jax_tools(recorded):
    _, kw, args = recorded[0]
    assert CPU_GEOM.pos_pad == 640 and CPU_GEOM.pos == 530 and CPU_GEOM.n_win_pad == 128
    assert tuple(kw["out_shape"].shape) == (4, CPU_GEOM.n_win_pad, tk.CH_PAD)
    assert tuple(args[0].shape) == (4, CPU_GEOM.pos_pad, tk.CH_PAD)
    pool_t = np.asarray(jnp.asarray(args[7]).astype(jnp.float32))
    np.testing.assert_array_equal(pool_t, tk.build_pool_matrix(CPU_GEOM).T)
    np.testing.assert_array_equal(np.asarray(args[8]), np.full((8, 48), 0.9, np.float32))
    np.testing.assert_array_equal(np.asarray(args[9]), np.full((8, 48), 0.01, np.float32))


@pytest.mark.parametrize("clip_seconds", [1.0, 2.0, 8.0])
def test_pool_matrix_windows(clip_seconds):
    geom = tk.trunk_geometry(clip_seconds)
    m = tk.build_pool_matrix(geom)
    assert m.shape == (geom.pos_pad, geom.n_win_pad)
    assert not m[:, geom.n_win :].any()
    for w in range(geom.n_win):
        start = min(max(int(np.round(w * 5 / 3)), 0), geom.t_out - geom.span)
        want = np.zeros(geom.pos_pad, np.float32)
        want[start * tk.F_OUT : (start + geom.span) * tk.F_OUT] = 1.0
        np.testing.assert_array_equal(m[:, w], want)
    if clip_seconds == 8.0:  # the serving geometry: no start is clipped
        assert (geom.n_frames, geom.t_out, geom.pos, geom.pos_pad) == (641, 213, 2130, 2176)


def test_stem_prep_matches_its_docstring():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, CPU_GEOM.n_frames, 40)).astype(np.float32)
    got = tk.stem_prep(torch.from_numpy(mel)).numpy()
    want = np.zeros((2, 3, tk.Q_ROWS, 120), np.float32)
    for r in range(3):
        for q in range(tk.Q_ROWS):
            for dt in (-1, 0, 1):
                t = 3 * (q - 1) + r + dt
                if 0 <= t < CPU_GEOM.n_frames:
                    want[:, r, q, 40 * (dt + 1) : 40 * (dt + 2)] = mel[:, t]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tail", ["zero-tail", "nonzero-tail"])
@pytest.mark.parametrize("variant", ["full-build", "gemm-only"])
def test_trunk_proto_plain_matches_the_pallas_kernel(recorded, variant, tail):
    kernel, kw, args = recorded[0 if variant == "full-build" else 1]
    x = np.random.default_rng(5).standard_normal((4, CPU_GEOM.pos_pad, tk.CH_PAD)).astype(np.float32) * 0.5
    if tail == "zero-tail":
        x[:, CPU_GEOM.pos :] = 0.0
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pl.pallas_call(kernel, **kw)(xj, *args[1:]))
    got = tk.trunk_proto_plain(
        _torch(xj, torch.bfloat16), torch.stack([_torch(w, torch.bfloat16) for w in args[1:7]]),
        _torch(args[7], torch.bfloat16), _torch(args[8]), _torch(args[9]), CPU_GEOM.pos,
        full_build=variant == "full-build",
    ).numpy()
    assert got.shape == want.shape == (4, CPU_GEOM.n_win_pad, tk.CH_PAD)
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


def test_nonzero_tail_reaches_the_clipped_windows(recorded):
    """The input's tail rows [pos, pos_pad) feed layer 0 as given: they move
    the windows that end at the clip's end (clipped starts) and no window
    that ends more than six layers' reach (66 positions) before it."""
    _, _, args = recorded[0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, CPU_GEOM.pos_pad, 48)).astype(np.float32))
    zero_tail = x.clone()
    zero_tail[:, CPU_GEOM.pos :] = 0
    ops = (torch.stack([_torch(w, torch.bfloat16) for w in args[1:7]]), _torch(args[7], torch.bfloat16),
           _torch(args[8]), _torch(args[9]), CPU_GEOM.pos)
    a = tk.trunk_proto_plain(x.bfloat16(), *ops)
    b = tk.trunk_proto_plain(zero_tail.bfloat16(), *ops)
    moved = (a - b).abs().amax(dim=(0, 2)).numpy()[: CPU_GEOM.n_win]
    g = CPU_GEOM
    starts = np.clip(np.round(np.arange(g.n_win) * 5 / 3).astype(int), 0, g.t_out - g.span)
    far = (starts + g.span) * tk.F_OUT <= g.pos - 66
    assert far.any() and (moved[far] == 0).all()
    last = starts == g.t_out - g.span
    assert last.any() and (moved[last] > 0).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_stem_fold_plain_matches_the_pallas_kernel(recorded, out_dtype):
    kernel, kw, args = recorded[2]
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    kw = dict(kw, out_shape=jax.ShapeDtypeStruct(kw["out_shape"].shape, jdt))
    xpre = jnp.asarray(np.random.default_rng(7).standard_normal((4, 3, tk.Q_ROWS, 120)) * 0.5, jnp.bfloat16)
    w0fold = jnp.asarray(args[1])
    assert w0fold.dtype == jnp.bfloat16 and w0fold.shape == (120, 2048)
    want = np.asarray(pl.pallas_call(kernel, **kw)(xpre, w0fold).astype(jnp.float32))
    got = tk.stem_fold_plain(_torch(xpre, torch.bfloat16), _torch(w0fold, torch.bfloat16), out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == want.shape == (4, tk.Q_ROWS, 512)
    tol = 1e-5 * np.abs(want).max() if out_dtype == torch.float32 else _bf16_ulp(want)
    assert np.abs(got.float().numpy() - want).max() <= tol


def _proto_operands(b=2, geom=CPU_GEOM):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((b, geom.pos_pad, 48)).astype(np.float32)).bfloat16()
    ws = torch.from_numpy(rng.standard_normal((6, 432, 48)).astype(np.float32) * 0.05).bfloat16()
    pool_t = torch.from_numpy(tk.build_pool_matrix(geom).T.copy()).bfloat16()
    return x, ws, pool_t, torch.full((8, 48), 0.9), torch.full((8, 48), 0.01)


@pytest.mark.parametrize("full_build", [True, False])
def test_trunk_wrapper_takes_the_plain_route_on_the_cpu(full_build):
    ops = _proto_operands()
    before = tk.trunk_proto_cuda.launches
    got = tk.trunk_proto_cuda(*ops, CPU_GEOM.pos, full_build)
    torch.testing.assert_close(got, tk.trunk_proto_plain(*ops, CPU_GEOM.pos, full_build), rtol=0, atol=0)
    assert tk.trunk_proto_cuda.launches == before  # counts only kernel launches


def test_stem_wrapper_takes_the_plain_route_on_the_cpu():
    rng = np.random.default_rng(2)
    xpre = torch.from_numpy(rng.standard_normal((2, 3, tk.Q_ROWS, 120)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((120, 2048)).astype(np.float32) * 0.1).bfloat16()
    before = tk.stem_fold_cuda.launches
    for dt in (torch.bfloat16, torch.float32):
        torch.testing.assert_close(tk.stem_fold_cuda(xpre, w, dt), tk.stem_fold_plain(xpre, w, dt), rtol=0, atol=0)
    assert tk.stem_fold_cuda.launches == before


def test_wrappers_refuse_grad_wrong_operands_and_other_devices():
    x, ws, pool_t, sc, sh = _proto_operands()
    with pytest.raises(RuntimeError, match="no backward"):
        tk.trunk_proto_cuda(x.float().requires_grad_().bfloat16(), ws, pool_t, sc, sh, CPU_GEOM.pos)
    with pytest.raises(ValueError, match="bf16 activations"):
        tk.trunk_proto_cuda(x.float(), ws, pool_t, sc, sh, CPU_GEOM.pos)
    with pytest.raises(ValueError, match="weights"):
        tk.trunk_proto_cuda(x, ws[:5], pool_t, sc, sh, CPU_GEOM.pos)
    with pytest.raises(ValueError, match="pool_t"):
        tk.trunk_proto_cuda(x, ws, pool_t[:, :-16], sc, sh, CPU_GEOM.pos)
    with pytest.raises(ValueError, match="pos 641"):
        tk.trunk_proto_cuda(x, ws, pool_t, sc, sh, 641)
    xpre = torch.zeros((1, 3, tk.Q_ROWS, 120), dtype=torch.bfloat16)
    w = torch.zeros((120, 2048), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        tk.stem_fold_cuda(xpre, w.float().requires_grad_().bfloat16())
    with pytest.raises(ValueError, match="xpre"):
        tk.stem_fold_cuda(xpre.float(), w)
    with pytest.raises(TypeError, match="out_dtype"):
        tk.stem_fold_cuda(xpre, w, torch.float16)
    meta = [t.to("meta") for t in (x, ws, pool_t, sc, sh)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.trunk_proto_cuda(*meta, CPU_GEOM.pos)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.stem_fold_cuda(xpre.to("meta"), w.to("meta"))


def test_port_tool_runs_all_seven_legs_on_the_cpu(capsys):
    results = port_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch 4 x 2 s" in out
    assert len(results) == 7
    for name, rec in results.items():
        assert name in out
        assert len(rec["ms"]) == port_tool.REPEATS and all(np.isfinite(rec["ms"]))
        assert rec["route"] in ("torch, cpu", "plain, cpu")
    assert sum(rec["route"] == "plain, cpu" for rec in results.values()) == 3  # legs 3, 4 and 6


def test_port_tool_inputs_follow_the_jax_tools_draws(recorded):
    """The same seed gives the JAX tool's proto and stem weights."""
    inp = port_tool.make_inputs(4, 2.0, 0, torch.device("cpu"))
    for i in range(6):
        np.testing.assert_array_equal(inp.ws_full[i].float().numpy(), _torch(recorded[0][2][1 + i]).numpy())
        np.testing.assert_array_equal(inp.ws_gemm[i].float().numpy(), _torch(recorded[1][2][1 + i]).numpy())
    np.testing.assert_array_equal(inp.w0fold.float().numpy(), _torch(recorded[2][2][1]).numpy())
    assert tuple(inp.x_pm.shape) == (4, CPU_GEOM.pos_pad, 48) and inp.x_pm.dtype == torch.bfloat16
    assert not inp.x_pm[:, CPU_GEOM.pos :].any() and not inp.x_pm[..., tk.CH :].any()
