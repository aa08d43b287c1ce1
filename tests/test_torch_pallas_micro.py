"""The port's frontend cost study (howl_tpu_torch/tools/) vs the JAX tool.

The JAX tool ``tools/bench_pallas_micro.py`` builds its three Pallas kernels
inside ``main``. A module-scoped fixture runs that ``main`` on the CPU with
``pallas_call`` replaced by a recorder, which keeps each call's kernel body,
keyword arguments and arguments and returns zeros (the arguments that depend
on the timed chain are tracers; the weights are concrete). The tests then run
the recorded kernel bodies through the real ``pallas_call`` in interpret mode
on seeded inputs with a nonzero scalar, and hold the port's plain versions
against them.

Tolerances: the stream leg is one float32 add and is held bit for bit. The
GEMM and polyphase legs sum 512 (or 3 x 200) products of bf16 values in
float32; the two sides differ only in the order of those sums, and are held
to 1e-5 of the output's largest magnitude (measured 2e-7 here).
"""

import contextlib
import importlib
import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import howl_tpu.ops.frontend as jfe
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.tools import bench_hbm_sweep as sweep_tool
from howl_tpu_torch.tools import bench_pallas_micro as port_tool
from howl_tpu_torch.tools import bench_trunk_kernel_micro as trunk_tool
from howl_tpu_torch.tools import frontend_micro_kernels as mk
from howl_tpu_torch.tools import validate_pallas_precision as precision_tool
from howl_tpu_torch.tools import ablate_serving_slope as serving_ablation
from howl_tpu_torch.tools import ablate_train_step as train_ablation
from howl_tpu_torch.tools import reconcile_train_f32 as reconcile_tool
from howl_tpu_torch.tools import validate_tpu_decisions as decisions_tool

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU_GEOM = mk.micro_geometry(4, 2.0)  # the JAX tool's CPU size: 4 clips of 2 s
S = 0.3125  # the nonzero scalar of the comparisons
LEGS = {"stream": 0, "gemm1": 1, "gemm3": 2, "poly1": 3, "poly3": 4}


@pytest.fixture(scope="module")
def recorded():
    """The JAX tool's pallas_call calls at its CPU size: a list of (kernel,
    keyword arguments, arguments): stream, gemm x1 and x3, poly x1 and x3."""
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


def _interpret(call, *operands):
    kernel, kw, _ = call
    return np.asarray(pl.pallas_call(kernel, **kw, interpret=True)(*operands, jnp.asarray([S], jnp.float32)))


def _torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def _seeded(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * np.float32(0.1)


@pytest.mark.parametrize("center", [True, False], ids=["center", "no-center"])
@pytest.mark.parametrize("shape", [(3, 1000), (2, 2, 8000), (1, 777)], ids=["2d", "3d", "ragged"])
def test_frame_signal_equals_the_jax_packages(shape, center):
    """Bit for bit; 1000 and 777 samples are no whole number of hops, so the
    hop-row view needs its zero tail."""
    audio = _seeded(shape, 11)
    want = np.asarray(jfe.frame_signal(jnp.asarray(audio), jfe.FrontendConfig(center=center)))
    got = tfe.frame_signal(torch.from_numpy(audio), tfe.FrontendConfig(center=center))
    assert tuple(got.shape) == want.shape == (*shape[:-1], tfe.FrontendConfig(center=center).num_frames(shape[-1]), 512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_signal_other_geometry_and_whole_hops():
    """n_fft a whole number of hops (no remainder slice), as the JAX code branches."""
    audio = _seeded((2, 4000), 12)
    for kw in ({"n_fft": 400, "hop_length": 160}, {"n_fft": 512, "hop_length": 256}):
        want = np.asarray(jfe.frame_signal(jnp.asarray(audio), jfe.FrontendConfig(**kw)))
        np.testing.assert_array_equal(tfe.frame_signal(torch.from_numpy(audio), tfe.FrontendConfig(**kw)).numpy(), want)


def test_geometry_equals_the_jax_tools(recorded):
    g = CPU_GEOM
    assert (g.n_frames, g.total, g.n_blocks, g.n_sub, g.t_pad, g.rows) == (161, 512, 2, 3, 128, 256)
    for leg in ("stream", "gemm1", "gemm3"):
        _, kw, args = recorded[LEGS[leg]]
        assert kw["grid"] == (g.n_blocks,)
        assert tuple(args[0].shape) == (g.total, g.n_fft)
        assert tuple(kw["out_shape"].shape) == (g.total, mk.OUT_COLS)
    for leg in ("poly1", "poly3"):
        _, kw, args = recorded[LEGS[leg]]
        assert kw["grid"] == (g.batch, g.t_pad // mk.POLY_FB)
        assert tuple(args[0].shape) == (g.batch, g.rows, g.hop)
        assert tuple(kw["out_shape"].shape) == (g.batch, g.t_pad, mk.OUT_COLS)
    full = mk.micro_geometry(512, 8.0)
    assert (full.n_frames, full.total, full.n_blocks, full.t_pad, full.rows) == (641, 328192, 1282, 640, 768)


def test_inputs_follow_the_jax_tools_draws(recorded):
    """The same seed gives the JAX tool's W and its zero-padded W_j blocks."""
    inp = port_tool.make_inputs(4, 2.0, 0, torch.device("cpu"))
    assert inp.w.dtype == torch.bfloat16
    for leg in ("gemm1", "gemm3"):
        np.testing.assert_array_equal(inp.w.float().numpy(), _torch_bf16(recorded[LEGS[leg]][2][1]).float().numpy())
    blocks = mk.poly_weight_blocks(inp.w, CPU_GEOM.hop)
    assert tuple(blocks.shape) == (3, 200, 512) and not blocks[2, 112:].any()
    for j in range(3):
        np.testing.assert_array_equal(blocks[j].float().numpy(), _torch_bf16(recorded[LEGS["poly1"]][2][2 + j]).float().numpy())
    assert tuple(inp.frames.shape) == (CPU_GEOM.total, 512) and tuple(inp.h.shape) == (4, CPU_GEOM.rows, 200)
    # the hop rows are the audio as it is, then zeros
    np.testing.assert_array_equal(inp.h.reshape(4, -1)[:, : CPU_GEOM.samples].numpy(), inp.audio.numpy())
    assert not inp.h.reshape(4, -1)[:, CPU_GEOM.samples :].any()


def test_stream_plain_matches_the_pallas_kernel_bitwise(recorded):
    x = _seeded((CPU_GEOM.total, 512), 21)
    want = _interpret(recorded[LEGS["stream"]], jnp.asarray(x))
    got = mk.stream_plain(torch.from_numpy(x), S).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (CPU_GEOM.total, mk.OUT_COLS)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_dots", [1, 3])
def test_gemm_plain_matches_the_pallas_kernel(recorded, n_dots):
    call = recorded[LEGS[f"gemm{n_dots}"]]
    x = _seeded((CPU_GEOM.total, 512), 22)
    w = call[2][1]
    want = _interpret(call, jnp.asarray(x), w)
    got = mk.gemm_plain(torch.from_numpy(x), _torch_bf16(w), S, n_dots).numpy()
    assert got.shape == want.shape == (CPU_GEOM.total, mk.OUT_COLS)
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_dots", [1, 3])
def test_poly_plain_matches_the_pallas_kernel(recorded, n_dots):
    call = recorded[LEGS[f"poly{n_dots}"]]
    g = CPU_GEOM
    h = _seeded((g.batch, g.rows, g.hop), 23)
    w_js = call[2][2:5]
    want = _interpret(call, jnp.asarray(h), jnp.asarray(h), *w_js)
    w = torch.cat([_torch_bf16(wj) for wj in w_js])[: g.n_fft]  # the blocks stacked are W over its zero rows
    got = mk.poly_plain(torch.from_numpy(h), w, S, g.t_pad, n_dots).numpy()
    assert got.shape == want.shape == (g.batch, g.t_pad, mk.OUT_COLS)
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_three_dots_are_three_times_one_and_three_passes_are_one(recorded):
    """What the n_dots of each leg mean: the GEMM legs add identical products,
    the polyphase legs start every pass anew."""
    inp = port_tool.make_inputs(4, 2.0, 0, torch.device("cpu"))
    g1, g3 = mk.gemm_plain(inp.frames, inp.w, S, 1), mk.gemm_plain(inp.frames, inp.w, S, 3)
    torch.testing.assert_close(g3, (g1 + g1) + g1, rtol=0, atol=0)
    p1, p3 = mk.poly_plain(inp.h, inp.w, S, CPU_GEOM.t_pad, 1), mk.poly_plain(inp.h, inp.w, S, CPU_GEOM.t_pad, 3)
    torch.testing.assert_close(p3, p1, rtol=0, atol=0)


def test_polyphase_identity_between_the_plain_versions():
    """M3 on the hop rows equals M2 on the frames of the same audio (framed
    without center padding, as the hop rows are), for the frames both cover,
    up to the order of the sums."""
    inp = port_tool.make_inputs(4, 2.0, 0, torch.device("cpu"))
    frames = tfe.frame_signal(inp.audio, tfe.FrontendConfig(center=False))  # (4, 158, 512)
    n = min(frames.shape[1], CPU_GEOM.t_pad)
    via_frames = mk.gemm_plain(frames[:, :n].reshape(-1, 512), inp.w, S).reshape(4, n, mk.OUT_COLS)
    via_hops = mk.poly_plain(inp.h, inp.w, S, CPU_GEOM.t_pad)[:, :n]
    assert n == 128
    assert float((via_frames - via_hops).abs().max()) <= 1e-5 * float(via_frames.abs().max())


def test_scalar_add_rounds_to_bf16_ties_to_even():
    """x + s is formed in float32 and then rounded: 1 + 2^-8 lies half-way
    between two bf16 values and goes to the even one, 1 + 3 * 2^-8 goes up."""
    w = torch.eye(512).to(torch.bfloat16)
    x = torch.zeros((4, 512))
    x[:, 0], x[:, 1], x[:, 2] = 1.0, 1.0 + 2.0**-7, 0.5
    got = mk.gemm_plain(x, w, 2.0**-8, 1)
    assert got[0, 0].item() == 1.0  # tie, to even (down)
    assert got[0, 1].item() == 1.0 + 2.0**-6  # tie, to even (up)
    assert got[0, 2].item() == 0.5 + 2.0**-8  # exact in bf16


def test_wrappers_take_the_plain_route_on_the_cpu():
    inp = port_tool.make_inputs(4, 2.0, 0, torch.device("cpu"))
    before = (mk.stream_cuda.launches, mk.gemm_cuda.launches, mk.poly_cuda.launches)
    torch.testing.assert_close(mk.stream_cuda(inp.frames, S), mk.stream_plain(inp.frames, S), rtol=0, atol=0)
    torch.testing.assert_close(mk.gemm_cuda(inp.frames, inp.w, S, 3), mk.gemm_plain(inp.frames, inp.w, S, 3), rtol=0, atol=0)
    torch.testing.assert_close(mk.poly_cuda(inp.h, inp.w, S, 128, 3), mk.poly_plain(inp.h, inp.w, S, 128, 3), rtol=0, atol=0)
    assert (mk.stream_cuda.launches, mk.gemm_cuda.launches, mk.poly_cuda.launches) == before  # kernel launches only


def test_wrappers_refuse_grad_wrong_operands_and_other_devices():
    x, w, h = torch.zeros((64, 512)), torch.zeros((512, 512), dtype=torch.bfloat16), torch.zeros((2, 66, 200))
    with pytest.raises(RuntimeError, match="no backward"):
        mk.stream_cuda(x.clone().requires_grad_(), S)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.gemm_cuda(x, w.float().requires_grad_().bfloat16(), S)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.poly_cuda(h.clone().requires_grad_(), w, S, 64)
    with pytest.raises(ValueError, match="float32 frames"):
        mk.stream_cuda(x.double(), S)
    with pytest.raises(ValueError, match="bf16 w"):
        mk.gemm_cuda(x, w.float(), S)
    with pytest.raises(ValueError, match="bf16 w"):
        mk.gemm_cuda(x, w[:256], S)
    with pytest.raises(ValueError, match="n_dots"):
        mk.gemm_cuda(x, w, S, 0)
    with pytest.raises(TypeError, match="Python number"):
        mk.gemm_cuda(x, w, torch.tensor(S))
    with pytest.raises(ValueError, match="hop rows"):
        mk.poly_cuda(h, w, S, 65)
    with pytest.raises(ValueError, match="float32 hop rows"):
        mk.poly_cuda(h.bfloat16(), w, S, 64)
    for fn, ops in ((mk.stream_cuda, (x,)), (mk.gemm_cuda, (x, w)), (mk.poly_cuda, (h, w))):
        meta = [t.to("meta") for t in ops]
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(*meta, S, *((64,) if fn is mk.poly_cuda else ()))


def test_port_tool_runs_all_legs_on_the_cpu(capsys):
    results = port_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch 4 x 2 s" in out and "512 frame rows" in out
    names = list(results)
    assert names[:6] == ["stream-only FB=256", "gemm1-bf16  FB=256", "gemm3-bf16  FB=256",
                         "polyphase x1 (1-pass dft)", "polyphase x3 (3-pass dft)", "framing only"]
    assert len(names) == 9  # and three library legs
    for name, rec in results.items():
        assert name in out
        assert len(rec["ms"]) == port_tool.REPEATS and all(np.isfinite(rec["ms"]))
        assert rec["route"] in ("torch, cpu", "plain, cpu")
    assert sum(rec["route"] == "plain, cpu" for rec in results.values()) == 5


def test_precision_tool_runs_on_the_cpu_and_the_f32_grade_meets_the_golden_bounds(capsys):
    records = precision_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [(r["n_mels"], r["grade"]) for r in records] == [(m, g) for m in (40, 80) for g in precision_tool.GRADES]
    assert out.count("above_floor_max=") == 8
    for rec in records:
        assert all(np.isfinite([rec["above_floor_max"], rec["global_max"], rec["mean"]]))
        if rec["grade"] == "f32":  # tests/test_torch_frontend.py's bounds against the goldens
            assert rec["above_floor_max"] < 3e-3 and rec["global_max"] < 0.02


def test_precision_tool_holds_each_grade_to_its_golden_bounds():
    """``within_golden_bounds``: the plain "f32" and "bf16x3" within
    tests/test_golden_frontend.py's bounds on the goldens (the three-pass
    grade's tiers, as the JAX kernel's test holds its default grade), and a
    record that misses a tier fails."""
    records = precision_tool.run(torch.device("cpu"))
    assert all(len(r["tier_max"]) == len(precision_tool.BF16X3_TIERS) for r in records)
    assert all(precision_tool.within_golden_bounds(r) for r in records)
    x3 = next(r for r in records if r["grade"] == "bf16x3")
    worse = dict(x3, tier_max=[x3["tier_max"][0] + precision_tool.BF16X3_TIERS[0][1], *x3["tier_max"][1:]])
    assert not precision_tool.within_golden_bounds(worse)


@pytest.mark.parametrize("tool", [port_tool, trunk_tool, precision_tool, sweep_tool, decisions_tool, serving_ablation,
                                  train_ablation, reconcile_tool],
                         ids=["bench_pallas_micro", "bench_trunk_kernel_micro", "validate_pallas_precision",
                              "bench_hbm_sweep", "validate_tpu_decisions", "ablate_serving_slope", "ablate_train_step",
                              "reconcile_train_f32"])
def test_tools_refuse_to_run_without_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    """The default device is the card: without one the tool raises and names
    the flag, and picks no CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])
