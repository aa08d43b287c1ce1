"""The port's int8 residual trunk (howl_tpu_torch/ops/int8_trunk.py) and its
int8 serving engine against howl_tpu's, on the CPU.

The port runs the plain versions: its kernel's wrapper takes them for a CPU
tensor. The JAX engine runs its Pallas stem in interpret mode
(``use_pallas_stem=True``), as tests/test_torch_engine.py's does. Inputs are
seeded numpy.

Tolerances:
* quantized weights, weight scales and folded BN affines: bit for bit (the
  same float32 numpy formula on the same weights);
* the float32 residual reference: 1e-5 absolute (float32 convs summed in
  other orders);
* the calibrated activation scales: 1e-5 relative (max |x| of that reference);
* the int8 trunk with the SAME activation scales on both sides (a scale that
  differs in its last bit can move a round across .5): float32 within 1e-5
  absolute, bf16 within 2 bf16 ulps of each output (both sides round at the
  same points; the bound leaves room for a backend that fuses a product and
  a sum);
* the s32 sums: exact, against an int64 numpy convolution, at the +-127
  extremes where |acc| reaches 127 * 127 * 405 = 6,532,245 < 2^24;
* the engines' posteriors on the same stem output and scales: 1e-4
  (float32) and 2e-2 (bf16), decisions equal on a configuration where some
  clips fire and some do not; each engine on its own stem and calibration:
  decisions equal, posteriors 2e-2. The port calibrates from the float32
  weights (ROADMAP F3); the JAX engine from its compute-dtype copy, so its
  bf16 engine quantizes other weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference import StreamingEngine as JaxStreamingEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.models.base import model_spec as jax_model_spec
from howl_tpu.ops import int8_trunk as jint8
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig, StreamingEngine
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops import int8_trunk as tint8
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.tools import bench_stream_step_int8, bench_trunk_int8
from tests.test_torch_engine import BASE, DECISIONS, SR, ZMUV, _audio, _variables

torch.set_num_threads(1)


def _stem_like(seed, shape=(2, 31, 10, 45), scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_ulps(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the magnitude of each element (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.fixture(scope="module")
def weights():
    variables = _variables(41)
    return variables, res8_variables_to_state_dict(variables)


# ---- the module against howl_tpu.ops.int8_trunk ----


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_quantize_residual_trunk_bit_for_bit(seed):
    variables = _variables(seed)
    scales = tuple(0.01 * (i + 1) for i in range(6))
    want = jint8.quantize_residual_trunk(variables, scales)
    got = tint8.quantize_residual_trunk(res8_variables_to_state_dict(variables), scales)
    for field in ("w_i8", "w_scale", "bn_scale", "bn_shift"):
        for i in range(6):
            w, g = np.asarray(getattr(want, field)[i]), getattr(got, field)[i].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=f"{field}[{i}]")
    assert got.act_scale == want.act_scale
    with pytest.raises(ValueError, match="6 activation scales"):
        tint8.quantize_residual_trunk(res8_variables_to_state_dict(variables), scales[:5])


def test_float_residual_reference_matches_jax_and_res8(weights):
    variables, state = weights
    y = _stem_like(1)
    got = tint8.float_residual_reference(torch.from_numpy(y), state)
    np.testing.assert_allclose(got.numpy(), np.asarray(jint8.float_residual_reference(jnp.asarray(y), variables)),
                               rtol=0, atol=1e-5)
    model = create_model("res8", num_labels=4)
    model.load_state_dict(state)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), model.eval().residual_features(torch.from_numpy(y)).numpy(),
                                   rtol=0, atol=1e-5)
    out, inputs = tint8.float_residual_reference(torch.from_numpy(y), state, capture=True)
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    assert len(inputs) == 6 and torch.equal(inputs[0], torch.from_numpy(y))


@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_calibrate_act_scales_matches_jax(weights, margin):
    variables, state = weights
    y = _stem_like(2)
    want = np.array(jint8.calibrate_act_scales(jnp.asarray(y), variables, margin))
    got = np.array(tint8.calibrate_act_scales(torch.from_numpy(y), state, margin))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [3, 4])
def test_residual_features_int8_matches_jax(weights, dtype, seed):
    variables, state = weights
    y = _stem_like(seed)
    scales = jint8.calibrate_act_scales(jnp.asarray(y), variables)  # the same scales on both sides
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jint8.residual_features_int8(jnp.asarray(y), jint8.quantize_residual_trunk(variables, scales),
                                                   compute_dtype=jdt).astype(jnp.float32))
    got = tint8.residual_features_int8(torch.from_numpy(y), tint8.quantize_residual_trunk(state, scales), tdt)
    assert got.dtype == (tdt or torch.float32) and tuple(got.shape) == y.shape
    err = np.abs(got.float().numpy() - want)
    if dtype == "f32":
        assert err.max() <= 1e-5
    else:
        assert (err <= 2 * _bf16_ulps(want)).all(), err.max()
    # and close to the float32 trunk: the quantization noise (tests/test_int8_trunk.py's bound)
    ref = tint8.float_residual_reference(torch.from_numpy(y), state).numpy()
    assert np.abs(got.float().numpy() - ref).max() / np.abs(ref).max() < 0.05


@pytest.mark.parametrize("pattern", ["extremes", "all_max", "mixed"])
def test_int8_sums_exact_against_int64_numpy(pattern):
    rng = np.random.default_rng(5)
    shape, wshape = (2, 7, 5, 45), (3, 3, 45, 45)
    if pattern == "extremes":
        xq, w = (rng.choice([-127, 127], s).astype(np.int8) for s in (shape, wshape))
    elif pattern == "all_max":
        xq, w = np.full(shape, 127, np.int8), np.full(wshape, 127, np.int8)
    else:
        xq, w = (rng.integers(-127, 128, s).astype(np.int8) for s in (shape, wshape))
    got = tint8.int8_conv_sums_plain(torch.from_numpy(xq), torch.from_numpy(w)).numpy()
    pad = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros(shape, np.int64)
    for kh in range(3):
        for kw in range(3):
            want += pad[:, kh : kh + shape[1], kw : kw + shape[2]] @ w[kh, kw].astype(np.int64)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if pattern == "all_max":
        assert want.max() == 127 * 127 * 9 * 45


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.6, 200.0, -300.0])
    assert tint8.quantize_activations(x, 1.0).tolist() == [0, 2, 2, 0, -2, 127, 127, -127]
    np.testing.assert_array_equal(
        tint8.quantize_activations(x, 0.37).numpy(),
        np.clip(np.round(x.numpy() * np.float32(1.0 / 0.37)), -127, 127).astype(np.int8))


# ---- the kernel's host side: the weight image and its decomposition ----


def test_pack_w_image_holds_every_weight_once():
    w = torch.from_numpy(np.random.default_rng(6).integers(-127, 128, (3, 3, 45, 45)).astype(np.int8))
    img = tint8.pack_w_image(w)
    assert img.dtype == torch.uint8 and img.numel() == tint8.W_IMAGE_BYTES == 21504
    frag = img.view(torch.int8).reshape(tint8.K_STEPS, 6, 8, 4, 2, 4)  # s, nt, g, t, j, i
    b = frag.permute(0, 4, 3, 5, 1, 2).reshape(tint8.K_STEPS * 32, 48)  # k = 32 s + 16 j + 4 t + i, n = 8 nt + g
    want = torch.zeros((tint8.K_STEPS * 32, 48), dtype=torch.int8)
    for kh in range(3):
        for kw in range(3):
            tap = 3 * kh + kw
            want[tap * 48 : tap * 48 + 45, :45] = w[kh, kw]
    assert torch.equal(b, want)
    with pytest.raises(ValueError, match="int8"):
        tint8.pack_w_image(w.float())
    with pytest.raises(ValueError, match="48 channels"):
        tint8.pack_w_image(torch.zeros((3, 3, 49, 49), dtype=torch.int8))


def _kernel_sums(xq: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """A torch emulation of csrc/int8_trunk.cu's decomposition: per block of
    ``block_frames(F)`` frames, the s8 tile with its halo frames and zero
    columns at 48 bytes a position, each row's A register read at the
    position's byte offset plus the tap's, and B from the packed image."""
    b_n, t_n, f_n, c = xq.shape
    tt, row = tint8.block_frames(f_n), (f_n + 2) * 48
    frag = tint8.pack_w_image(w_i8).view(torch.int8).reshape(tint8.K_STEPS, 6, 8, 4, 2, 4)
    bmat = frag.permute(0, 4, 3, 5, 1, 2).reshape(tint8.K_STEPS * 32, 48).long()
    k = torch.arange(tint8.K_STEPS * 32)
    k16 = k - k % 16  # each 16 consecutive k lie in one tap
    tap = torch.clamp(k16 // 48, max=8)
    koff = ((tap // 3 - 1) * (f_n + 2) + (tap % 3 - 1)) * 48 + k16 % 48 + k % 16
    out = torch.zeros((b_n, t_n, f_n, 48), dtype=torch.long)
    for bi in range(b_n):
        for t0 in range(0, t_n, tt):
            tv = min(tt, t_n - t0)
            tile = torch.zeros((tt + 2, f_n + 2, 48), dtype=torch.int8)
            lo, hi = max(t0 - 1, 0), min(t0 + tv + 1, t_n)
            tile[lo - (t0 - 1) : hi - (t0 - 1), 1 : f_n + 1, :c] = xq[bi, lo:hi]
            flat = tile.reshape(-1).long()
            p = torch.arange(tv * f_n)
            base = (p // f_n + 1) * row + (p % f_n + 1) * 48
            a = flat[base[:, None] + koff[None, :]] * (k < 432)[None, :]  # the last half step's A is zero
            out[bi, t0 : t0 + tv] = (a @ bmat).reshape(tv, f_n, 48)
    return out[..., :c].int()


@pytest.mark.parametrize("t_n,f_n", [(213, 10), (7, 10), (26, 10), (5, 1), (3, 17), (9, 64)])
def test_kernel_decomposition_equals_the_plain_sums(t_n, f_n):
    rng = np.random.default_rng(t_n * 100 + f_n)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, t_n, f_n, 45)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 45, 45)).astype(np.int8))
    assert torch.equal(_kernel_sums(xq, w), tint8.int8_conv_sums_plain(xq, w))


def test_block_frames_fill_the_kernels_256_positions():
    assert tint8.block_frames(10) == 25 and tint8.block_frames(1) == 256 and tint8.block_frames(64) == 4
    assert all(tint8.block_frames(f) * f <= tint8.BLOCK_POSITIONS for f in range(1, 257))


def test_layer_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing(weights):
    _, state = weights
    p = tint8.quantize_residual_trunk(state, [0.05] * 6)
    x = torch.from_numpy(_stem_like(7)).to(torch.bfloat16)
    before = tint8.int8_conv_layer_cuda.launches
    out, pre = tint8.int8_conv_layer_cuda(x, p.w_i8[1], 0.05, p.w_scale[1], p.bn_scale[1], p.bn_shift[1], x,
                                          keep_pre=True)
    want_out, want_pre = tint8.int8_conv_layer_plain(x, p.w_i8[1], 0.05, p.w_scale[1], p.bn_scale[1], p.bn_shift[1], x)
    assert torch.equal(out, want_out) and torch.equal(pre, want_pre) and out.dtype == torch.bfloat16
    assert tint8.int8_conv_layer_cuda(x, p.w_i8[0], 0.05, p.w_scale[0])[1] is None
    assert tint8.int8_conv_layer_cuda.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        tint8.int8_conv_layer_cuda(x.float().requires_grad_(), p.w_i8[0], 0.05, p.w_scale[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tint8.int8_conv_layer_cuda(x.to("meta"), p.w_i8[0], 0.05, p.w_scale[0])


# ---- the engine against howl_tpu's StreamingEngine(use_int8_trunk=True) ----


def _jax_engine(variables, cfg_kw, compute_dtype=None, **kw):
    return JaxStreamingEngine(
        jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw), JaxFrontendConfig(n_mels=40),
        *ZMUV, spec=jax_model_spec("res8"), compute_dtype=compute_dtype, use_pallas_stem=True, **kw,
    )


def _port_engine(state, cfg_kw, compute_dtype=None, **kw):
    return StreamingEngine(create_model("res8", num_labels=4), state, EngineConfig(**cfg_kw), FrontendConfig(n_mels=40),
                           *ZMUV, compute_dtype=compute_dtype, device="cpu", **kw)


@pytest.fixture(scope="module")
def int8_setup():
    """Weights, audio to score, calibration audio, and a one-word
    configuration whose threshold splits the batch, from the JAX float32
    engine's posteriors."""
    variables = _variables(21)
    audio, cal = _audio(22), _audio(23)
    probe = np.asarray(_jax_engine(variables, BASE).score_batch(audio)["probs"])
    half = probe.shape[0] // 2
    word = int(np.bincount(probe[:half].argmax(-1).ravel(), minlength=4).argmax())
    peak = probe.max(-1).max(-1)
    quiet, loud = float(peak[half:].max()), float(peak[:half].min())
    assert loud - quiet > 0.1, "the probe batch does not split: no threshold separates the clips"
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4,
                  inference_threshold=(quiet + loud) / 2)
    return variables, audio, cal, cfg_kw


def test_engine_refuses_int8_without_calibration_or_off_the_fused_trunk(int8_setup):
    variables, _, cal, cfg_kw = int8_setup
    state = res8_variables_to_state_dict(variables)
    for make, args in ((_jax_engine, variables), (_port_engine, state)):
        with pytest.raises(ValueError, match="requires int8_calibration_audio"):
            make(args, cfg_kw, use_int8_trunk=True)
    with pytest.raises(ValueError, match="fused-trunk scorer only"):
        _jax_engine(variables, cfg_kw, fused_trunk=False, use_int8_trunk=True, int8_calibration_audio=cal)
    with pytest.raises(ValueError, match="fused-trunk scorer only"):
        _port_engine(state, cfg_kw, fused_trunk=False, use_int8_trunk=True, int8_calibration_audio=cal)


def _params_equal(a: tint8.Int8TrunkParams, b: tint8.Int8TrunkParams) -> bool:
    return a.act_scale == b.act_scale and all(
        torch.equal(x, y) for field in ("w_i8", "w_scale", "bn_scale", "bn_shift")
        for x, y in zip(getattr(a, field), getattr(b, field)))


def test_variables_assignment_requantizes(int8_setup):
    """ROADMAP F2: the quantized weights and the activation scales follow a
    new checkpoint, and equal a fresh engine's."""
    variables, audio, cal, cfg_kw = int8_setup
    other = res8_variables_to_state_dict(_variables(31))
    eng = _port_engine(res8_variables_to_state_dict(variables), cfg_kw, use_int8_trunk=True, int8_calibration_audio=cal)
    before, probs = eng._int8_params, eng.score_batch(audio)["probs"]
    eng.variables = other
    fresh = _port_engine(other, cfg_kw, use_int8_trunk=True, int8_calibration_audio=cal)
    assert not torch.equal(before.w_i8[0], eng._int8_params.w_i8[0]) and before.act_scale != eng._int8_params.act_scale
    assert _params_equal(eng._int8_params, fresh._int8_params)
    after = eng.score_batch(audio)["probs"]
    assert float((after - probs).abs().max()) > 1e-3
    torch.testing.assert_close(after, fresh.score_batch(audio)["probs"], rtol=0, atol=0)


def test_bf16_engine_quantizes_the_float32_weights(int8_setup):
    """ROADMAP F3: a bf16 engine calibrates and quantizes from the float32
    weights it was given, not their bf16 copy: its int8 weights are the JAX
    package's quantization of the float32 variables, bit for bit, and its
    activation scales the float32 engine's."""
    variables, _, cal, cfg_kw = int8_setup
    state = res8_variables_to_state_dict(variables)
    bf16 = _port_engine(state, cfg_kw, torch.bfloat16, use_int8_trunk=True, int8_calibration_audio=cal)._int8_params
    f32 = _port_engine(state, cfg_kw, use_int8_trunk=True, int8_calibration_audio=cal)._int8_params
    assert _params_equal(bf16, f32)
    want = jint8.quantize_residual_trunk(variables, bf16.act_scale)
    for i in range(6):
        np.testing.assert_array_equal(bf16.w_i8[i].numpy(), np.asarray(want.w_i8[i]))
        np.testing.assert_array_equal(bf16.w_scale[i].numpy(), np.asarray(want.w_scale[i]))
    # the JAX bf16 engine quantizes the bf16 copy instead: other weights
    jax_bf16 = _jax_engine(variables, cfg_kw, jnp.bfloat16, use_int8_trunk=True, int8_calibration_audio=cal)
    assert any(not np.array_equal(np.asarray(jax_bf16._int8_params.w_i8[i]), bf16.w_i8[i].numpy()) for i in range(6))


def test_float32_engine_int8_params_equal_the_jax_engines(int8_setup):
    variables, _, cal, cfg_kw = int8_setup
    want = _jax_engine(variables, cfg_kw, use_int8_trunk=True, int8_calibration_audio=cal)._int8_params
    got = _port_engine(res8_variables_to_state_dict(variables), cfg_kw, use_int8_trunk=True,
                       int8_calibration_audio=cal)._int8_params
    for field in ("w_i8", "w_scale", "bn_scale", "bn_shift"):
        for i in range(6):
            np.testing.assert_array_equal(getattr(got, field)[i].numpy(), np.asarray(getattr(want, field)[i]))
    # the calibration stems differ in their float32 sums' order only
    np.testing.assert_allclose(np.array(got.act_scale), np.array(want.act_scale), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_int8_engine_matches_the_jax_int8_engine(int8_setup, dtype, atol):
    """Posteriors and decisions of the two int8 engines on the same stem
    output and activation scales: the port's engine scores the JAX engine's
    pooled stem with the JAX engine's scales. The stems are held against each
    other in tests/test_torch_engine.py and the calibration above; a float32
    stem or scale that differs in its last bit can move a quantize's round
    across .5 and a posterior by ~1e-3, so the whole engines are compared on
    their decisions (below)."""
    variables, audio, cal, cfg_kw = int8_setup
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jeng = _jax_engine(variables, cfg_kw, jdt, use_int8_trunk=True, int8_calibration_audio=cal)
    state = res8_variables_to_state_dict(variables)
    teng = _port_engine(state, cfg_kw, tdt, use_int8_trunk=True, int8_calibration_audio=cal)
    teng._int8_params = tint8.quantize_residual_trunk(state, jeng._int8_params.act_scale)
    stem = np.array(jeng._pooled_stem(jeng.variables, jnp.asarray(audio)).astype(jnp.float32))
    teng._pooled_stem = lambda a: torch.from_numpy(stem).to(tdt or torch.float32)
    lengths = np.array([2 * SR, 21000, 2 * SR, 2 * SR - 3000], np.int32)
    want, got = jeng.infer_batch(audio, lengths), teng.infer_batch(audio, lengths)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=0, atol=atol)
    for key in DECISIONS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    fired = int(np.asarray(want["detected"]).sum())
    assert 0 < fired < len(audio), "the configuration must split the batch"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_engines_decide_alike_on_their_own_stems(int8_setup, dtype):
    """The whole engines, each with its own stem and calibration: decisions
    equal, posteriors within 2e-2."""
    variables, audio, cal, cfg_kw = int8_setup
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax_engine(variables, cfg_kw, jdt, use_int8_trunk=True, int8_calibration_audio=cal).infer_batch(audio)
    got = _port_engine(res8_variables_to_state_dict(variables), cfg_kw, tdt, use_int8_trunk=True,
                       int8_calibration_audio=cal).infer_batch(audio)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=0, atol=2e-2)
    for key in DECISIONS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_int8_engine_decides_as_the_float32_engine(int8_setup):
    """The gate of tests/test_int8_trunk.py on the port: the int8 engine (bf16
    compute) against the exact float32 engine on a batch whose loud half
    fires."""
    variables, audio, cal, cfg_kw = int8_setup
    state = res8_variables_to_state_dict(variables)
    exact = _port_engine(state, cfg_kw, frontend_precision="f32").infer_batch(audio)
    got = _port_engine(state, cfg_kw, torch.bfloat16, use_int8_trunk=True, int8_calibration_audio=cal).infer_batch(audio)
    for key in ("detected", "first_fire_step"):
        assert torch.equal(got[key], exact[key]), key
    assert float((got["labels"] == exact["labels"]).double().mean()) >= 0.99


# ---- the two int8 tools ----


@pytest.mark.parametrize("tool", [bench_trunk_int8, bench_stream_step_int8], ids=["trunk", "stream_step"])
def test_int8_tools_run_on_the_cpu(tool, capsys):
    results = tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    if tool is bench_trunk_int8:
        assert list(results) == list(tool.LEGS)
        times = list(results.values())
    else:
        assert list(results) == list(tool.CPU_GEOMETRIES)
        assert all(list(legs) == list(tool.LEGS) for legs in results.values())
        times = [ms for legs in results.values() for ms in legs.values()]
    assert all(np.isfinite(ms) and ms > 0 for ms in times)
    assert out.count("ms/iter") == len(times)


@pytest.mark.parametrize("tool", [bench_trunk_int8, bench_stream_step_int8], ids=["trunk", "stream_step"])
def test_int8_tools_refuse_to_run_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])

