"""The port's res8 stem (howl_tpu_torch/ops/stem_cuda.py) vs howl_tpu.

The plain PyTorch version of the CUDA stem kernel, which the wrapper takes
for a CPU tensor, against the JAX Pallas stem in interpret mode and against
the flax trunk's pooled stem (``trunk_intermediates["s0"]``). Inputs come
from seeded numpy generators.

Tolerances: float32 1e-5, test_stem_pallas.py's bound. In bf16 both kernels
round inputs and taps to bf16, sum in float32 and round the output once, so
they differ by at most one bf16 ulp of the output's magnitude, where the
summation order flips a rounding. The flax bf16 stem rounds its conv output
and pools in bf16 as well, so it gets one more ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.stem_pallas import fold_stem_weights as jax_fold_stem_weights
from howl_tpu.ops.stem_pallas import res8_stem_pallas
from howl_tpu_torch.ops.stem_cuda import fold_stem_weights, res8_stem_cuda, res8_stem_plain, stem_geometry

torch.set_num_threads(1)


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(x).max()), 1e-30))) - 7)


@pytest.fixture(scope="module")
def flax_res8():
    model = jax_create_model("res8", num_labels=4)
    variables = model.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 1, 40, 41)), train=False)
    kernel = np.asarray(variables["params"]["conv0"]["kernel"], np.float32)
    return model, variables, kernel


def _feats(seed, t_frames, batch=2):
    return (np.random.default_rng(seed).standard_normal((batch, 1, 40, t_frames)) * 0.7).astype(np.float32)


@pytest.mark.parametrize("t_frames", [41, 100, 161])
def test_plain_stem_matches_pallas_and_flax_f32(flax_res8, t_frames):
    model, variables, kernel = flax_res8
    feats = _feats(t_frames, t_frames)
    mel_tm = np.ascontiguousarray(feats[:, 0].swapaxes(-1, -2))  # (B, T, F)
    s0_flax = np.asarray(model.apply(variables, jnp.asarray(feats), method="trunk_intermediates")["s0"])
    s0_pallas = np.asarray(
        res8_stem_pallas(jnp.asarray(mel_tm), jnp.asarray(jax_fold_stem_weights(kernel)), interpret=True)
    )
    ours = res8_stem_cuda(torch.from_numpy(mel_tm), fold_stem_weights(kernel)).numpy()
    assert ours.shape == s0_flax.shape == s0_pallas.shape == (2, t_frames // 3, 10, 45)
    np.testing.assert_allclose(ours, s0_pallas, atol=1e-5)
    np.testing.assert_allclose(ours, s0_flax, atol=1e-5)


@pytest.mark.parametrize("t_frames", [41, 100, 161])
def test_plain_stem_matches_pallas_and_flax_bf16(flax_res8, t_frames):
    _, variables, kernel = flax_res8
    model16 = jax_create_model("res8", num_labels=4, dtype=jnp.bfloat16)
    vars16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), variables)
    feats = _feats(t_frames + 1, t_frames)
    mel_tm = np.ascontiguousarray(feats[:, 0].swapaxes(-1, -2))
    s0_pallas = np.asarray(
        res8_stem_pallas(
            jnp.asarray(mel_tm), jnp.asarray(jax_fold_stem_weights(kernel), jnp.bfloat16), interpret=True
        ).astype(jnp.float32)
    )
    s0_flax = np.asarray(
        model16.apply(vars16, jnp.asarray(feats), method="trunk_intermediates")["s0"].astype(jnp.float32)
    )
    taps = fold_stem_weights(kernel).to(torch.bfloat16).float()
    ours = res8_stem_cuda(torch.from_numpy(mel_tm).to(torch.bfloat16), taps)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    ulp = _bf16_ulp(s0_pallas)
    np.testing.assert_allclose(ours, s0_pallas, atol=ulp)
    np.testing.assert_allclose(ours, s0_flax, atol=2 * ulp)


def test_taps_carry_the_banded_fold_geometry(flax_res8):
    """Every nonzero entry of the JAX banded fold W0fold is the port's tap for
    the same (time tap, freq tap, channel), and the fold has no others."""
    kernel = flax_res8[2]
    taps = fold_stem_weights(kernel, n_mels=40, pool_f=4).numpy()
    fold = jax_fold_stem_weights(kernel, n_mels=40, pool_f=4)
    ch, n_mels, pool_f = 45, 40, 4
    f_out = stem_geometry(n_mels, pool_f)
    jblock = fold.shape[1] // pool_f
    rebuilt = np.zeros_like(fold)
    for dt in range(3):
        for j in range(pool_f):
            for fo in range(f_out):
                for df in range(3):
                    f = pool_f * fo + j + df - 1
                    if 0 <= f < n_mels:
                        col = j * jblock + fo * ch
                        rebuilt[dt * n_mels + f, col : col + ch] = taps[dt, df]
    np.testing.assert_array_equal(rebuilt, fold)
    assert f_out == n_mels // pool_f


def test_fold_rejects_bad_geometry():
    k = np.zeros((3, 3, 1, 45), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        fold_stem_weights(k, n_mels=41, pool_f=4)
    with pytest.raises(ValueError, match="stem kernel"):
        fold_stem_weights(np.zeros((3, 3, 2, 45), np.float32))
    with pytest.raises(ValueError, match="divisible"):
        jax_fold_stem_weights(k, n_mels=41, pool_f=4)


def test_stem_wrapper_checks_inputs():
    taps = torch.zeros((3, 3, 45))
    with pytest.raises(ValueError, match="B, T, n_mels"):
        res8_stem_plain(torch.zeros((2, 40)), taps)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        res8_stem_plain(torch.zeros((1, 9, 40), dtype=torch.float64), taps)
    with pytest.raises(ValueError, match="taps"):
        res8_stem_plain(torch.zeros((1, 9, 40)), taps.double())
    with pytest.raises(ValueError, match="divisible"):
        res8_stem_plain(torch.zeros((1, 9, 42)), taps)
    with pytest.raises(ValueError, match="pool window"):
        res8_stem_plain(torch.zeros((1, 2, 40)), taps)
    assert res8_stem_plain(torch.zeros((1, 3, 40)), taps).shape == (1, 1, 10, 45)
