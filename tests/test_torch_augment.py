"""The port's augmentation (howl_tpu_torch/ops/augment*.py) vs howl_tpu's.

jax.random and torch draw different numbers, so every parity test replays
the draws the JAX op makes from its key (the same splits, the same laws)
into the port's apply function and compares the outputs. The noise-bank
mix, whose CUDA kernel runs only on the card, is compared through its plain
version, which its wrapper takes for a CPU tensor.

Tolerances: bitwise (uint32 views) against the JAX ops and the mix's
fallback route; 5e-7 against the Pallas kernel in interpret mode, whose
mixed rows may differ by an ulp from the fallback on the CPU
(tests/test_augment_ops.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import augment as jaug
from howl_tpu.ops.augment_pallas import NOISE_OFFSET_QUANTUM as JAX_QUANTUM
from howl_tpu_torch.ops import augment as taug
from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda, mix_noise_bank_plain

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def _cfgs(**kw):
    return dataclasses.replace(jaug.AugmentConfig(), **kw), dataclasses.replace(taug.AugmentConfig(), **kw)


# ---- the JAX ops' draws from their keys, restated with jax.random ----


def jax_mix_draws(key, b, n_rows, bank_w, cfg, replace_prob) -> taug.MixDraws:
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    rows = jax.random.randint(k1, (b,), 0, n_rows)
    if jaug._bank_quantized(bank_w):
        offs = jax.random.randint(k2, (b,), 0, -(-bank_w // JAX_QUANTUM)) * JAX_QUANTUM
    else:
        offs = jax.random.randint(k2, (b,), 0, bank_w)
    alpha = jax.random.uniform(k3, (b, 1)) * cfg.mixer_strength
    replaced = jax.random.bernoulli(k4, replace_prob, (b,))
    alpha = jnp.where(replaced[:, None], 1.0, alpha)
    apply = jax.random.bernoulli(k5, cfg.prob, (b,))
    alpha = jnp.where(apply[:, None], alpha, 0.0)
    return taug.MixDraws(_t(rows).long(), _t(offs).long(), _t(alpha[:, 0]), _t(replaced & apply))


def jax_shift_draws(key, b, n, cfg) -> taug.ShiftDraws:
    k1, k2, k3, _ = jax.random.split(key, 4)
    max_shift = jnp.minimum(
        (jax.random.uniform(k1, (b,)) * cfg.timeshift_max_s * cfg.sample_rate).astype(jnp.int32), n // 2
    )
    shift = jnp.where(jax.random.bernoulli(k2, 0.5, (b,)), -max_shift, max_shift)
    return taug.ShiftDraws(_t(shift).long(), _t(jax.random.bernoulli(k3, cfg.prob, (b,))))


def jax_white_draws(key, b, n, cfg) -> taug.WhiteDraws:
    k1, k2, k3 = jax.random.split(key, 3)
    strength = jax.random.uniform(k1, (b, 1)) * cfg.white_strength
    return taug.WhiteDraws(
        _t(strength), _t(jax.random.normal(k2, (b, n))), _t(jax.random.bernoulli(k3, cfg.prob, (b,)))
    )


def jax_salt_pepper_draws(key, b, n, cfg) -> taug.SaltPepperDraws:
    k1, k2, _, k4 = jax.random.split(key, 4)
    prob = jax.random.uniform(k1, (b, 1)) * cfg.salt_pepper_prob
    return taug.SaltPepperDraws(
        _t(prob), _t(jax.random.uniform(k2, (b, n))), _t(jax.random.bernoulli(k4, cfg.prob, (b,)))
    )


def jax_spec_draws(key, b, f, t, cfg) -> taug.SpecDraws:
    kt1, kt2, kf1, kf2, kp1, kp2 = jax.random.split(key, 6)

    def span(k_len, k_start, size, max_len):
        length = jax.random.randint(k_len, (b,), 0, max(max_len, 1))
        length = jnp.where(length >= size, 0, length)
        start = (jax.random.uniform(k_start, (b,)) * (size - length)).astype(jnp.int32)
        return _t(start).long(), _t(length).long()

    t_start, t_len = span(kt1, kt2, t, cfg.sa_time)
    f_start, f_len = span(kf1, kf2, f, cfg.sa_freq)
    apply_t = _t(jax.random.bernoulli(kp1, cfg.prob, (b,)))
    apply_f = _t(jax.random.bernoulli(kp2, cfg.prob, (b,)))
    return taug.SpecDraws(t_start, t_len, apply_t, f_start, f_len, apply_f)


def jax_augment_draws(key, b, n, cfg, bank_shape=None, replace_prob=0.0) -> taug.AugmentDraws:
    k_mix, k_shift, k_white, k_sp, _ = jax.random.split(key, 5)
    mix = None if bank_shape is None else jax_mix_draws(k_mix, b, *bank_shape, cfg, replace_prob)
    return taug.AugmentDraws(
        mix, jax_shift_draws(k_shift, b, n, cfg), jax_white_draws(k_white, b, n, cfg),
        jax_salt_pepper_draws(k_sp, b, n, cfg),
    )


# ---- noise-bank mixing: the kernel's plain version ----


@pytest.mark.parametrize(
    "bank_shape,n",
    [((4, 8192), 2000), ((3, 8 * 1024 + 476), 1000), ((2, 1524), 600), ((3, 16), 40)],
    ids=["quantized", "quantized-ragged-width", "sample-exact", "bank-shorter-than-window"],
)
def test_mix_plain_equals_jax_fallback_bitwise(bank_shape, n):
    jcfg, tcfg = _cfgs(prob=0.6)
    rng = np.random.default_rng(n)
    bank = rng.standard_normal(bank_shape).astype(np.float32)
    audio = rng.standard_normal((9, n)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want, want_rep = jaug.mix_noise_bank(jnp.asarray(audio), key, jnp.asarray(bank), jcfg, 0.3, use_pallas=False)
    prep = taug.prepare_noise_bank(bank, n)
    np.testing.assert_array_equal(
        _bits(prep.extended), _bits(jaug.prepare_noise_bank(jnp.asarray(bank), n, for_pallas=False).extended)
    )
    draws = jax_mix_draws(key, 9, bank_shape[0], bank_shape[1], jcfg, 0.3)
    got = taug.apply_mix_noise_bank(torch.from_numpy(audio), prep, draws)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(draws.replaced.numpy(), np.asarray(want_rep))
    assert not np.array_equal(got.numpy(), audio)  # something mixed


def test_mix_plain_matches_pallas_interpret():
    jcfg, _ = _cfgs(prob=0.6)
    rng = np.random.default_rng(11)
    bank = rng.standard_normal((4, 8192)).astype(np.float32)  # >= 8 quanta: the kernel's route
    audio = rng.standard_normal((5, 2000)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want, _ = jaug.mix_noise_bank(jnp.asarray(audio), key, jnp.asarray(bank), jcfg, 0.3, use_pallas=True)
    draws = jax_mix_draws(key, 5, 4, 8192, jcfg, 0.3)
    got = taug.apply_mix_noise_bank(torch.from_numpy(audio), taug.prepare_noise_bank(bank, 2000), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-7, rtol=0)


def test_mix_zero_and_one_alpha_rows_are_exact():
    """alpha = 0 rows are the audio bit for bit (-0.0 included); alpha = 1
    rows are the noise window bit for bit."""
    rng = np.random.default_rng(3)
    ext = torch.from_numpy(rng.standard_normal((3, 3000)).astype(np.float32))
    audio = torch.from_numpy(rng.standard_normal((4, 1000)).astype(np.float32))
    audio[0, :7] = -0.0
    rows, offs = torch.tensor([0, 1, 2, 1]), torch.tensor([5, 2000, 17, 0])
    alpha = torch.tensor([0.0, 1.0, 0.13, 0.0])
    got = mix_noise_bank_plain(audio, ext, rows, offs, alpha)
    np.testing.assert_array_equal(_bits(got[[0, 3]]), _bits(audio[[0, 3]]))
    np.testing.assert_array_equal(_bits(got[1]), _bits(ext[1, 2000:3000]))
    want = audio[2] * (1 - alpha[2]) + ext[2, 17:1017] * alpha[2]
    np.testing.assert_array_equal(_bits(got[2]), _bits(want))


def test_mix_wrapper_takes_the_plain_version_on_cpu_and_clamps_like_dynamic_slice():
    rng = np.random.default_rng(5)
    ext = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    audio = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    rows, offs, alpha = torch.tensor([5, 0, 1]), torch.tensor([60, 48, 3]), torch.full((3,), 0.5)
    before = mix_noise_bank_cuda.launches
    got = mix_noise_bank_cuda(audio, ext, rows, offs, alpha)
    assert mix_noise_bank_cuda.launches == before  # no kernel launch for a CPU tensor
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice(jnp.asarray(ext.numpy()), (r, s), (1, 16))[0])(
        jnp.asarray(rows.numpy()), jnp.asarray(offs.numpy())
    )
    want = audio.numpy() * 0.5 + np.asarray(want) * 0.5
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # a negative row or start clamps to 0 (the kernel does the same)
    low = mix_noise_bank_cuda(audio, ext, torch.tensor([-3, 0, 0]), torch.tensor([0, -9, 0]), alpha)
    assert torch.equal(low, mix_noise_bank_cuda(audio, ext, torch.zeros(3, dtype=torch.long), torch.zeros(3, dtype=torch.long), alpha))
    with pytest.raises(ValueError, match="int64 rows"):
        mix_noise_bank_cuda(audio, ext, rows.int(), offs, alpha)
    with pytest.raises(ValueError, match="cannot hold"):
        mix_noise_bank_cuda(audio, ext[:, :8], rows, offs, alpha)


def test_mix_draw_laws():
    """Quantized starts on wide banks (the last aligned start below the width
    included), sample-exact starts on narrow ones, alpha forced to 1 for
    replaced and 0 for unapplied clips, and the replaced & apply mask."""
    _, cfg = _cfgs(prob=0.7)
    gen = torch.Generator().manual_seed(0)
    q = taug.NOISE_OFFSET_QUANTUM
    wide = taug.prepare_noise_bank(torch.zeros((5, 8 * q + 476)), 600)
    d = taug.draw_mix_noise_bank(gen, 4096, wide, cfg, replace_prob=0.2)
    assert set(d.offs.unique().tolist()) == set(range(0, 9 * q, q))
    assert d.rows.min() == 0 and d.rows.max() == 4
    applied = d.alpha > 0
    assert torch.equal(d.alpha[d.replaced], torch.ones(int(d.replaced.sum())))
    mixed = applied & ~d.replaced
    assert float(d.alpha[mixed].max()) < cfg.mixer_strength
    assert 0.6 < float(applied.float().mean()) < 0.8
    assert 0.1 < float(d.replaced.float().mean() / applied.float().mean()) < 0.3
    narrow = taug.prepare_noise_bank(torch.zeros((1, 7 * q)), 600)
    d = taug.draw_mix_noise_bank(gen, 4096, narrow, cfg)
    assert (d.offs % q).any() and int(d.offs.max()) < 7 * q
    assert taug.bank_quantized(8000) and not taug.bank_quantized(7 * q)
    assert taug.MIN_QUANTIZED_STARTS == jaug.MIN_QUANTIZED_STARTS and q == JAX_QUANTUM


def test_prepared_bank_refuses_another_window():
    bank = taug.prepare_noise_bank(np.zeros((2, 9000), np.float32), 2000)
    with pytest.raises(ValueError, match="prepared for 2000"):
        taug.mix_noise_bank(torch.zeros((3, 1000)), torch.Generator().manual_seed(0), bank, taug.AugmentConfig())


# ---- timeshift, white and salt-and-pepper noise, SpecAugment ----


@pytest.mark.parametrize(
    "n,sr,prob", [(8000, 16000, 0.6), (7993, 16000, 0.6), (64, 64, 1.0), (8000, 16000, 0.0)],
    ids=["chunk-grid", "sample-exact", "small-window", "prob-zero"],
)
def test_timeshift_equals_jax_bitwise(n, sr, prob):
    jcfg, tcfg = _cfgs(prob=prob, sample_rate=sr)
    rng = np.random.default_rng(n)
    audio = rng.standard_normal((12, n)).astype(np.float32)
    audio[0, 3] = -0.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.timeshift(jnp.asarray(audio), key, jcfg))
    draws = jax_shift_draws(key, 12, n, jcfg)
    got = taug.apply_timeshift(torch.from_numpy(audio), draws, tcfg).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    skipped = ~draws.apply.numpy()
    np.testing.assert_array_equal(_bits(got[skipped]), _bits(audio[skipped]))
    if prob > 0:
        assert not np.array_equal(got, audio)


def test_timeshift_chunk_grid_and_bounds():
    """At 8,000 samples applied rows shift by multiples of c = 125 within the
    half-window bound; draws stay inside +-timeshift_max_s."""
    _, cfg = _cfgs(prob=1.0)
    assert taug._shift_chunk(8000) == jaug._shift_chunk(8000) == 125
    assert [taug._shift_chunk(n, p) for n, p in ((7993, None), (7928, None), (8000, 800), (8000, 300))] == [0, 0, 100, 0]
    gen = torch.Generator().manual_seed(1)
    d = taug.draw_timeshift(gen, 2048, 8000, cfg)
    assert int(d.shift.abs().max()) <= 4000 and (d.shift < 0).any() and (d.shift > 0).any()
    audio = torch.arange(1, 8001, dtype=torch.float32)[None].repeat(4, 1)
    d = taug.ShiftDraws(torch.tensor([130, -250, 4100, 0]), torch.ones(4, dtype=torch.bool))
    got = taug.apply_timeshift(audio, d, cfg)
    for row, s in zip(got, (125, -250, 4000, 0)):  # 4100 clamps to the grid's 0.25 s edge
        want = torch.zeros(8000)
        if s >= 0:
            want[s:] = audio[0, : 8000 - s]
        else:
            want[:s] = audio[0, -s:]
        assert torch.equal(row, want)


def test_white_and_salt_pepper_noise_equal_jax():
    jcfg, tcfg = _cfgs(prob=0.6, salt_pepper_prob=0.01)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((10, 3000)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.white_noise(jnp.asarray(audio), key, jcfg))
    got = taug.apply_white_noise(torch.from_numpy(audio), jax_white_draws(key, 10, 3000, jcfg)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want = np.asarray(jaug.salt_pepper_noise(jnp.asarray(audio), key, jcfg))
    got = taug.apply_salt_pepper_noise(torch.from_numpy(audio), jax_salt_pepper_draws(key, 10, 3000, jcfg)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (np.abs(got) == 1.0).any()  # some impulses landed


@pytest.mark.parametrize("t", [41, 61, 120])
def test_spec_augment_equals_jax_bitwise(t):
    jcfg, _ = _cfgs(prob=0.8)
    rng = np.random.default_rng(t)
    feats = rng.standard_normal((16, 3, 40, t)).astype(np.float32)
    key = jax.random.PRNGKey(t)
    want = np.asarray(jaug.spec_augment(jnp.asarray(feats), key, jcfg))
    got = taug.apply_spec_augment(torch.from_numpy(feats), jax_spec_draws(key, 16, 40, t, jcfg)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got == 0).any()


def test_spec_augment_skips_spans_that_do_not_fit():
    _, cfg = _cfgs(prob=1.0, sa_time=75)
    d = taug.draw_spec_augment(torch.Generator().manual_seed(0), 4096, 40, 61, cfg)
    assert int(d.t_len.max()) < 61 and (d.t_len == 0).float().mean() > 0.15  # 15 of 75 lengths are skipped
    assert bool(((d.t_start + d.t_len) <= 61).all() and ((d.f_start + d.f_len) <= 40).all())


@pytest.mark.parametrize("with_bank", [True, False])
def test_augment_audio_chain_equals_jax(with_bank):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    audio = (rng.standard_normal((8, 8000)) * 0.2).astype(np.float32)
    bank = (rng.standard_normal((3, 9000)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want, want_rep = jaug.augment_audio(
        jnp.asarray(audio), key, jcfg, jnp.asarray(bank) if with_bank else None, replace_prob=0.25
    )
    draws = jax_augment_draws(key, 8, 8000, jcfg, bank.shape if with_bank else None, replace_prob=0.25)
    prep = taug.prepare_noise_bank(bank, 8000) if with_bank else None
    got, rep = taug.apply_augment_audio(torch.from_numpy(audio), draws, tcfg, prep)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(rep.numpy(), np.asarray(want_rep))


def test_ops_with_a_generator_are_reproducible():
    _, cfg = _cfgs()
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8000)).astype(np.float32))
    bank = np.random.default_rng(1).standard_normal((3, 9000)).astype(np.float32)
    outs = [
        taug.augment_audio(audio, torch.Generator().manual_seed(5), cfg, bank, replace_prob=0.5)[0]
        for _ in range(2)
    ]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], audio)
    assert math.isfinite(float(outs[0].abs().max()))


def test_each_op_applies_its_own_draws():
    """An op called with a generator equals its apply function on the draws
    its draw function makes from the same generator state."""
    _, cfg = _cfgs(prob=0.6, salt_pepper_prob=0.01)
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 8000)).astype(np.float32) * 0.3)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 1, 40, 41)).astype(np.float32))

    def gen():
        return torch.Generator().manual_seed(17)

    pairs = [
        (taug.timeshift(audio, gen(), cfg), taug.apply_timeshift(audio, taug.draw_timeshift(gen(), 6, 8000, cfg), cfg)),
        (taug.white_noise(audio, gen(), cfg), taug.apply_white_noise(audio, taug.draw_white_noise(gen(), 6, 8000, cfg))),
        (taug.salt_pepper_noise(audio, gen(), cfg),
         taug.apply_salt_pepper_noise(audio, taug.draw_salt_pepper_noise(gen(), 6, 8000, cfg))),
        (taug.spec_augment(feats, gen(), cfg), taug.apply_spec_augment(feats, taug.draw_spec_augment(gen(), 6, 40, 41, cfg))),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert not torch.equal(pairs[0][0], audio) and not torch.equal(pairs[3][0], feats)
