"""On-device waveform and feature augmentation (counterpart of
``howl_tpu/ops/augment.py``): noise-bank mixing, timeshift, white and
salt-and-pepper noise, SpecAugment, and the chain ``augment_audio``.

Randomness enters through an explicit ``torch.Generator``. Each op is split
into a draw function, which makes every random choice the op needs (rows,
window starts, mix weights, masks, shifts, span starts) on the generator's
device, and an apply function that takes those draws. ``jax.random`` and
torch draw different numbers from the same seed, so the tests replay the
draws the JAX package makes from its key into the apply functions and hold
the results equal. The laws, the order of operations and the per-example
masks are the JAX package's:

* mixing: a random bank row and window start per example; starts are
  quantized to ``NOISE_OFFSET_QUANTUM`` samples when the bank offers at
  least ``MIN_QUANTIZED_STARTS`` such starts (ceil-divided count), else
  sample-exact; alpha ~ U[0, mixer_strength), forced to 1 for replaced clips
  and to 0 where the op is not applied; the ``replaced & apply`` mask comes
  back so the caller relabels those clips;
* timeshift: a zero-filled shift of up to ``timeshift_max_s``, quantized to
  the chunk grid of ``_shift_chunk`` (c = 125 at 8,000 samples) where that
  grid offers enough distinct shifts, sample-exact otherwise; here it is a
  gather at the quantized starts, which the JAX package's one-hot matmul
  equals bit for bit, and rows it does not shift pass through verbatim;
* salt-and-pepper: both impulse sets from one uniform draw;
* SpecAugment: a span that does not fit is skipped, not clamped.

The gather and mix of the noise bank is the hand-written kernel of
``ops/augment_cuda.py``. ``PreparedNoiseBank`` holds the wrap-extended bank
alone: the JAX package's tile-aligned flat view (``flatten_bank``,
``w_ext``) and its ``use_pallas`` switch exist only for Mosaic's (8, 128)
DMA alignment, which the Hopper kernel does not need.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda

# window-start granularity of quantized noise draws, in samples (the JAX
# package's Mosaic DMA quantum, kept so both packages draw the same windows)
NOISE_OFFSET_QUANTUM = 1024
# banks offering fewer quantized starts than this keep sample-exact starts
MIN_QUANTIZED_STARTS = 8
# the chunk-grid shift must offer at least this many magnitudes per direction
_MIN_SHIFT_STEPS = 8


@dataclass(frozen=True)
class AugmentConfig:
    """Reference-default magnitudes (transform.py parameter domains)."""

    prob: float = 0.75
    timeshift_max_s: float = 0.25
    white_strength: float = 0.001
    salt_pepper_prob: float = 1.0 / 10000
    mixer_strength: float = 0.2
    sa_freq: int = 10
    sa_time: int = 75
    sample_rate: int = 16000


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return _uniform(gen, shape) < p


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=gen.device)


# ---- timeshift ----


def _shift_chunk(n: int, pad: int = None) -> int:
    """Largest divisor of n in [64, 128] whose grid still offers at least
    _MIN_SHIFT_STEPS shift magnitudes within ``pad`` (default n // 2); 0 if
    none does, and the shift stays sample-exact."""
    if pad is None:
        pad = n // 2
    for c in range(128, 63, -1):
        if n % c == 0 and pad // c >= _MIN_SHIFT_STEPS:
            return c
    return 0


class ShiftDraws(NamedTuple):
    shift: torch.Tensor  # (B,) int64 samples, negative = left
    apply: torch.Tensor  # (B,) bool


def draw_timeshift(gen: torch.Generator, b: int, n: int, cfg: AugmentConfig) -> ShiftDraws:
    max_shift = (_uniform(gen, (b,)) * cfg.timeshift_max_s * cfg.sample_rate).long().clamp(max=n // 2)
    left = _bernoulli(gen, 0.5, (b,))
    return ShiftDraws(torch.where(left, -max_shift, max_shift), _bernoulli(gen, cfg.prob, (b,)))


def apply_timeshift(audio: torch.Tensor, d: ShiftDraws, cfg: AugmentConfig) -> torch.Tensor:
    """Shift each applied row by its draw, zero-filled; the others verbatim."""
    b, n = audio.shape
    rows = torch.arange(b, device=audio.device)
    pad = min(int(cfg.timeshift_max_s * cfg.sample_rate), n // 2)
    c = _shift_chunk(n, pad)
    if c == 0:
        starts = torch.where(d.apply, (pad - d.shift).clamp(0, 2 * pad), pad)
        return torch.nn.functional.pad(audio, (pad, pad)).unfold(1, n, 1)[rows, starts]
    pad_c = -(-pad // c) * c  # zero padding rounded up to whole chunks
    kq = pad_c // c
    q_shift = torch.round(d.shift / c).long().clamp(-kq, kq)
    q = torch.where(d.apply, kq - q_shift, kq)  # start chunk of each row
    out = torch.nn.functional.pad(audio, (pad_c, pad_c)).unfold(1, n, c)[rows, q]
    return torch.where(d.apply[:, None], out, audio)


def timeshift(audio: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    """Random shift left or right by up to ``timeshift_max_s``, zero-filled."""
    return apply_timeshift(audio, draw_timeshift(gen, *audio.shape, cfg), cfg)


# ---- white and salt-and-pepper noise ----


class WhiteDraws(NamedTuple):
    strength: torch.Tensor  # (B, 1)
    normal: torch.Tensor  # (B, n) standard normal
    apply: torch.Tensor  # (B,) bool


def draw_white_noise(gen: torch.Generator, b: int, n: int, cfg: AugmentConfig) -> WhiteDraws:
    strength = _uniform(gen, (b, 1)) * cfg.white_strength
    normal = torch.randn((b, n), generator=gen, device=gen.device)
    return WhiteDraws(strength, normal, _bernoulli(gen, cfg.prob, (b,)))


def apply_white_noise(audio: torch.Tensor, d: WhiteDraws) -> torch.Tensor:
    noise = d.normal * d.strength
    return torch.where(d.apply[:, None], torch.clamp(audio + noise, -1.0, 1.0), audio)


def white_noise(audio: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    """Additive gaussian noise with a random strength per example."""
    return apply_white_noise(audio, draw_white_noise(gen, *audio.shape, cfg))


class SaltPepperDraws(NamedTuple):
    prob: torch.Tensor  # (B, 1) impulse probability
    u: torch.Tensor  # (B, n) uniform
    apply: torch.Tensor  # (B,) bool


def draw_salt_pepper_noise(gen: torch.Generator, b: int, n: int, cfg: AugmentConfig) -> SaltPepperDraws:
    prob = _uniform(gen, (b, 1)) * cfg.salt_pepper_prob
    return SaltPepperDraws(prob, _uniform(gen, (b, n)), _bernoulli(gen, cfg.prob, (b,)))


def apply_salt_pepper_noise(audio: torch.Tensor, d: SaltPepperDraws) -> torch.Tensor:
    # one uniform draw gives both disjoint impulse sets, each bernoulli(p / 2)
    noise = (d.u < d.prob / 2.0).to(audio.dtype) - (d.u > 1.0 - d.prob / 2.0).to(audio.dtype)
    return torch.where(d.apply[:, None], torch.clamp(audio + noise, -1.0, 1.0), audio)


def salt_pepper_noise(audio: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    """Random +-1 impulses."""
    return apply_salt_pepper_noise(audio, draw_salt_pepper_noise(gen, *audio.shape, cfg))


# ---- noise-bank mixing ----


@dataclass(frozen=True)
class PreparedNoiseBank:
    """A (N, W) noise bank prepared for windows of ``window`` samples:
    ``extended`` is the bank wrap-extended to (N, W + window), so every
    circular window is one contiguous slice."""

    extended: torch.Tensor
    bank_w: int
    window: int


def prepare_noise_bank(noise_bank, window_samples: int, device=None) -> PreparedNoiseBank:
    """Derive the wrap-extended bank once per bank and window size."""
    bank = torch.as_tensor(noise_bank, dtype=torch.float32, device=device)
    n = window_samples
    bank_w = bank.shape[1]
    if n > bank_w:  # tiny banks: repeat until a slice fits
        reps = -(-n // bank_w)
        extended = torch.cat([bank] * (reps + 1), dim=1)[:, : bank_w + n]
    else:
        extended = torch.cat([bank, bank[:, :n]], dim=1)
    return PreparedNoiseBank(extended.contiguous(), bank_w, n)


def bank_quantized(bank_w: int) -> bool:
    """Whether a bank of this width draws quantized window starts: the ceil
    count of quantum-aligned starts is at least MIN_QUANTIZED_STARTS."""
    return -(-bank_w // NOISE_OFFSET_QUANTUM) >= MIN_QUANTIZED_STARTS


class MixDraws(NamedTuple):
    rows: torch.Tensor  # (B,) int64 bank rows
    offs: torch.Tensor  # (B,) int64 window starts
    alpha: torch.Tensor  # (B,) float32 final mix weights
    replaced: torch.Tensor  # (B,) bool, replaced & applied


def draw_mix_noise_bank(
    gen: torch.Generator, b: int, bank: PreparedNoiseBank, cfg: AugmentConfig, replace_prob: float = 0.0
) -> MixDraws:
    rows = _randint(gen, bank.extended.shape[0], (b,))
    if bank_quantized(bank.bank_w):
        offs = _randint(gen, -(-bank.bank_w // NOISE_OFFSET_QUANTUM), (b,)) * NOISE_OFFSET_QUANTUM
    else:
        offs = _randint(gen, bank.bank_w, (b,))
    alpha = _uniform(gen, (b,)) * cfg.mixer_strength
    replaced = _bernoulli(gen, replace_prob, (b,))
    alpha = torch.where(replaced, 1.0, alpha)
    apply = _bernoulli(gen, cfg.prob, (b,))
    alpha = torch.where(apply, alpha, 0.0)
    return MixDraws(rows, offs, alpha, replaced & apply)


def apply_mix_noise_bank(audio: torch.Tensor, bank: PreparedNoiseBank, d: MixDraws) -> torch.Tensor:
    if bank.window != audio.shape[-1]:
        raise ValueError(f"noise bank was prepared for {bank.window}-sample windows, got {audio.shape[-1]}")
    return mix_noise_bank_cuda(audio.contiguous(), bank.extended, d.rows, d.offs, d.alpha)


def mix_noise_bank(
    audio: torch.Tensor, gen: torch.Generator, noise_bank, cfg: AugmentConfig, replace_prob: float = 0.0
):
    """Background-noise mixing from a device-resident bank: a raw (N, W) bank
    or, preferred in loops, a ``PreparedNoiseBank``. Returns (mixed audio,
    replaced mask); replaced clips are pure noise and must be relabelled."""
    if not isinstance(noise_bank, PreparedNoiseBank):
        noise_bank = prepare_noise_bank(noise_bank, audio.shape[-1], audio.device)
    d = draw_mix_noise_bank(gen, audio.shape[0], noise_bank, cfg, replace_prob)
    return apply_mix_noise_bank(audio, noise_bank, d), d.replaced


# ---- SpecAugment ----


class SpecDraws(NamedTuple):
    t_start: torch.Tensor  # (B,) int64
    t_len: torch.Tensor  # (B,) int64, 0 where the drawn span did not fit
    apply_t: torch.Tensor  # (B,) bool
    f_start: torch.Tensor
    f_len: torch.Tensor
    apply_f: torch.Tensor


def _draw_span(gen: torch.Generator, b: int, size: int, max_len: int):
    length = _randint(gen, max(max_len, 1), (b,))
    length = torch.where(length >= size, 0, length)  # too long: skipped, as the reference does
    start = (_uniform(gen, (b,)) * (size - length)).long()
    return start, length


def draw_spec_augment(gen: torch.Generator, b: int, n_freq: int, n_time: int, cfg: AugmentConfig) -> SpecDraws:
    t_start, t_len = _draw_span(gen, b, n_time, cfg.sa_time)
    f_start, f_len = _draw_span(gen, b, n_freq, cfg.sa_freq)
    apply_t = _bernoulli(gen, cfg.prob, (b,))
    apply_f = _bernoulli(gen, cfg.prob, (b,))
    return SpecDraws(t_start, t_len, apply_t, f_start, f_len, apply_f)


def _span_mask(size: int, start, length, apply) -> torch.Tensor:
    idx = torch.arange(size, device=start.device)[None, :]
    return (idx >= start[:, None]) & (idx < (start + length)[:, None]) & apply[:, None]


def apply_spec_augment(feats: torch.Tensor, d: SpecDraws) -> torch.Tensor:
    """Time then frequency masking of (B, C, F, T) features."""
    _, _, f, t = feats.shape
    feats = feats * (~_span_mask(t, d.t_start, d.t_len, d.apply_t)).to(feats.dtype)[:, None, None, :]
    return feats * (~_span_mask(f, d.f_start, d.f_len, d.apply_f)).to(feats.dtype)[:, None, :, None]


def spec_augment(feats: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    """Time + frequency masking on (B, C, F, T) features."""
    b, _, f, t = feats.shape
    return apply_spec_augment(feats, draw_spec_augment(gen, b, f, t, cfg))


# ---- the waveform chain ----


class AugmentDraws(NamedTuple):
    mix: Optional[MixDraws]
    shift: ShiftDraws
    white: WhiteDraws
    salt_pepper: SaltPepperDraws


def draw_augment_audio(
    gen: torch.Generator,
    b: int,
    n: int,
    cfg: AugmentConfig,
    noise_bank: Optional[PreparedNoiseBank] = None,
    replace_prob: float = 0.0,
) -> AugmentDraws:
    mix = None if noise_bank is None else draw_mix_noise_bank(gen, b, noise_bank, cfg, replace_prob)
    return AugmentDraws(
        mix, draw_timeshift(gen, b, n, cfg), draw_white_noise(gen, b, n, cfg), draw_salt_pepper_noise(gen, b, n, cfg)
    )


def apply_augment_audio(
    audio: torch.Tensor, d: AugmentDraws, cfg: AugmentConfig, noise_bank: Optional[PreparedNoiseBank] = None
):
    """mixer? -> timeshift -> white noise -> salt-and-pepper, the reference's
    collate order. Returns (audio, replaced mask)."""
    replaced = torch.zeros((audio.shape[0],), dtype=torch.bool, device=audio.device)
    if noise_bank is not None:
        audio = apply_mix_noise_bank(audio, noise_bank, d.mix)
        replaced = d.mix.replaced
    audio = apply_timeshift(audio, d.shift, cfg)
    audio = apply_white_noise(audio, d.white)
    return apply_salt_pepper_noise(audio, d.salt_pepper), replaced


def augment_audio(
    audio: torch.Tensor,
    gen: torch.Generator,
    cfg: AugmentConfig,
    noise_bank=None,
    replace_prob: float = 0.0,
):
    """The full waveform augmentation chain. Returns (audio, replaced mask);
    replaced examples must flip to the negative label."""
    if noise_bank is not None and not isinstance(noise_bank, PreparedNoiseBank):
        noise_bank = prepare_noise_bank(noise_bank, audio.shape[-1], audio.device)
    d = draw_augment_audio(gen, *audio.shape, cfg, noise_bank, replace_prob)
    return apply_augment_audio(audio, d, cfg, noise_bank)
