"""Train and eval steps: augmentation, frontend, model, loss and AdamW in one
call per batch (counterpart of ``howl_tpu/training/step.py``).

The host hands over raw PCM windows on the device; everything else runs
there: noise-bank mixing (the hand-written kernel of
``ops/augment_cuda.py``), timeshift and waveform noise, the VTLP log-mel
frontend and ZMUV, SpecAugment, res8 forward and backward, AdamW and the
BatchNorm running stats. PyTorch runs eagerly, so there is no program to
compile; the state is updated in place.

A step's randomness comes from a ``torch.Generator`` on the audio's device
seeded from (key, step), as the JAX step folds ``state.step`` into its key,
so a step is reproducible from its inputs. Its draws (``StepDraws``) can
also be passed in, which is how the tests replay the JAX package's draws.
The frontend's matrix products run in float32, the counterpart of both
precisions the JAX step takes (HIGHEST, and HIGH with bf16 models); on a
CUDA device that needs TF32 off, PyTorch's default for matrix products.
``StepConfig`` has no ``dft_precision`` for that reason, and no
``blank_label`` until CTC is ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from howl_tpu_torch.ops import augment as aug
from howl_tpu_torch.ops.frontend import (
    FrontendConfig,
    log_mel_spectrogram,
    log_mel_spectrogram_vtlp,
    stack_deltas,
)
from howl_tpu_torch.training.objectives import frame_ce_loss
from howl_tpu_torch.training.state import TrainState


class StepConfig(NamedTuple):
    frontend: FrontendConfig
    zmuv_mean: float
    zmuv_std: float
    augment: Optional[aug.AugmentConfig] = None
    use_vtlp: bool = True
    vtlp_prob: float = 0.75
    replace_prob: float = 0.0
    negative_label: int = 0
    # trunk-mode training: logits from trunk frames [lo, hi) via
    # Res8.windowed_logits, matching the engine's fused clip-level scoring
    trunk_span: Optional[Tuple[int, int]] = None
    # the delta/accel stack; res8 reads channel 0 only, which is the same
    # either way, so the train bench turns it off
    use_deltas: bool = True


class StepDraws(NamedTuple):
    augment: Optional[aug.AugmentDraws]
    vtlp_alpha: Optional[torch.Tensor]  # 0-d warp; 1.0 where VTLP was not applied
    spec: Optional[aug.SpecDraws]


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The generator of one step: seeded from (key, step) alone."""
    seed = int(np.random.SeedSequence([int(key), int(step)]).generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def draw_vtlp_alpha(gen: torch.Generator, cfg: StepConfig) -> torch.Tensor:
    """One warp per batch, alpha ~ U[0.9, 1.1), applied with ``vtlp_prob``."""
    alpha = 0.9 + 0.2 * torch.rand((), generator=gen, device=gen.device)
    applied = torch.rand((), generator=gen, device=gen.device) < cfg.vtlp_prob
    return torch.where(applied, alpha, 1.0)


def draw_step(
    gen: torch.Generator, cfg: StepConfig, b: int, n: int, noise_bank: Optional[aug.PreparedNoiseBank] = None
) -> StepDraws:
    """Every random choice of one classification train step."""
    augment = spec = None
    if cfg.augment is not None:
        augment = aug.draw_augment_audio(gen, b, n, cfg.augment, noise_bank, cfg.replace_prob)
    alpha = draw_vtlp_alpha(gen, cfg) if cfg.use_vtlp else None
    if cfg.augment is not None:
        spec = aug.draw_spec_augment(gen, b, cfg.frontend.n_mels, cfg.frontend.num_frames(n), cfg.augment)
    return StepDraws(augment, alpha, spec)


def featurize(audio: torch.Tensor, cfg: StepConfig, vtlp_alpha=None) -> torch.Tensor:
    """(B, samples) -> ZMUV-normalized (B, 3, F, T) features, or (B, 1, F, T)
    without deltas; with ``vtlp_alpha`` the filterbank is VTLP-warped."""
    if vtlp_alpha is not None:
        feats = log_mel_spectrogram_vtlp(audio, vtlp_alpha, cfg.frontend)
    else:
        feats = log_mel_spectrogram(audio, cfg.frontend)
    feats = stack_deltas(feats) if cfg.use_deltas else feats[:, None]
    return (feats - cfg.zmuv_mean) / cfg.zmuv_std


def _logits(model, feats: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    if cfg.trunk_span is not None:
        return model.windowed_logits(feats, *cfg.trunk_span)
    return model(feats)


class NoiseBankTrainStep:
    """Train-step callable holding a refreshable device noise bank.

    ``set_bank`` swaps in a new bank (the epoch refresh that lets long runs
    sample the whole noise corpus). The wrap-extended view is derived once
    per (bank, window size) and cached. Call signature matches the bankless
    step: (state, audio, labels, lengths, key, draws=None)."""

    def __init__(self, step: Callable, noise_bank):
        self._step = step
        self._prepared: dict = {}
        self._bank = None
        self.set_bank(noise_bank)

    def set_bank(self, noise_bank):
        self._prepared.clear()
        if isinstance(noise_bank, aug.PreparedNoiseBank):
            self._prepared[noise_bank.window] = noise_bank
            self._bank = None
        else:
            self._bank = noise_bank

    def prepared_for(self, window: int, device=None) -> aug.PreparedNoiseBank:
        prep = self._prepared.get(window)
        if prep is None:
            if self._bank is None:
                raise ValueError(
                    f"noise bank was prepared for windows {sorted(self._prepared)}; "
                    f"cannot serve {window}-sample windows (set_bank with a raw array to re-derive)"
                )
            prep = self._prepared[window] = aug.prepare_noise_bank(self._bank, window, device)
        return prep

    def __call__(self, state, audio, *rest, **kw):
        return self._step(state, audio, *rest, noise_bank=self.prepared_for(audio.shape[-1], audio.device), **kw)


def make_classification_train_step(model, cfg: StepConfig, noise_bank=None) -> Callable:
    """Returns (state, audio, labels, lengths, key, draws=None) -> (state,
    {"loss", "accuracy"}); ``state`` is updated in place and returned.

    With a noise bank the callable is a ``NoiseBankTrainStep`` whose bank
    ``set_bank`` replaces. ``lengths`` is taken for the signature's sake:
    res8 scores whole windows."""

    def train_step(state: TrainState, audio, labels, lengths, key, draws: Optional[StepDraws] = None, noise_bank=None):
        b, n = audio.shape
        if draws is None:
            draws = draw_step(step_generator(key, state.step, audio.device), cfg, b, n, noise_bank)
        with torch.no_grad():
            if cfg.augment is not None:
                audio, replaced = aug.apply_augment_audio(audio, draws.augment, cfg.augment, noise_bank)
                labels = torch.where(replaced, cfg.negative_label, labels)
            feats = featurize(audio, cfg, draws.vtlp_alpha if cfg.use_vtlp else None)
            if cfg.augment is not None:
                feats = aug.apply_spec_augment(feats, draws.spec)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = _logits(state.model, feats, cfg)
        loss = frame_ce_loss(logits, labels)
        loss.backward()
        state.apply_gradients()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    if noise_bank is None:
        return train_step
    return NoiseBankTrainStep(train_step, noise_bank)


def make_classification_eval_step(model, cfg: StepConfig) -> Callable:
    """Returns (state, audio, lengths) -> (B, L) logits, with the running
    BatchNorm stats and no augmentation."""

    @torch.no_grad()
    def eval_step(state: TrainState, audio, lengths=None):
        state.model.eval()
        return state.model(featurize(audio, cfg))

    return eval_step


def make_ctc_train_step(model, cfg: StepConfig, noise_bank=None) -> Callable:
    raise NotImplementedError(
        "make_ctc_train_step (CTC over the sequential models) is not ported to PyTorch yet "
        "(ROADMAP Queue 1, item 8: remaining model zoo)"
    )
