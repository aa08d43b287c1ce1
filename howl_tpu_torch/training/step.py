"""Train and eval steps: augmentation, frontend, model, loss and AdamW in one
call per batch (counterpart of ``howl_tpu/training/step.py``).

The host hands over raw PCM windows on the device; everything else runs
there: noise-bank mixing (the hand-written kernel of
``ops/augment_cuda.py``), timeshift and waveform noise, the VTLP log-mel
frontend and ZMUV, SpecAugment, the model's forward and backward, AdamW and
the BatchNorm running stats. PyTorch runs eagerly, so there is no program
to compile; the state is updated in place. The frame objective trains any
model of the zoo on windows (cross-entropy; res8 also on context segments,
``trunk_span``), the CTC objective a sequential one on whole utterances
(``make_ctc_train_step``); as in JAX, the model sees the frame lengths
``max(frontend.compute_lengths(sample lengths), 1)``.

A step's randomness comes from a ``torch.Generator`` on the audio's device
seeded from (key, step), as the JAX step folds ``state.step`` into its key,
so a step is reproducible from its inputs; the model's dropout masks come
from the same generator. Its draws (``StepDraws``) can also be passed in,
dropout masks included, which is how the tests replay the JAX package's
draws. The frontend's matrix products run in float32, the counterpart of
both precisions the JAX step takes (HIGHEST, and HIGH with bf16 models); on
a CUDA device that needs TF32 off, PyTorch's default for matrix products.
``StepConfig`` has no ``dft_precision`` for that reason.
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
from howl_tpu_torch.models.base import DropoutDraws, use_data_group, use_dropout_draws
from howl_tpu_torch.training.objectives import ctc_loss, frame_ce_loss
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
    blank_label: int = -1  # the CTC objective's blank
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
    # the keep masks of the model's dropout layers in the order its forward applies them; None draws them from
    # the step's generator
    dropout: Optional[list] = None


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


def frame_lengths(lengths, cfg: StepConfig):
    """Sample lengths -> the frame lengths the model sees, floored at 1 (a
    window shorter than n_fft would give a recurrent model a length below 1);
    None stays None."""
    if lengths is None:
        return None
    return torch.clamp(cfg.frontend.compute_lengths(lengths), min=1)


def _logits(model, feats: torch.Tensor, cfg: StepConfig, lengths) -> torch.Tensor:
    if cfg.trunk_span is not None:
        return model.windowed_logits(feats, *cfg.trunk_span)
    return model(feats, lengths=frame_lengths(lengths, cfg))


def _features(audio: torch.Tensor, cfg: StepConfig, draws: StepDraws, noise_bank):
    """The step's augmented audio, then its features: (audio, replaced
    rows or None, (B, C, F, T) features), without gradients."""
    replaced = None
    with torch.no_grad():
        if cfg.augment is not None:
            audio, replaced = aug.apply_augment_audio(audio, draws.augment, cfg.augment, noise_bank)
        feats = featurize(audio, cfg, draws.vtlp_alpha if cfg.use_vtlp else None)
        if cfg.augment is not None:
            feats = aug.apply_spec_augment(feats, draws.spec)
    return audio, replaced, feats


def _train_forward(state: TrainState, gen: torch.Generator, draws: StepDraws, forward: Callable, group=None,
                   rows=None):
    """``forward(model)`` -> (loss, outputs) in training mode with the
    step's dropout masks (``draws.dropout``, else drawn from ``gen``), then
    its backward and one AdamW update. Returns (loss, outputs). With a data
    group (``parallel.mesh.DataGroup``), ``rows`` (lo, hi, total) are this
    rank's rows of the global batch: the dropout masks are the global
    batch's rows [lo, hi), BatchNorm normalizes by the global batch's
    statistics, and the gradients are the group's mean before the update."""
    model = state.model
    model.train()
    use_dropout_draws(model, DropoutDraws(gen, draws.dropout, rows))
    use_data_group(model, group)
    try:
        state.optimizer.zero_grad(set_to_none=True)
        loss, out = forward(model)
        loss.backward()
    finally:
        use_dropout_draws(model, None)
        use_data_group(model, None)
    if group is not None:
        from howl_tpu_torch.parallel.data_parallel import average_gradients

        average_gradients(model.parameters(), group)
    state.apply_gradients()
    return loss, out


def _global_draws(gen, cfg: StepConfig, b: int, n: int, noise_bank, draws: Optional[StepDraws], group):
    """The step's draws for this process's ``b`` rows, and the rows (lo,
    hi, total) of a data group's global batch (None without a group): the
    draws of the whole global batch, drawn (or given) for ``total`` rows,
    then this rank's rows of them."""
    rows = group.rows(b) if group is not None else None
    total = rows[2] if rows else b
    if draws is None:
        draws = draw_step(gen, cfg, total, n, noise_bank)
    if rows:
        from howl_tpu_torch.parallel.data_parallel import take_rows

        draws = draws._replace(augment=take_rows(draws.augment, *rows), spec=take_rows(draws.spec, *rows))
    return draws, rows


def _metric(x: torch.Tensor, group) -> torch.Tensor:
    """A step metric, the group's mean with a data group."""
    if group is None:
        return x.detach()
    from howl_tpu_torch.parallel.data_parallel import all_mean

    return all_mean(x, group)


class NoiseBankTrainStep:
    """Train-step callable holding a refreshable device noise bank.

    ``set_bank`` swaps in a new bank (the epoch refresh that lets long runs
    sample the whole noise corpus). The wrap-extended view is derived once
    per (bank, window size) and cached. Call signature matches the bankless
    step: (state, audio, labels, lengths, key, draws=None)."""

    def __init__(self, step: Callable, noise_bank):
        self.inner = step  # the bankless step, which takes the prepared bank as ``noise_bank``
        self._prepared: dict = {}
        self._bank = None
        self.set_bank(noise_bank)

    def set_bank(self, noise_bank):
        self._prepared.clear()
        if isinstance(noise_bank, aug.PreparedNoiseBank):
            self._prepared[(noise_bank.window, str(noise_bank.extended.device))] = noise_bank
            self._bank = None
        else:
            self._bank = noise_bank

    def prepared_for(self, window: int, device=None) -> aug.PreparedNoiseBank:
        """The bank prepared for ``window``-sample windows on ``device``
        (each device of a seed sweep across cards holds its copy)."""
        if device is None:  # where the bank lies
            if self._bank is None:
                device = next(iter(self._prepared))[1]
            else:
                device = self._bank.device if torch.is_tensor(self._bank) else "cpu"
        key = (window, str(torch.device(device)))
        prep = self._prepared.get(key)
        if prep is None:
            if self._bank is None:
                raise ValueError(
                    f"noise bank was prepared for (window, device) {sorted(self._prepared)}; cannot serve "
                    f"{window}-sample windows on {device} (set_bank with a raw array to re-derive)"
                )
            prep = self._prepared[key] = aug.prepare_noise_bank(self._bank, window, device)
        return prep

    def __call__(self, state, audio, *rest, **kw):
        return self.inner(state, audio, *rest, noise_bank=self.prepared_for(audio.shape[-1], audio.device), **kw)


def make_classification_train_step(model, cfg: StepConfig, noise_bank=None, group=None) -> Callable:
    """Returns (state, audio, labels, lengths, key, draws=None) -> (state,
    {"loss", "accuracy"}); ``state`` is updated in place and returned.

    With a noise bank the callable is a ``NoiseBankTrainStep`` whose bank
    ``set_bank`` replaces. ``lengths`` (true samples, or None) reach the
    model as frame lengths (``frame_lengths``); res8 scores whole windows
    whatever they are. ``gen``, when given, is the step's generator
    (``step_generator(key, state.step)``) already past the draws, as the
    seed sweep passes it; the callable's ``cfg`` is ``cfg``.

    With a data group (``parallel.mesh.DataGroup``), ``audio``, ``labels``
    and ``lengths`` are this rank's rows of the global batch
    (``parallel.mesh.shard_batch``), ``draws`` when given are the global
    batch's, and the metrics are the global batch's means
    (``parallel/data_parallel.py``)."""

    def train_step(state: TrainState, audio, labels, lengths, key, draws: Optional[StepDraws] = None, noise_bank=None,
                   gen: Optional[torch.Generator] = None):
        b, n = audio.shape
        gen = gen if gen is not None else step_generator(key, state.step, audio.device)
        draws, rows = _global_draws(gen, cfg, b, n, noise_bank, draws, group)
        _, replaced, feats = _features(audio, cfg, draws, noise_bank)
        if replaced is not None:
            labels = torch.where(replaced, cfg.negative_label, labels)

        def forward(model):
            logits = _logits(model, feats, cfg, lengths)
            return frame_ce_loss(logits, labels), logits

        loss, logits = _train_forward(state, gen, draws, forward, group, rows)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": _metric(loss, group), "accuracy": _metric(acc, group)}

    train_step.cfg = cfg
    train_step.group = group
    if noise_bank is None:
        return train_step
    return NoiseBankTrainStep(train_step, noise_bank)


def make_classification_eval_step(model, cfg: StepConfig) -> Callable:
    """Returns (state, audio, lengths) -> (B, L) logits, with the running
    BatchNorm stats and no augmentation; ``lengths`` as the train step
    takes them."""

    @torch.no_grad()
    def eval_step(state: TrainState, audio, lengths=None):
        state.model.eval()
        return state.model(featurize(audio, cfg), lengths=frame_lengths(lengths, cfg))

    return eval_step


def make_ctc_train_step(model, cfg: StepConfig, noise_bank=None, group=None) -> Callable:
    """The CTC objective over a sequential model: returns (state, audio,
    labels, audio_lengths, label_lengths, key, draws=None) -> (state,
    {"loss"}), ``state`` updated in place, as the JAX step: augmentation
    without replacement (``replace_prob`` 0), frame lengths
    ``max(compute_lengths(audio_lengths), 1)`` into the model, its output
    lengths through ``model.compute_length`` clipped to its frames, and
    ``ctc_loss`` with ``cfg.blank_label``. With a noise bank the callable is
    a ``NoiseBankTrainStep``; ``gen``, ``cfg`` and ``group`` as the
    classification step's."""
    cfg = cfg._replace(replace_prob=0.0)

    def train_step(state: TrainState, audio, labels, audio_lengths, label_lengths, key,
                   draws: Optional[StepDraws] = None, noise_bank=None, gen: Optional[torch.Generator] = None):
        b, n = audio.shape
        gen = gen if gen is not None else step_generator(key, state.step, audio.device)
        draws, rows = _global_draws(gen, cfg, b, n, noise_bank, draws, group)
        _, _, feats = _features(audio, cfg, draws, noise_bank)
        lengths = frame_lengths(audio_lengths, cfg)

        def forward(model):
            out = model(feats, lengths=lengths)  # (T', B, L)
            out_lengths = torch.clamp(torch.as_tensor(model.compute_length(lengths)), max=out.shape[0])
            return ctc_loss(out, out_lengths, labels, label_lengths, cfg.blank_label), out

        loss, _ = _train_forward(state, gen, draws, forward, group, rows)
        return state, {"loss": _metric(loss, group)}

    train_step.cfg = cfg
    train_step.group = group
    if noise_bank is None:
        return train_step
    return NoiseBankTrainStep(train_step, noise_bank)
