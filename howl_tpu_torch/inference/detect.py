"""Posterior smoothing + FSM sequence matching (counterpart of
``howl_tpu/inference/detect.py``), in two forms.

The scan form steps one posterior frame per stream at a time, as the online
engines serve: ``DetectState`` holds a smoothing ring of S posterior frames
and a label ring of W labels with their timestamps (most recent last), and
``detect_step`` pushes one frame, smooths, thresholds and re-scans the label
ring with the sequence FSM (``fsm_scan``, one Python loop over the W slots
on (B,) tensors).

The parallel form decides every step of a (B, T) sequence at once: each
step's decision only looks at a bounded trailing window (s_steps posteriors
for the smoothing max, w_steps labels for the FSM re-scan), so all steps of
all streams are decided on (B, T) tensors, with one Python loop over the
w_steps window entries. ``smooth_and_detect_sweep`` runs the smoothing once
and the FSM at K thresholds, K folded into the batch axis.

The float sentinels are the JAX package's: ``-1e30`` marks an empty ring
slot and "no matched entry yet", ``-inf`` fills invalid posteriors, ``-1``
an empty or invalid label; all survive in float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from howl_tpu_torch.inference.config import EngineConfig

EMPTY_TIME = -1e30  # the timestamp of an empty ring slot


@functools.lru_cache(maxsize=64)
def _device_const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor made once per device: a copy from the host
    each step would wait for the device's queue to drain."""
    return torch.tensor(values, dtype=dtype, device=device)


class DetectState(NamedTuple):
    pred_ring: torch.Tensor  # (B, S, L) posterior history (most recent last)
    pred_times: torch.Tensor  # (B, S) timestamps; -1e30 = empty slot
    label_ring: torch.Tensor  # (B, W) label history (most recent last); -1 = empty
    label_times: torch.Tensor  # (B, W) timestamps; -1e30 = empty slot
    fired: torch.Tensor  # (B,) sticky detection flag


def init_state(batch: int, num_labels: int, s_steps: int, w_steps: int, device="cuda") -> DetectState:
    """Empty rings for ``batch`` streams on ``device`` (the card unless the
    caller names the CPU)."""
    return DetectState(
        pred_ring=torch.zeros((batch, s_steps, num_labels), dtype=torch.float32, device=device),
        pred_times=torch.full((batch, s_steps), EMPTY_TIME, dtype=torch.float32, device=device),
        label_ring=torch.full((batch, w_steps), -1, dtype=torch.int32, device=device),
        label_times=torch.full((batch, w_steps), EMPTY_TIME, dtype=torch.float32, device=device),
        fired=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _as_times(t, batch: int, device) -> torch.Tensor:
    """A python number or a tensor -> (batch,) float32 on ``device``."""
    if torch.is_tensor(t):
        return t.to(device=device, dtype=torch.float32).expand(batch) if t.ndim == 0 else t.to(torch.float32)
    return torch.full((batch,), float(np.float32(t)), dtype=torch.float32, device=device)


def fsm_scan(
    label_ring: torch.Tensor,
    label_times: torch.Tensor,
    check_time,
    sequence: Tuple[int, ...],
    tolerance_ms: float,
    inference_window_ms: float,
) -> torch.Tensor:
    """Run the sequence FSM over the (chronological) label ring; fired (B,).

    Per stream: walk the entries newer than ``check_time -
    inference_window_ms``; advance on the next expected label, tolerate
    repeats of the last matched label, reset after ``tolerance_ms`` of other
    labels.
    """
    batch, w = label_ring.shape
    dev = label_ring.device
    k = len(sequence)
    fired = torch.zeros((batch,), dtype=torch.bool, device=dev)
    if k == 0:
        return fired
    seq = _device_const(tuple(sequence), torch.int32, dev)
    check_time = _as_times(check_time, batch, dev)
    # every slot's window test at once: the same float32 comparisons the JAX loop makes slot by slot
    in_window = (label_times > -1e29) & (check_time[:, None] - label_times <= inference_window_ms)
    target = torch.zeros((batch,), dtype=torch.int32, device=dev)
    curr_label = torch.full((batch,), -1, dtype=torch.int32, device=dev)
    last_valid = torch.zeros((batch,), dtype=torch.float32, device=dev)
    for j in range(w):
        lab, t = label_ring[:, j], label_times[:, j]
        live = in_window[:, j] & ~fired
        target_label = seq[target.clamp(0, k - 1).long()]
        advance = live & (lab == target_label)
        same = live & ~advance & (lab == curr_label)
        expire = live & ~advance & ~same & (last_valid + tolerance_ms < t)
        target = torch.where(advance, target + 1, target.masked_fill(expire, 0))
        fired = fired | (target >= k)
        curr_label = torch.where(advance, target_label, curr_label.masked_fill(expire, -1))
        last_valid = torch.where(advance | same, t, last_valid.masked_fill(expire, 0.0))
    return fired


def _push(ring: torch.Tensor, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shift ``x`` into the newest-last ring (axis 1) where ``valid``; a new
    tensor, never an in-place write to one a previous state still holds."""
    pushed = torch.cat([ring[:, 1:], x[:, None]], dim=1)
    return torch.where(valid.reshape((-1,) + (1,) * (ring.ndim - 1)), pushed, ring)


def detect_step(
    state: DetectState,
    probs: torch.Tensor,
    t_now,
    valid: torch.Tensor,
    cfg: EngineConfig,
    check_offset_ms: float,
) -> Tuple[DetectState, torch.Tensor, torch.Tensor]:
    """Ingest one posterior frame (B, L) per stream; returns (state, label,
    fired_now).

    ``valid`` (B,) masks the streams that produced a frame this step: an
    invalid stream's rings are left as they were, its label is -1 and it
    cannot fire. ``t_now`` is the step's timestamp in ms (a number or a
    (B,) tensor); the FSM is consulted at ``t_now + check_offset_ms``.
    """
    batch, dev = probs.shape[0], probs.device
    t_now = _as_times(t_now, batch, dev)
    if torch.is_tensor(valid):
        valid = valid.to(torch.bool).expand(batch)
    else:
        valid = torch.full((batch,), bool(valid), dtype=torch.bool, device=dev)
    if cfg.blank_label >= 0:
        valid = valid & (probs.argmax(-1) != cfg.blank_label)

    # push the posterior frame into the smoothing ring (only where valid)
    pred_ring = _push(state.pred_ring, probs.to(torch.float32), valid)
    pred_times = _push(state.pred_times, t_now, valid)

    # smoothing: max over the frames inside the smoothing window
    in_window = (t_now[:, None] - pred_times <= cfg.smoothing_window_ms) & (pred_times > -1e29)
    lattice_max = pred_ring.masked_fill(~in_window[:, :, None], -torch.inf).amax(dim=1)  # (B, L)
    max_label = lattice_max.argmax(-1).to(torch.int32)  # the first maximum, as jnp.argmax
    if cfg.label_color_map is not None:
        # phone mode: the phone argmax grouped into its word color before the FSM
        max_label = _device_const(cfg.label_color_map, torch.int32, dev)[max_label.long()]
    max_prob = lattice_max.amax(-1)
    label = max_label.masked_fill(max_prob < cfg.inference_threshold, cfg.negative_label)

    # push the label into the FSM ring (only where valid)
    label_ring = _push(state.label_ring, label, valid)
    label_times = _push(state.label_times, t_now, valid)

    fired_now = fsm_scan(
        label_ring, label_times, t_now + check_offset_ms, cfg.inference_sequence,
        cfg.tolerance_window_ms, cfg.inference_window_ms,
    ) & valid
    new_state = DetectState(pred_ring, pred_times, label_ring, label_times, state.fired | fired_now)
    return new_state, label.masked_fill(~valid, -1), fired_now


def _ring_geometry(times, cfg: EngineConfig, check_offset_is_stride: bool):
    """(static_cfg, s_steps, w_steps, stride, check_offset) from the step
    timestamps, the same formulas as the JAX package."""
    times = np.asarray(times, np.float32)
    stride = float(times[1] - times[0]) if times.shape[0] > 1 else cfg.eval_stride_size_ms
    stride = max(stride, 1e-6)
    s_steps = max(int(cfg.smoothing_window_ms // stride) + 1, 1)
    check_offset = stride if check_offset_is_stride else 0.0
    # shifts k where an entry at t-k is still inside the inference window when
    # checked at t + check_offset: k*stride + check_offset <= window
    w_steps = max(int((cfg.inference_window_ms - check_offset) // stride) + 1, 1)
    static_cfg = dataclasses.replace(cfg, inference_threshold=0.0)
    return static_cfg, s_steps, w_steps, float(stride), float(check_offset)


def _smooth_parallel(probs_seq: torch.Tensor, valid_seq: torch.Tensor, cfg: EngineConfig, s_steps: int):
    """Masked-max smoothing over s_steps shifts plus the phone->color remap.
    Returns (max_label, max_prob, valid_seq)."""
    valid_seq = valid_seq.to(torch.bool)
    if cfg.blank_label >= 0:
        valid_seq = valid_seq & (probs_seq.argmax(-1) != cfg.blank_label)
    lattice = probs_seq.masked_fill(~valid_seq[:, :, None], -torch.inf)
    smoothed = lattice
    for k in range(1, min(s_steps, lattice.shape[1])):
        shifted = torch.nn.functional.pad(lattice[:, :-k], (0, 0, k, 0), value=-torch.inf)
        smoothed = torch.maximum(smoothed, shifted)
    max_label = smoothed.argmax(-1).to(torch.int32)  # first maximum, as jnp.argmax
    max_prob = smoothed.amax(-1)
    if cfg.label_color_map is not None:
        max_label = _device_const(cfg.label_color_map, torch.int32, probs_seq.device)[max_label.long()]
    return max_label, max_prob, valid_seq


def _fsm_parallel(labels, valid_seq, cfg: EngineConfig, w_steps: int, stride: float, check_offset: float):
    """FSM for all steps at once over trailing label windows: thresholded
    labels (B, T) in, per-step fire decisions out."""
    batch, t_total = labels.shape
    dev = labels.device
    seq = _device_const(tuple(cfg.inference_sequence), torch.int32, dev)
    k_len = len(cfg.inference_sequence)
    # padded[:, t + j] = entry at step t - (w_steps-1-j), oldest first
    pad_lab = torch.nn.functional.pad(labels, (w_steps - 1, 0), value=-1)
    pad_val = torch.nn.functional.pad(valid_seq, (w_steps - 1, 0), value=False)

    target = torch.zeros((batch, t_total), dtype=torch.int32, device=dev)
    curr_label = torch.full((batch, t_total), -1, dtype=torch.int32, device=dev)
    last_valid = torch.full((batch, t_total), -1e30, dtype=torch.float32, device=dev)
    fired = torch.zeros((batch, t_total), dtype=torch.bool, device=dev)
    for j in range(w_steps if k_len else 0):
        back = w_steps - 1 - j  # how many steps back this entry is
        # float32 host arithmetic, as the JAX loop does it on its int32 index
        if np.float32(back) * np.float32(stride) + np.float32(check_offset) > np.float32(
            cfg.inference_window_ms
        ):
            continue  # the entry is outside the inference window at check time
        rel_t = float(np.float32(-back) * np.float32(stride))  # entry time relative to step t
        lab = pad_lab[:, j : j + t_total]
        live = pad_val[:, j : j + t_total] & ~fired
        target_label = seq[target.clamp(0, k_len - 1).long()]
        advance = live & (lab == target_label)
        same = live & ~advance & (lab == curr_label)
        expire = live & ~advance & ~same & (last_valid + cfg.tolerance_window_ms < rel_t)
        target = torch.where(advance, target + 1, target.masked_fill(expire, 0))
        fired = fired | (target >= k_len)
        curr_label = torch.where(advance, target_label, curr_label.masked_fill(expire, -1))
        last_valid = last_valid.masked_fill(expire, -1e30).masked_fill(advance | same, rel_t)
    fired_steps = fired & valid_seq  # a step with no appended frame can't fire
    detected = fired_steps.any(dim=1)
    first_fire = torch.where(
        detected,
        fired_steps.to(torch.uint8).argmax(dim=1),
        torch.full((batch,), t_total, dtype=torch.long, device=dev),
    )
    return {
        "labels": torch.where(valid_seq, labels, torch.full_like(labels, -1)),
        "fired": fired_steps,
        "detected": detected,
        "first_fire_step": first_fire,
    }


def _smooth_and_detect_parallel(
    probs_seq, valid_seq, threshold, cfg: EngineConfig, s_steps: int, w_steps: int, stride: float, check_offset: float
):
    """Smoothing, thresholding and the FSM over (B, T, L) posteriors."""
    max_label, max_prob, valid_seq = _smooth_parallel(probs_seq, valid_seq, cfg, s_steps)
    threshold = torch.tensor(threshold, dtype=torch.float32, device=probs_seq.device)
    labels = torch.where(max_prob < threshold, torch.full_like(max_label, cfg.negative_label), max_label)
    return _fsm_parallel(labels, valid_seq, cfg, w_steps, stride, check_offset)


def smooth_and_detect(probs_seq, times, valid_seq, cfg: EngineConfig, check_offset_is_stride: bool = True) -> dict:
    """Smoothing + FSM over posterior frames (B, T, L), all steps in parallel.

    times: (T,) uniform-stride frame timestamps in ms (host values).
    valid_seq: (B, T) frame validity (padding windows / CTC blank frames).
    ``check_offset_is_stride`` consults the FSM at t + stride (the windowed
    engine) instead of at t (the whole-clip engine).

    Returns per-step labels (B, T), fired mask (B, T), detected (B,) and
    first fire step (B,) (= T when never fired).
    """
    static_cfg, s_steps, w_steps, stride, check_offset = _ring_geometry(times, cfg, check_offset_is_stride)
    return _smooth_and_detect_parallel(
        probs_seq, torch.as_tensor(valid_seq, device=probs_seq.device), cfg.inference_threshold,
        static_cfg, s_steps, w_steps, stride, check_offset,
    )


def _smooth_and_detect_sweep(
    probs_seq, valid_seq, thresholds, cfg: EngineConfig, s_steps: int, w_steps: int, stride: float, check_offset: float
):
    """The smoothing once, then the FSM at every threshold: the K thresholded
    label sequences are folded into the batch axis of one ``_fsm_parallel``
    (the JAX package vmaps it). Every output gains a leading (K,) axis."""
    max_label, max_prob, valid_seq = _smooth_parallel(probs_seq, valid_seq, cfg, s_steps)
    thr = torch.as_tensor(np.asarray(thresholds, np.float32), device=probs_seq.device).reshape(-1)
    k = thr.shape[0]
    batch, t_total = max_label.shape
    labels = torch.where(max_prob[None] < thr[:, None, None], torch.full_like(max_label, cfg.negative_label)[None],
                         max_label[None])  # (K, B, T)
    out = _fsm_parallel(labels.reshape(k * batch, t_total), valid_seq.repeat(k, 1), cfg, w_steps, stride, check_offset)
    return {key: v.reshape((k, batch) + tuple(v.shape[1:])) for key, v in out.items()}


def smooth_and_detect_sweep(probs_seq, times, valid_seq, thresholds, cfg: EngineConfig,
                            check_offset_is_stride: bool = True) -> dict:
    """``smooth_and_detect`` at K thresholds at once; the outputs carry a
    leading (K,) thresholds axis."""
    static_cfg, s_steps, w_steps, stride, check_offset = _ring_geometry(times, cfg, check_offset_is_stride)
    return _smooth_and_detect_sweep(
        probs_seq, torch.as_tensor(valid_seq, device=probs_seq.device), thresholds,
        static_cfg, s_steps, w_steps, stride, check_offset,
    )


def apply_inference_weights(probs: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """probs * weights, renormalized."""
    w = cfg.padded_weights()
    if w is None:
        return probs
    weighted = probs * _device_const(tuple(w.tolist()), torch.float32, probs.device)
    return weighted / weighted.sum(-1, keepdim=True)
