"""Posterior smoothing + FSM sequence matching, all steps in parallel
(counterpart of ``howl_tpu/inference/detect.py``'s parallel form).

Every step's decision only looks at a bounded trailing window (s_steps
posteriors for the smoothing max, w_steps labels for the FSM re-scan), so all
steps of all streams are decided at once on (B, T) tensors, with one Python
loop over the w_steps window entries. The float sentinels are the JAX
package's: ``-inf`` fills invalid posteriors and ``-1e30`` marks "no matched
entry yet"; both survive in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from howl_tpu_torch.inference.config import EngineConfig


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
        color = torch.tensor(cfg.label_color_map, dtype=torch.int32, device=probs_seq.device)
        max_label = color[max_label.long()]
    return max_label, max_prob, valid_seq


def _fsm_parallel(labels, valid_seq, cfg: EngineConfig, w_steps: int, stride: float, check_offset: float):
    """FSM for all steps at once over trailing label windows: thresholded
    labels (B, T) in, per-step fire decisions out."""
    batch, t_total = labels.shape
    dev = labels.device
    seq = torch.tensor(cfg.inference_sequence, dtype=torch.int32, device=dev)
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


def apply_inference_weights(probs: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """probs * weights, renormalized."""
    w = cfg.padded_weights()
    if w is None:
        return probs
    weighted = probs * torch.from_numpy(w).to(probs.device)
    return weighted / weighted.sum(-1, keepdim=True)
