"""howl's decision rule over a sequence of posteriors (``howl/model/
inference.py``): each step's posteriors are max-pooled over the smoothing
window, the argmax is the step's label (the negative label where its
smoothed posterior is under the threshold), and the sequence FSM walks the
labels of the inference window in time order: it advances on the next label
of the wake sequence, keeps a repeat of the label it last matched, and starts
over once other labels have lasted longer than the tolerance window. A step
fires when the walk it ends completes the sequence, the FSM consulted one
stride after the step (a window's decision is due when the next begins).

Here every step of every stream is decided at once over (N, T) arrays: step
t's smoothing reads steps [t - s_steps + 1, t], its FSM the w_steps steps
before it that lie inside the inference window at t + stride. Times are
float32 milliseconds relative to step t, as a float32 device clock gives
them. Invalid steps (a live stream's first hops, before any window is
final) are not pushed: their label is -1 and they never fire.
"""

import numpy as np
import torch


def decide(probs: torch.Tensor, valid: torch.Tensor, eng: dict, stride_ms: float) -> dict:
    """probs (N, T, L) float32 posteriors, valid (N, T) -> {"labels",
    "fired"} (N, T), {"detected", "first_fire_step"} (N,)."""
    n, t_total, _ = probs.shape
    dev = probs.device
    valid = valid.to(torch.bool)
    smoothing = int(eng["smoothing_window_ms"] // stride_ms) + 1
    lattice = probs.float().masked_fill(~valid[:, :, None], -torch.inf)
    smoothed = lattice.clone()
    for k in range(1, min(smoothing, t_total)):
        smoothed[:, k:] = torch.maximum(smoothed[:, k:], lattice[:, :-k])
    peak, label = smoothed.max(dim=-1)  # the first maximum
    label = torch.where(peak < eng["inference_threshold"], torch.full_like(label, eng["negative_label"]), label)
    label = torch.where(valid, label, torch.full_like(label, -1))

    seq = torch.tensor(eng["inference_sequence"], dtype=torch.long, device=dev)
    k_len = len(eng["inference_sequence"])
    window, tolerance = np.float32(eng["inference_window_ms"]), np.float32(eng["tolerance_window_ms"])
    w_steps = int((eng["inference_window_ms"] - stride_ms) // stride_ms) + 1
    target = torch.zeros((n, t_total), dtype=torch.long, device=dev)
    current = torch.full((n, t_total), -1, dtype=torch.long, device=dev)
    last = torch.full((n, t_total), -1e30, dtype=torch.float32, device=dev)
    fired = torch.zeros((n, t_total), dtype=torch.bool, device=dev)
    for back in range(w_steps - 1, -1, -1):  # oldest entry first
        if back >= t_total or np.float32(back) * np.float32(stride_ms) + np.float32(stride_ms) > window:
            continue
        rel = float(np.float32(-back) * np.float32(stride_ms))
        lab = torch.full((n, t_total), -1, dtype=torch.long, device=dev)
        ok = torch.zeros((n, t_total), dtype=torch.bool, device=dev)
        lab[:, back:] = label[:, : t_total - back]
        ok[:, back:] = valid[:, : t_total - back]
        live = ok & ~fired
        want = seq[target.clamp(max=k_len - 1)]
        advance = live & (lab == want)
        same = live & ~advance & (lab == current)
        expire = live & ~advance & ~same & (last + tolerance < rel)
        target = torch.where(advance, target + 1, target.masked_fill(expire, 0))
        fired = fired | (target >= k_len)
        current = torch.where(advance, want, current.masked_fill(expire, -1))
        last = last.masked_fill(expire, -1e30).masked_fill(advance | same, rel)
    fired = fired & valid
    detected = fired.any(dim=1)
    first = torch.where(detected, fired.to(torch.uint8).argmax(dim=1), torch.full((n,), t_total, device=dev))
    return {"labels": label, "fired": fired, "detected": detected, "first_fire_step": first}
