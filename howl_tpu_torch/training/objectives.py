"""Loss functions: frame cross-entropy and CTC (counterpart of
``howl_tpu/training/objectives.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def frame_ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights=None) -> torch.Tensor:
    """Mean cross-entropy over (B, L) logits and int labels, in float32;
    with per-example ``weights``, their weighted mean (the weights' sum
    floored at 1)."""
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=losses.dtype, device=losses.device)
        return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return losses.mean()


def ctc_loss(logits_tbl: torch.Tensor, logit_lengths, labels, label_lengths, blank_id: int) -> torch.Tensor:
    """CTC over a sequential model's (T, B, L) per-frame logits: ``F.ctc_loss``
    on their float32 log-softmax, the first ``logit_lengths[b]`` frames and
    ``label_lengths[b]`` labels of each sequence, then each sequence's NLL
    divided by its target length (floored at 1) and the batch mean, as
    ``nn.CTCLoss(reduction="mean")`` computes it, the reference's loss,
    which the JAX package restates on optax."""
    log_probs = F.log_softmax(logits_tbl.float(), dim=-1)
    device = log_probs.device
    label_lengths = torch.as_tensor(label_lengths, device=device).long()
    per_seq = F.ctc_loss(log_probs, torch.as_tensor(labels, device=device).long(),
                         torch.as_tensor(logit_lengths, device=device).long(), label_lengths, blank=blank_id,
                         reduction="none")
    return (per_seq / torch.clamp(label_lengths, min=1)).mean()
