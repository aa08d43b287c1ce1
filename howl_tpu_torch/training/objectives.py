"""Loss functions (counterpart of ``howl_tpu/training/objectives.py``).

Frame cross-entropy is ported; CTC needs the sequential models, which are
not ported yet.
"""

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


def ctc_loss(logits_tbl, logit_lengths, labels, label_lengths, blank_id: int):
    raise NotImplementedError(
        "ctc_loss is not ported to PyTorch yet: it trains the sequential models "
        "(ROADMAP Queue 1, item 8: remaining model zoo)"
    )
