"""Cross entropy with label smoothing."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE against int labels; the smoothed target puts 1 - s + s/C on
    the label and s/C elsewhere (timm LabelSmoothingCrossEntropy)."""
    return F.cross_entropy(logits.float(), labels.long(),
                           label_smoothing=smoothing)
