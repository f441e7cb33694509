"""Losses: cross entropy with label smoothing, against soft targets
(Mixup/CutMix), and knowledge distillation from a teacher's logits (the
JAX package's `train/losses.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

DISTILLATION_TYPES = ("none", "soft", "hard")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE against int labels; the smoothed target puts 1 - s + s/C on
    the label and s/C elsewhere (timm LabelSmoothingCrossEntropy)."""
    return F.cross_entropy(logits.float(), labels.long(),
                           label_smoothing=smoothing)


def soft_target_cross_entropy(logits: torch.Tensor,
                              soft_targets: torch.Tensor) -> torch.Tensor:
    """Mean CE against probability targets [B, C], in float32 (timm
    SoftTargetCrossEntropy, the Mixup/CutMix criterion)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(soft_targets * logp, dim=-1))


def distillation_loss(base_loss: torch.Tensor, student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, kind: str, alpha: float,
                      tau: float) -> torch.Tensor:
    """Blend the base loss with a distillation term, in float32:
    base * (1 - alpha) + dist * alpha.

    kind='soft': KL(teacher/T || student/T) * T^2 summed and divided by the
    number of logits; kind='hard': CE against the teacher's argmax;
    kind='none': the base loss alone."""
    if kind == "none":
        return base_loss
    s = student_logits.float()
    t = teacher_logits.float()
    if kind == "soft":
        logp_s = F.log_softmax(s / tau, dim=-1)
        logp_t = F.log_softmax(t / tau, dim=-1)
        kl = torch.sum(logp_t.exp() * (logp_t - logp_s))
        dist = kl * (tau * tau) / s.numel()
    elif kind == "hard":
        dist = cross_entropy(s, t.argmax(dim=-1))
    else:
        raise ValueError(f"unknown distillation type {kind!r}; choose from "
                         f"{DISTILLATION_TYPES}")
    return base_loss * (1.0 - alpha) + dist * alpha
