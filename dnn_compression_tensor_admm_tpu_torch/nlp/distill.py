"""Two-stage TinyBERT-style distillation losses (counterpart of the JAX
package's `nlp/distill.py`; the reference's task_distill.py:806-840).

Stage 1: MSE between student and teacher attention scores (masked
positions, scores <= -1e2, zeroed on both sides) plus MSE between hidden
states, the embedding output included; student layer i reads teacher
layer (i + 1) * k - 1 for scores and i * k for hidden states, k the depth
ratio. Stage 2: soft cross-entropy of the student's logits against the
teacher's at temperature T.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _zero_masked(att: torch.Tensor) -> torch.Tensor:
    return torch.where(att <= -1e2, torch.zeros((), device=att.device,
                                                 dtype=att.dtype), att)


def attention_hidden_distill_loss(student_atts: Sequence[torch.Tensor],
                                  teacher_atts: Sequence[torch.Tensor],
                                  student_reps: Sequence[torch.Tensor],
                                  teacher_reps: Sequence[torch.Tensor]):
    """-> (att_loss, rep_loss)."""
    ns, nt = len(student_atts), len(teacher_atts)
    assert nt % ns == 0, (ns, nt)
    k = nt // ns
    att_loss = 0.0
    for i, s in enumerate(student_atts):
        t = teacher_atts[(i + 1) * k - 1]
        att_loss = att_loss + torch.mean((_zero_masked(s) - _zero_masked(t)) ** 2)
    rep_loss = 0.0
    for i, s in enumerate(student_reps):
        t = teacher_reps[i * k]
        rep_loss = rep_loss + torch.mean((s.float() - t.float()) ** 2)
    return att_loss, rep_loss


def soft_logits_loss(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """-sum(softmax(t / T) * log_softmax(s / T)), mean over the batch."""
    s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    t = torch.softmax(teacher_logits.float() / temperature, dim=-1)
    return -torch.mean(torch.sum(t * s, dim=-1))
