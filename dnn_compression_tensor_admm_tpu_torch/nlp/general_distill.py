"""General (pretraining-corpus) distillation (counterpart of the JAX
package's `nlp/general_distill.py`; the reference's
xcompression/general_distill.py:423-453): attention and hidden-state MSE
between a compressed student and a dense teacher over masked-LM
examples, no task labels. Without a teacher state the teacher is the
seeded dense init, as in the JAX package. The step (the teacher's no-grad
forward, the student's forward and backward, BertAdam) is replayed from a
CUDA graph on the card and runs eagerly on the CPU (`nlp/steps.py`)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.precision import full_f32
from ..utils.device import resolve_device
from .bert import BertCompressionPlan, BertConfig, BertModel
from .distill import attention_hidden_distill_loss
from .pregenerate import pregenerate_mlm_examples, synthetic_corpus
from .steps import DeviceBatches, StepClock, TrainLoop, route
from .task_distill import make_bert_adam, to_device
from .tokenization import WordPieceTokenizer, build_vocab_from_texts


@dataclasses.dataclass
class GeneralDistillConfig:
    max_seq_length: int = 128
    batch_size: int = 32
    epochs: int = 1
    lr: float = 1e-4
    warmup_frac: float = 0.1
    seed: int = 0
    n_synthetic_docs: int = 256
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    plan: BertCompressionPlan = dataclasses.field(
        default_factory=lambda: BertCompressionPlan(linear_format="tt",
                                                    linear_ratio=2.0))
    grad_accum_steps: int = 1
    device: str = "cuda"
    print_fn: Callable = print


def general_data(cfg: GeneralDistillConfig, texts=None):
    """(masked-LM arrays with a zero `labels` column, tokenizer)."""
    texts = texts or synthetic_corpus(cfg.n_synthetic_docs, cfg.seed)
    tok = WordPieceTokenizer(build_vocab_from_texts(texts))
    data = pregenerate_mlm_examples(texts, tok, cfg.max_seq_length,
                                    seed=cfg.seed)
    data = {k: v for k, v in data.items()
            if k in ("input_ids", "attention_mask", "token_type_ids")}
    data["labels"] = np.zeros(len(data["input_ids"]), np.int32)  # batcher key
    return data, tok


@full_f32()
def run_general_distillation(
        cfg: GeneralDistillConfig, texts=None,
        teacher_state: Optional[Dict[str, torch.Tensor]] = None,
        eager: bool = False):
    """-> (student, history). `teacher_state`: a dense BERT's state dict;
    without one the teacher is the seeded init. `eager`: the eager
    reference loop, never captured."""
    log = cfg.print_fn
    device = resolve_device(cfg.device)
    data_np, tok = general_data(cfg, texts)
    bert_cfg = dataclasses.replace(cfg.bert, vocab_size=len(tok.vocab))
    teacher = BertModel(bert_cfg,
                        generator=torch.Generator().manual_seed(cfg.seed))
    student = BertModel(bert_cfg, cfg.plan,
                        generator=torch.Generator().manual_seed(cfg.seed + 1))
    if teacher_state is not None:
        teacher.load_state_dict(teacher_state)
    teacher.to(device).eval()
    student.to(device)
    data = DeviceBatches(to_device(data_np, device), cfg.batch_size)
    steps = max(1, len(data_np["input_ids"]) // cfg.batch_size) * cfg.epochs
    opt = make_bert_adam(student, cfg.lr,
                         max(1, steps // cfg.grad_accum_steps),
                         cfg.warmup_frac, cfg.grad_accum_steps)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)

    def loss_fn(b):
        args = (b["input_ids"], b["attention_mask"], b["token_type_ids"])
        with torch.no_grad():
            t = teacher(*args)
        s = student(*args, generator=gen)
        att, rep = attention_hidden_distill_loss(
            s["attentions"], t["attentions"], s["hidden_states"],
            t["hidden_states"])
        return att + rep

    loop = TrainLoop(loss_fn, opt, data, (gen,), route(device, eager, log))
    nprng = np.random.RandomState(cfg.seed)
    history = []
    for ep in range(cfg.epochs):
        t0 = time.time()
        clock = StepClock(device)
        student.train()
        row = {"epoch": ep + 1, "loss": loop.epoch(nprng, clock),
               "ms_per_step": clock.ms_per_step(),
               "time_s": time.time() - t0}
        history.append(row)
        log(row)
    return student, history
