"""Task-specific two-stage distillation (counterpart of the JAX package's
`nlp/task_distill.py`; the reference's task_distill.py:1045-1285).

A dense BERT teacher (fine-tuned on the task first when none is given;
synthetic-corpus mode) is scored on dev, then a compressed student
(`BertCompressionPlan`) learns in stage 1 the teacher's attention scores
and hidden states (MSE) and in stage 2 its logits (soft cross-entropy,
or MSE against the labels for STS-B), scored on dev after each stage-2
epoch. Every stage runs BertAdam with a warmup-linear schedule.

Batches are the JAX package's: a `np.random.RandomState` permutation a
pass, the last partial batch dropped, so both packages see the same
batches. Dropout draws from a generator on the device seeded by
`cfg.seed`. Everything runs in float32 with TF32 off (`full_f32`).
Each step (the teacher's fine-tune, stages 1 and 2) and each dev
forward is one function that the card replays from a CUDA graph and the
CPU, or `eager=True`, runs eagerly (`nlp/steps.py`). Each history row
carries `ms_per_step`: wall time a step after the epoch's first step,
the device synchronised at both ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import full_f32
from ..utils.device import resolve_device
from .bert import BertCompressionPlan, BertConfig, BertForSequenceClassification
from .distill import attention_hidden_distill_loss, soft_logits_loss
from .glue import PROCESSORS, convert_examples, glue_metric, synthetic_examples
from .optimization import BertAdam, param_groups
from .steps import DeviceBatches, EvalLoop, StepClock, TrainLoop, route
from .tokenization import WordPieceTokenizer, build_vocab_from_texts


@dataclasses.dataclass
class DistillConfig:
    task: str = "sst-2"
    data_dir: Optional[str] = None        # None -> synthetic corpus
    vocab_path: Optional[str] = None
    max_seq_length: int = 128
    batch_size: int = 32
    stage1_epochs: int = 1
    stage2_epochs: int = 1
    lr_stage1: float = 5e-5
    lr_stage2: float = 3e-5
    warmup_frac: float = 0.1
    seed: int = 0
    n_synthetic: int = 512
    teacher_epochs: int = 4      # synthetic-mode teacher fine-tune budget
    teacher_lr: float = 1e-3
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    plan: BertCompressionPlan = dataclasses.field(
        default_factory=lambda: BertCompressionPlan(
            linear_format="tt", linear_ratio=2.0, embedding_format="svd",
            embedding_ratio=4.5))
    temperature: float = 1.0
    grad_accum_steps: int = 1
    device: str = "cuda"
    print_fn: Callable = print


def make_bert_adam(model, lr: float, total_steps: int, warmup_frac: float,
                   grad_accum_steps: int = 1) -> BertAdam:
    """BertAdam over `model` with a warmup-linear schedule, no decay for
    biases and LayerNorm scales (reference task_distill.py:759-762)."""
    return BertAdam(param_groups(model), lr, schedule="warmup_linear",
                    warmup=warmup_frac, t_total=total_steps,
                    grad_accum_steps=grad_accum_steps)


def to_device(data: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Arrays to the device once; int32 ids as int64, float labels kept."""
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                               else v, device=device)
            for k, v in data.items()}


def prepare_task_data(cfg: DistillConfig):
    proc = PROCESSORS[cfg.task]
    if cfg.data_dir:
        train_ex = proc.get_examples(cfg.data_dir, "train")
        dev_ex = proc.get_examples(cfg.data_dir, "dev")
    else:
        train_ex = synthetic_examples(cfg.task, cfg.n_synthetic, cfg.seed)
        dev_ex = synthetic_examples(cfg.task, cfg.n_synthetic // 4, cfg.seed + 1)
    if cfg.vocab_path:
        tok = WordPieceTokenizer.from_file(cfg.vocab_path)
    else:
        texts = [e.text_a for e in train_ex] + \
                [e.text_b for e in train_ex if e.text_b]
        tok = WordPieceTokenizer(build_vocab_from_texts(texts))
    train = convert_examples(train_ex, tok, cfg.max_seq_length, proc.labels,
                             regression=proc.regression)
    dev = convert_examples(dev_ex, tok, cfg.max_seq_length, proc.labels,
                           regression=proc.regression)
    return train, dev, tok, proc


def task_models(cfg: DistillConfig, vocab_size: int, n_labels: int,
                device="cpu"):
    """(teacher, student): the dense BERT and the compressed one, built on
    `device` (the 'meta' device allocates nothing)."""
    bert_cfg = dataclasses.replace(cfg.bert, vocab_size=vocab_size)
    gen = (lambda s: None if torch.device(device).type == "meta"
           else torch.Generator().manual_seed(s))
    with torch.device(device):
        teacher = BertForSequenceClassification(
            bert_cfg, n_labels, generator=gen(cfg.seed))
        student = BertForSequenceClassification(
            bert_cfg, n_labels, cfg.plan, generator=gen(cfg.seed + 2))
    return teacher, student


def predictor(model, data: Dict[str, torch.Tensor], batch: int,
              regression: bool, why_eager) -> Callable[[], tuple]:
    """The dev forward of `model` in the JAX package's `_batches` order (a
    `RandomState(0)` permutation, the last partial batch dropped) -> a call
    that gives (predictions, labels) on the host."""
    def out(b):
        logits = model(b["input_ids"], b["attention_mask"],
                       b["token_type_ids"])["logits"]
        return {"preds": logits.reshape(-1) if regression
                else logits.argmax(-1), "labels": b["labels"]}

    loop = EvalLoop(model, out, DeviceBatches(data, batch), why_eager)

    def predict():
        got = loop.run(np.random.RandomState(0).permutation(loop.batches.n))
        if not got:
            return np.zeros(0), np.zeros(0)
        return got["preds"], got["labels"]
    return predict


@full_f32()
def run_task_distillation(cfg: DistillConfig,
                          teacher_state: Optional[Dict[str, torch.Tensor]] = None,
                          eager: bool = False):
    """-> (student, history, teacher). `teacher_state`: a fine-tuned dense
    teacher's state dict; without one a teacher is fine-tuned on the task
    first. `eager`: the eager reference loop, never captured."""
    log = cfg.print_fn
    device = resolve_device(cfg.device)
    train_np, dev_np, tok, proc = prepare_task_data(cfg)
    vocab_size = max(len(tok.vocab), int(train_np["input_ids"].max()) + 1)
    regression = proc.regression
    n_labels = 1 if regression else len(proc.labels)
    teacher, student = task_models(cfg, vocab_size, n_labels)
    teacher.to(device)
    student.to(device)
    train = DeviceBatches(to_device(train_np, device), cfg.batch_size)
    dev = to_device(dev_np, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    n_batches = max(1, len(train_np["labels"]) // cfg.batch_size)
    why_eager = route(device, eager, log)

    def s_out(b):
        return student(b["input_ids"], b["attention_mask"],
                       b["token_type_ids"], generator=gen)

    def t_out(b):
        with torch.no_grad():
            return teacher(b["input_ids"], b["attention_mask"],
                           b["token_type_ids"])

    history = []
    teacher_row = {}
    if teacher_state is not None:
        teacher.load_state_dict(teacher_state)
    else:
        # a short task fine-tune so the teacher carries signal
        def teacher_loss(b):
            logits = teacher(b["input_ids"], b["attention_mask"],
                             b["token_type_ids"], generator=gen)["logits"]
            if regression:
                return torch.mean((logits.reshape(-1) - b["labels"]) ** 2)
            return F.cross_entropy(logits, b["labels"])

        opt = make_bert_adam(teacher, cfg.teacher_lr,
                             n_batches * cfg.teacher_epochs, cfg.warmup_frac)
        loop = TrainLoop(teacher_loss, opt, train, (gen,), why_eager)
        nprng = np.random.RandomState(cfg.seed)
        clock = StepClock(device)
        teacher.train()
        epoch_losses = [loop.epoch(nprng, clock)
                        for _ in range(cfg.teacher_epochs)]
        if clock.n:
            last = loop.last_loss()
            teacher_row = {"finetune_loss": last,
                           "finetune_epoch_losses": epoch_losses,
                           "finetune_ms_per_step": clock.ms_per_step()}
            log(f"teacher fine-tuned, last loss {last:.4f}")
        del loop  # its graph and the graph's memory
    teacher.eval()

    # the teacher's dev score: the baseline the student is judged against
    trow = {"stage": 0, "teacher": True, **teacher_row,
            **glue_metric(cfg.task, *predictor(
                teacher, dev, cfg.batch_size, regression, why_eager)())}
    history.append(trow)
    log(trow)
    student_dev = predictor(student, dev, cfg.batch_size, regression,
                            why_eager)

    def run_stage(stage, epochs, lr, loss_fn, nprng):
        steps = max(1, n_batches * epochs // cfg.grad_accum_steps)
        opt = make_bert_adam(student, lr, steps, cfg.warmup_frac,
                             cfg.grad_accum_steps)
        loop = TrainLoop(loss_fn, opt, train, (gen,), why_eager)
        for ep in range(epochs):
            t0 = time.time()
            clock = StepClock(device)
            student.train()
            row = {"stage": stage, "epoch": ep + 1,
                   "loss": loop.epoch(nprng, clock),
                   "ms_per_step": clock.ms_per_step()}
            if stage == 2:
                row.update(glue_metric(cfg.task, *student_dev()))
            row["time_s"] = time.time() - t0
            history.append(row)
            log(row)

    def stage1_loss(b):
        t = t_out(b)
        s = s_out(b)
        att, rep = attention_hidden_distill_loss(
            s["attentions"], t["attentions"], s["hidden_states"],
            t["hidden_states"])
        return att + rep

    def stage2_loss(b):
        t = t_out(b)
        s = s_out(b)
        if regression:
            return torch.mean((s["logits"].reshape(-1) - b["labels"]) ** 2)
        return soft_logits_loss(s["logits"], t["logits"], cfg.temperature)

    nprng = np.random.RandomState(cfg.seed + 3)
    run_stage(1, cfg.stage1_epochs, cfg.lr_stage1, stage1_loss, nprng)
    run_stage(2, cfg.stage2_epochs, cfg.lr_stage2, stage2_loss, nprng)
    return student, history, teacher
