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
Each history row carries `ms_per_step`: wall time a step after the
epoch's first (warm-up) step, the device synchronised at both ends.
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


def batches(data: Dict[str, torch.Tensor], batch: int,
            rng: np.random.RandomState):
    """One pass in the order of `rng.permutation`, the last partial batch
    dropped (the JAX package's `_batches`)."""
    n = len(data["labels"])
    order = rng.permutation(n)
    device = data["labels"].device
    for i in range(0, n - batch + 1, batch):
        idx = torch.as_tensor(order[i:i + batch], device=device)
        yield {k: v[idx] for k, v in data.items()}


class StepClock:
    """Wall ms a step after the first one, the device synchronised."""

    def __init__(self, device: torch.device):
        self.device, self.n, self.t0 = device, 0, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self) -> None:
        self.n += 1
        if self.n == 1:
            self._sync()
            self.t0 = time.perf_counter()

    def ms_per_step(self) -> Optional[float]:
        if self.n < 2:
            return None
        self._sync()
        return (time.perf_counter() - self.t0) * 1e3 / (self.n - 1)


def mean_loss(losses) -> float:
    return float(torch.stack(losses).mean(dtype=torch.float64))


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


def _predict(model, data, batch: int, regression: bool):
    preds, labels = [], []
    model.eval()
    with torch.no_grad():
        for b in batches(data, batch, np.random.RandomState(0)):
            logits = model(b["input_ids"], b["attention_mask"],
                           b["token_type_ids"])["logits"]
            preds.append(logits.reshape(-1) if regression
                         else logits.argmax(-1))
            labels.append(b["labels"])
    return (torch.cat(preds).cpu().numpy(), torch.cat(labels).cpu().numpy())


@full_f32()
def run_task_distillation(cfg: DistillConfig,
                          teacher_state: Optional[Dict[str, torch.Tensor]] = None):
    """-> (student, history, teacher). `teacher_state`: a fine-tuned dense
    teacher's state dict; without one a teacher is fine-tuned on the task
    first."""
    log = cfg.print_fn
    device = resolve_device(cfg.device)
    train_np, dev_np, tok, proc = prepare_task_data(cfg)
    vocab_size = max(len(tok.vocab), int(train_np["input_ids"].max()) + 1)
    regression = proc.regression
    n_labels = 1 if regression else len(proc.labels)
    teacher, student = task_models(cfg, vocab_size, n_labels)
    teacher.to(device)
    student.to(device)
    train, dev = to_device(train_np, device), to_device(dev_np, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    n_batches = max(1, len(train_np["labels"]) // cfg.batch_size)

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
        opt = make_bert_adam(teacher, cfg.teacher_lr,
                             n_batches * cfg.teacher_epochs, cfg.warmup_frac)
        nprng = np.random.RandomState(cfg.seed)
        clock = StepClock(device)
        teacher.train()
        for _ in range(cfg.teacher_epochs):
            for b in batches(train, cfg.batch_size, nprng):
                logits = teacher(b["input_ids"], b["attention_mask"],
                                 b["token_type_ids"], generator=gen)["logits"]
                loss = (torch.mean((logits.reshape(-1) - b["labels"]) ** 2)
                        if regression else F.cross_entropy(logits, b["labels"]))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                clock.tick()
        if clock.n:
            last = float(loss.detach())
            teacher_row = {"finetune_loss": last,
                           "finetune_ms_per_step": clock.ms_per_step()}
            log(f"teacher fine-tuned, last loss {last:.4f}")
    teacher.eval()

    # the teacher's dev score: the baseline the student is judged against
    trow = {"stage": 0, "teacher": True, **teacher_row,
            **glue_metric(cfg.task, *_predict(teacher, dev, cfg.batch_size,
                                               regression))}
    history.append(trow)
    log(trow)

    def run_stage(stage, epochs, lr, loss_fn, nprng):
        steps = max(1, n_batches * epochs // cfg.grad_accum_steps)
        opt = make_bert_adam(student, lr, steps, cfg.warmup_frac,
                             cfg.grad_accum_steps)
        for ep in range(epochs):
            t0 = time.time()
            clock = StepClock(device)
            losses = []
            student.train()
            for b in batches(train, cfg.batch_size, nprng):
                loss = loss_fn(b)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
                clock.tick()
            row = {"stage": stage, "epoch": ep + 1, "loss": mean_loss(losses),
                   "ms_per_step": clock.ms_per_step()}
            if stage == 2:
                row.update(glue_metric(cfg.task, *_predict(
                    student, dev, cfg.batch_size, regression)))
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
