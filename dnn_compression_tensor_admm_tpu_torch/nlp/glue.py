"""GLUE task processors, feature conversion and metrics (a copy of the JAX
package's `nlp/glue.py`: the same synthetic examples from the same seed;
the role of the reference's task_distill.py:115-445 processors and do_eval metrics).

Each processor reads the standard GLUE TSV layout from `data_dir`; when
no data directory is given a deterministic synthetic corpus with a
learnable label rule is generated so the full distillation pipeline can
run offline (zero-download environments)."""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class InputExample:
    text_a: str
    text_b: Optional[str]
    label: str


class _Processor:
    name = ""
    labels: List[Optional[str]] = []
    pair = False
    metric = "acc"
    regression = False   # STS-B: float labels, 1-logit head, MSE
    dev_file = "dev.tsv"  # MNLI splits override (dev_matched/dev_mismatched)

    # column layout: (text_a_idx, text_b_idx, label_idx, skip_header)
    train_cols: Tuple = (0, None, 1, True)
    dev_cols: Tuple = (0, None, 1, True)

    def _read(self, path, cols):
        a_i, b_i, l_i, skip = cols
        out = []
        with open(path, encoding="utf-8") as f:
            reader = csv.reader(f, delimiter="\t", quotechar=None)
            for i, row in enumerate(reader):
                if skip and i == 0:
                    continue
                out.append(InputExample(
                    text_a=row[a_i],
                    text_b=row[b_i] if b_i is not None else None,
                    label=row[l_i]))
        return out

    def get_examples(self, data_dir, split):
        fname = "train.tsv" if split == "train" else self.dev_file
        path = os.path.join(data_dir, fname)
        return self._read(path, self.train_cols if split == "train" else self.dev_cols)


class Sst2Processor(_Processor):
    name = "sst-2"; labels = ["0", "1"]
    train_cols = (0, None, 1, True); dev_cols = (0, None, 1, True)


class MrpcProcessor(_Processor):
    name = "mrpc"; labels = ["0", "1"]; pair = True; metric = "f1"
    train_cols = (3, 4, 0, True); dev_cols = (3, 4, 0, True)


class QnliProcessor(_Processor):
    name = "qnli"; labels = ["entailment", "not_entailment"]; pair = True
    train_cols = (1, 2, 3, True); dev_cols = (1, 2, 3, True)


class RteProcessor(_Processor):
    name = "rte"; labels = ["entailment", "not_entailment"]; pair = True
    train_cols = (1, 2, 3, True); dev_cols = (1, 2, 3, True)


class QqpProcessor(_Processor):
    name = "qqp"; labels = ["0", "1"]; pair = True; metric = "f1"
    train_cols = (3, 4, 5, True); dev_cols = (3, 4, 5, True)


class MnliProcessor(_Processor):
    name = "mnli"; labels = ["contradiction", "entailment", "neutral"]; pair = True
    train_cols = (8, 9, 11, True); dev_cols = (8, 9, 15, True)
    dev_file = "dev_matched.tsv"  # reference task_distill.py:159-162


class MnliMismatchedProcessor(MnliProcessor):
    # reference task_distill.py:188-196: same columns/labels as MNLI,
    # dev split read from dev_mismatched.tsv
    name = "mnli-mm"
    dev_file = "dev_mismatched.tsv"


class ColaProcessor(_Processor):
    name = "cola"; labels = ["0", "1"]; metric = "mcc"
    train_cols = (3, None, 1, False); dev_cols = (3, None, 1, False)


class StsbProcessor(_Processor):
    # reference task_distill.py:266-301: regression task (get_labels() ->
    # [None]), text cols 7/8, float label in the last column, scored by
    # pearson/spearman (task_distill.py:554-573)
    name = "sts-b"; labels = [None]; pair = True
    metric = "corr"; regression = True
    train_cols = (7, 8, -1, True); dev_cols = (7, 8, -1, True)


class WnliProcessor(_Processor):
    # reference task_distill.py:414-445: text cols 1/2, label last
    name = "wnli"; labels = ["0", "1"]; pair = True
    train_cols = (1, 2, -1, True); dev_cols = (1, 2, -1, True)


PROCESSORS = {p.name: p for p in
              (Sst2Processor(), MrpcProcessor(), QnliProcessor(),
               RteProcessor(), QqpProcessor(), MnliProcessor(),
               MnliMismatchedProcessor(), ColaProcessor(),
               StsbProcessor(), WnliProcessor())}


def synthetic_examples(task: str, n: int, seed: int = 0) -> List[InputExample]:
    """Deterministic learnable synthetic text: classification labels are
    decided by which keyword set dominates the sentence; the regression
    label (STS-B) is the number of keywords text_b copies from text_a,
    scaled to the task's 0-5 similarity range."""
    proc = PROCESSORS[task]
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(200)]
    out = []
    if proc.regression:
        # similarity = number of shared marker tokens in both sentences
        # (a bag-of-words-learnable count, so a toy-scale student can
        # demonstrably fit it in the test suite)
        for _ in range(n):
            overlap = int(rng.randint(0, 6))
            a_words = ["simtok"] * overlap + list(
                rng.choice(words, size=10 - overlap))
            b_words = ["simtok"] * overlap + list(
                rng.choice(words, size=10 - overlap))
            rng.shuffle(a_words); rng.shuffle(b_words)
            out.append(InputExample(" ".join(a_words), " ".join(b_words),
                                    str(float(overlap))))
        return out
    keys = [[f"k{l}{j}" for j in range(5)] for l in range(len(proc.labels))]
    for _ in range(n):
        li = int(rng.randint(len(proc.labels)))
        body = list(rng.choice(words, size=8)) + list(
            rng.choice(keys[li], size=3))
        rng.shuffle(body)
        a = " ".join(body)
        b = " ".join(rng.choice(words, size=6)) if proc.pair else None
        out.append(InputExample(a, b, proc.labels[li]))
    return out


def convert_examples(examples, tokenizer, max_len: int, labels: List[str],
                     regression: bool = False):
    """-> dict of int32 arrays: input_ids, attention_mask, token_type_ids,
    labels (float32 for regression — reference task_distill.py:495-504)."""
    lab2id = {l: i for i, l in enumerate(labels)}
    ids, masks, types, ys = [], [], [], []
    for ex in examples:
        i, m, t = tokenizer.encode_pair(ex.text_a, ex.text_b, max_len)
        ids.append(i); masks.append(m); types.append(t)
        ys.append(float(ex.label) if regression else lab2id[ex.label])
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
            "token_type_ids": np.asarray(types, np.int32),
            "labels": np.asarray(ys, np.float32 if regression else np.int32)}


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties shared), the Spearman prerequisite."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def pearson_and_spearman(preds: np.ndarray, labels: np.ndarray) -> dict:
    """STS-B correlation metrics (reference task_distill.py:554-560),
    NumPy-only (no scipy dependency)."""
    p = np.corrcoef(preds.astype(np.float64), labels.astype(np.float64))[0, 1]
    s = np.corrcoef(_rankdata(preds), _rankdata(labels))[0, 1]
    return {"pearson": float(p), "spearmanr": float(s),
            "corr": float((p + s) / 2)}


def glue_metric(task: str, preds: np.ndarray, labels: np.ndarray) -> dict:
    metric = PROCESSORS[task].metric
    if metric == "corr":
        return pearson_and_spearman(preds, labels)
    acc = float((preds == labels).mean())
    out = {"acc": acc}
    if metric == "f1":
        tp = float(((preds == 1) & (labels == 1)).sum())
        fp = float(((preds == 1) & (labels == 0)).sum())
        fn = float(((preds == 0) & (labels == 1)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        out["f1"] = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    elif metric == "mcc":
        tp = float(((preds == 1) & (labels == 1)).sum())
        tn = float(((preds == 0) & (labels == 0)).sum())
        fp = float(((preds == 1) & (labels == 0)).sum())
        fn = float(((preds == 0) & (labels == 1)).sum())
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        out["mcc"] = (tp * tn - fp * fn) / denom if denom else 0.0
    return out
