"""SQuAD-style extractive QA (counterpart of the JAX package's
`nlp/squad.py`; the reference's xcompression/run_squad.py:514):
doc-stride window features, span fine-tuning of a (compressed) BERT,
n-best span decoding with the max-answer-length filter, normalized EM/F1,
and `predictions.json` / `nbest_predictions.json`.

The feature conversion, the decoding and the metrics are a copy of the
JAX package's numpy code (the port may not import it): long contexts are
covered by overlapping windows, each token's prediction comes from the
window where it has the most context, and an example's answers gather
(start_logit + end_logit) scores over all its windows.

The train step and the dev forward are replayed from CUDA graphs on the
card and run eagerly on the CPU (`nlp/steps.py`); the dev set's last
batch is padded by repeating its last row, as the JAX package pads it for
its one compiled `predict`, and the padding's logits are dropped.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import string
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.precision import full_f32
from ..utils.device import resolve_device
from .bert import BertCompressionPlan, BertConfig, BertForQuestionAnswering
from .steps import DeviceBatches, EvalLoop, StepClock, TrainLoop, route
from .task_distill import make_bert_adam, to_device
from .tokenization import WordPieceTokenizer, build_vocab_from_texts


@dataclasses.dataclass
class SquadExample:
    question: str
    context: str
    answer_text: str
    answer_start: int  # char offset into context


@dataclasses.dataclass
class SquadFeature:
    """One doc-stride window of one example."""
    example_index: int
    input_ids: List[int]
    attention_mask: List[int]
    token_type_ids: List[int]
    start_position: int      # token index in input (0 = [CLS] = not-in-window)
    end_position: int
    ctx_base: int            # input index of the first context token
    window_words: List[int]  # context-word index per window context token
    is_max_context: List[bool]  # per window context token


def load_squad_json(path: str) -> List[SquadExample]:
    with open(path) as f:
        data = json.load(f)["data"]
    out = []
    for art in data:
        for para in art["paragraphs"]:
            ctx = para["context"]
            for qa in para["qas"]:
                if qa.get("is_impossible"):
                    continue
                if not qa["answers"]:
                    continue
                a = qa["answers"][0]
                out.append(SquadExample(qa["question"], ctx, a["text"],
                                        a["answer_start"]))
    return out


def synthetic_squad(n: int = 64, seed: int = 0,
                    context_words: int = 24) -> List[SquadExample]:
    """Deterministic QA corpus: the question names a unique marker token
    placed somewhere in the context. With `context_words` larger than one
    window's capacity this exercises the doc-stride path."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(100)]
    out = []
    for _ in range(n):
        ctx_words = list(rng.choice(words, size=context_words))
        ans_pos = int(rng.randint(context_words // 6, context_words - 4))
        answer = f"ans{rng.randint(10)}"
        ctx_words[ans_pos] = answer
        context = " ".join(ctx_words)
        start = len(" ".join(ctx_words[:ans_pos])) + (1 if ans_pos else 0)
        out.append(SquadExample(f"find {answer}", context, answer, start))
    return out


def _answer_word_span(ex: SquadExample) -> Tuple[Optional[int], Optional[int]]:
    """Char-offset answer -> inclusive [word_start, word_end] indices."""
    words = ex.context.split(" ")
    offsets, pos = [], 0
    for w in words:
        offsets.append(pos)
        pos += len(w) + 1
    def find(start):
        s0 = s1 = None
        a_end = start + len(ex.answer_text)
        for wi, off in enumerate(offsets):
            span_end = off + len(words[wi])
            if s0 is None and off <= start < span_end:
                s0 = wi
            if off < a_end <= span_end:
                s1 = wi
        return s0, s1

    w0, w1 = find(ex.answer_start)
    if w0 is None:
        # annotation noise: answer_start pointing at the separating space
        # before the answer (common in real SQuAD rows) — retry one char in
        w0, w1 = find(ex.answer_start + 1)
    if w0 is not None and w1 is None:
        w1 = w0
    return w0, w1


def convert_squad_features(examples: List[SquadExample],
                           tok: WordPieceTokenizer,
                           max_seq_length: int = 128,
                           doc_stride: int = 64,
                           max_query_length: int = 24
                           ) -> List[SquadFeature]:
    """Sliding-window feature conversion (HF squad features semantics,
    used by the reference at run_squad.py:485-499): windows of the
    tokenized context advance by `doc_stride`; each context token's
    `is_max_context` marks the window where it sits most centrally, so
    overlapping windows never produce duplicate predictions."""
    features = []
    for ei, ex in enumerate(examples):
        q_toks = tok.tokenize(ex.question)[:max_query_length]
        ctx_words = ex.context.split(" ")
        c_toks, tok2word = [], []
        for wi, w in enumerate(ctx_words):
            for t in tok.tokenize(w):
                c_toks.append(t)
                tok2word.append(wi)
        ans_w0, ans_w1 = _answer_word_span(ex)
        # token span of the answer (all subtokens of the answer words)
        ans_t0 = ans_t1 = None
        if ans_w0 is not None:
            tp = [i for i, wi in enumerate(tok2word) if ans_w0 <= wi <= ans_w1]
            if tp:
                ans_t0, ans_t1 = tp[0], tp[-1]

        max_ctx = max_seq_length - len(q_toks) - 3
        if max_ctx < 1:
            raise ValueError(
                f"max_seq_length={max_seq_length} leaves no room for "
                f"context after a {len(q_toks)}-token question (+3 "
                f"specials); raise max_seq_length or lower "
                f"max_query_length")
        # doc spans (HF: start advances by doc_stride until coverage)
        spans = []
        start = 0
        while True:
            length = min(max_ctx, len(c_toks) - start)
            spans.append((start, length))
            if start + length >= len(c_toks):
                break
            start += min(doc_stride, length)

        for si, (s0, length) in enumerate(spans):
            win_toks = c_toks[s0:s0 + length]
            win_words = tok2word[s0:s0 + length]
            # max-context rule (HF _check_is_max_context): token t belongs
            # to the span maximizing min(left_ctx, right_ctx) + 0.01*len
            is_max = []
            for k in range(length):
                t = s0 + k
                best, best_si = None, None
                for sj, (t0, ln) in enumerate(spans):
                    if not (t0 <= t < t0 + ln):
                        continue
                    left = t - t0
                    right = t0 + ln - 1 - t
                    score = min(left, right) + 0.01 * ln
                    if best is None or score > best:
                        best, best_si = score, sj
                is_max.append(best_si == si)
            tokens = ["[CLS]"] + q_toks + ["[SEP]"] + win_toks + ["[SEP]"]
            types = [0] * (len(q_toks) + 2) + [1] * (len(win_toks) + 1)
            ids = tok.convert_tokens_to_ids(tokens)
            mask = [1] * len(ids)
            pad = max_seq_length - len(ids)
            ids += [tok.vocab["[PAD]"]] * pad
            mask += [0] * pad
            types += [0] * pad
            ctx_base = len(q_toks) + 2
            start_pos = end_pos = 0  # [CLS]: answer not in this window
            if ans_t0 is not None and s0 <= ans_t0 and ans_t1 < s0 + length:
                start_pos = ctx_base + ans_t0 - s0
                end_pos = ctx_base + ans_t1 - s0
            features.append(SquadFeature(
                example_index=ei, input_ids=ids, attention_mask=mask,
                token_type_ids=types, start_position=start_pos,
                end_position=end_pos, ctx_base=ctx_base,
                window_words=win_words, is_max_context=is_max))
    return features


def features_to_arrays(features: List[SquadFeature]) -> Dict[str, np.ndarray]:
    return {
        "input_ids": np.asarray([f.input_ids for f in features], np.int32),
        "attention_mask": np.asarray([f.attention_mask for f in features], np.int32),
        "token_type_ids": np.asarray([f.token_type_ids for f in features], np.int32),
        "start_positions": np.asarray([f.start_position for f in features], np.int32),
        "end_positions": np.asarray([f.end_position for f in features], np.int32),
    }


def convert_squad(examples: List[SquadExample], tok: WordPieceTokenizer,
                  max_seq_length: int = 128,
                  doc_stride: int = 64) -> Dict[str, np.ndarray]:
    """Array view of the doc-stride features (training input)."""
    return features_to_arrays(convert_squad_features(
        examples, tok, max_seq_length, doc_stride))


def _top_indexes(logits: np.ndarray, n: int) -> List[int]:
    return list(np.argsort(logits)[::-1][:n])


def compute_predictions(examples: List[SquadExample],
                        features: List[SquadFeature],
                        start_logits: np.ndarray, end_logits: np.ndarray,
                        n_best_size: int = 20,
                        max_answer_length: int = 30) -> Dict[int, dict]:
    """Aggregate window logits into per-example n-best answers (the
    reference's compute_predictions_logits, run_squad.py:415-429):
    candidate spans score start_logit+end_logit, must start at a
    max-context token, lie inside one window's context, keep
    end >= start and length <= max_answer_length."""
    by_example = collections.defaultdict(list)
    for fi, f in enumerate(features):
        by_example[f.example_index].append(fi)
    out = {}
    for ei, ex in enumerate(examples):
        prelim = []
        for fi in by_example.get(ei, ()):
            f = features[fi]
            n_ctx = len(f.window_words)
            sl, el = start_logits[fi], end_logits[fi]
            for si in _top_indexes(sl, n_best_size):
                if not (f.ctx_base <= si < f.ctx_base + n_ctx):
                    continue
                if not f.is_max_context[si - f.ctx_base]:
                    continue
                for eix in _top_indexes(el, n_best_size):
                    if not (f.ctx_base <= eix < f.ctx_base + n_ctx):
                        continue
                    if eix < si or eix - si + 1 > max_answer_length:
                        continue
                    prelim.append((float(sl[si] + el[eix]), fi, si, eix))
        prelim.sort(key=lambda t: -t[0])
        ctx_words = ex.context.split(" ")
        nbest, seen = [], set()
        for score, fi, si, eix in prelim[:n_best_size]:
            f = features[fi]
            w0 = f.window_words[si - f.ctx_base]
            w1 = f.window_words[eix - f.ctx_base]
            text = " ".join(ctx_words[w0:w1 + 1])
            if text in seen:
                continue
            seen.add(text)
            nbest.append({"text": text, "score": score})
        out[ei] = {"text": nbest[0]["text"] if nbest else "",
                   "nbest": nbest}
    return out


# --- normalized EM/F1 (HF squad_metrics semantics) -----------------------

def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match_score(pred: str, gold: str) -> float:
    return float(normalize_answer(pred) == normalize_answer(gold))


def f1_score(pred: str, gold: str) -> float:
    p_toks = normalize_answer(pred).split()
    g_toks = normalize_answer(gold).split()
    common = collections.Counter(p_toks) & collections.Counter(g_toks)
    n_same = sum(common.values())
    if not p_toks or not g_toks:
        return float(p_toks == g_toks)
    if n_same == 0:
        return 0.0
    prec = n_same / len(p_toks)
    rec = n_same / len(g_toks)
    return 2 * prec * rec / (prec + rec)


def span_loss(start_logits, end_logits, start_pos, end_pos):
    """Mean of the start and end positions' cross-entropies."""
    def ce(logits, pos):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(logp.gather(1, pos[:, None])[:, 0])
    return 0.5 * (ce(start_logits, start_pos) + ce(end_logits, end_pos))


@dataclasses.dataclass
class SquadConfig:
    max_seq_length: int = 128
    doc_stride: int = 64          # reference run_squad.py:617
    n_best_size: int = 20         # reference run_squad.py:663
    max_answer_length: int = 30   # reference run_squad.py:669
    batch_size: int = 16
    epochs: int = 2
    lr: float = 5e-4
    seed: int = 0
    n_synthetic: int = 128
    synthetic_context_words: int = 24
    output_dir: Optional[str] = None  # predictions.json and
                                      # nbest_predictions.json
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    plan: Optional[BertCompressionPlan] = None
    device: str = "cuda"
    print_fn: Callable = print


def squad_data(cfg: SquadConfig, train_path: Optional[str] = None,
               dev_path: Optional[str] = None):
    """(train examples, dev examples, train features, dev features,
    tokenizer), from the files or the synthetic corpus."""
    if train_path:
        train_ex = load_squad_json(train_path)
        dev_ex = load_squad_json(dev_path or train_path)
    else:
        train_ex = synthetic_squad(cfg.n_synthetic, cfg.seed,
                                   cfg.synthetic_context_words)
        dev_ex = synthetic_squad(cfg.n_synthetic // 4, cfg.seed + 1,
                                 cfg.synthetic_context_words)
    texts = [e.question for e in train_ex] + [e.context for e in train_ex]
    tok = WordPieceTokenizer(build_vocab_from_texts(texts))
    train_feats = convert_squad_features(train_ex, tok, cfg.max_seq_length,
                                         cfg.doc_stride)
    dev_feats = convert_squad_features(dev_ex, tok, cfg.max_seq_length,
                                       cfg.doc_stride)
    return train_ex, dev_ex, train_feats, dev_feats, tok


def write_predictions(output_dir: str, preds: Dict[int, dict]) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "predictions.json"), "w") as fh:
        json.dump({str(i): preds[i]["text"] for i in preds}, fh, indent=1)
    with open(os.path.join(output_dir, "nbest_predictions.json"), "w") as fh:
        json.dump({str(i): preds[i]["nbest"] for i in preds}, fh, indent=1)


def padded_order(n: int, batch: int) -> np.ndarray:
    """0..n-1, then the last row repeated up to a whole batch."""
    steps = -(-n // batch)
    return np.minimum(np.arange(steps * batch), n - 1)


@full_f32()
def run_squad(cfg: SquadConfig, train_path: Optional[str] = None,
              dev_path: Optional[str] = None, eager: bool = False):
    """Fine-tune a (compressed) BERT for extractive QA over doc-stride
    windows -> (model, history with normalized EM/F1). `eager`: the eager
    reference loop, never captured."""
    log = cfg.print_fn
    device = resolve_device(cfg.device)
    train_ex, dev_ex, train_feats, dev_feats, tok = squad_data(
        cfg, train_path, dev_path)
    train_np = features_to_arrays(train_feats)
    dev_np = features_to_arrays(dev_feats)
    bert_cfg = dataclasses.replace(cfg.bert, vocab_size=len(tok.vocab))
    model = BertForQuestionAnswering(
        bert_cfg, cfg.plan, generator=torch.Generator().manual_seed(cfg.seed))
    model.to(device)
    train = DeviceBatches(to_device(train_np, device), cfg.batch_size)
    n, bs = train.n, cfg.batch_size
    n_dev = len(dev_np["input_ids"])
    dev_order = padded_order(n_dev, bs)
    dev = DeviceBatches(to_device(dev_np, device), bs, n=len(dev_order))
    opt = make_bert_adam(model, cfg.lr, max(1, n // bs) * cfg.epochs, 0.1)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    why_eager = route(device, eager, log)

    def loss_fn(b):
        out = model(b["input_ids"], b["attention_mask"],
                    b["token_type_ids"], generator=gen)
        return span_loss(out["start_logits"], out["end_logits"],
                         b["start_positions"], b["end_positions"])

    def logits(b):
        out = model(b["input_ids"], b["attention_mask"], b["token_type_ids"])
        return {"start": out["start_logits"], "end": out["end_logits"]}

    loop = TrainLoop(loss_fn, opt, train, (gen,), why_eager)
    predict = EvalLoop(model, logits, dev, why_eager)
    nprng = np.random.RandomState(cfg.seed)
    history, preds = [], {}
    for ep in range(cfg.epochs):
        t0 = time.time()
        clock = StepClock(device)
        model.train()
        loss = loop.epoch(nprng, clock)
        ms = clock.ms_per_step()
        out = predict.run(dev_order)
        preds = compute_predictions(dev_ex, dev_feats, out["start"][:n_dev],
                                    out["end"][:n_dev], cfg.n_best_size,
                                    cfg.max_answer_length)
        em = np.mean([exact_match_score(preds[i]["text"], ex.answer_text)
                      for i, ex in enumerate(dev_ex)])
        f1 = np.mean([f1_score(preds[i]["text"], ex.answer_text)
                      for i, ex in enumerate(dev_ex)])
        row = {"epoch": ep + 1, "loss": loss,
               "exact_match": float(em), "f1": float(f1),
               "ms_per_step": ms, "time_s": time.time() - t0}
        history.append(row)
        log(row)
    if cfg.output_dir:
        write_predictions(cfg.output_dir, preds)
    return model, history
