"""The port's NLP data path and losses against the JAX package's `nlp/`,
on the same seeded inputs: factorization, tokenization, the synthetic
GLUE examples, the GLUE metrics, SQuAD's doc-stride features and n-best
predictions, and the masked-LM pregeneration, all equal exactly; the two
distillation losses within 1e-6 of their scale, with masked positions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import distill as jdistill
from dnn_compression_tensor_admm_tpu.nlp import factorization as jfact
from dnn_compression_tensor_admm_tpu.nlp import glue as jglue
from dnn_compression_tensor_admm_tpu.nlp import pregenerate as jpre
from dnn_compression_tensor_admm_tpu.nlp import squad as jsquad
from dnn_compression_tensor_admm_tpu.nlp import tokenization as jtok
from dnn_compression_tensor_admm_tpu_torch.nlp import distill as tdistill
from dnn_compression_tensor_admm_tpu_torch.nlp import factorization as tfact
from dnn_compression_tensor_admm_tpu_torch.nlp import glue as tglue
from dnn_compression_tensor_admm_tpu_torch.nlp import pregenerate as tpre
from dnn_compression_tensor_admm_tpu_torch.nlp import squad as tsquad
from dnn_compression_tensor_admm_tpu_torch.nlp import tokenization as ttok

SIZES = (7, 30, 64, 215, 256, 512, 768, 1000, 3072, 30522)


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_factorization_matches_jax(dim):
    for n in SIZES:
        assert tfact.get_factors(n) == jfact.get_factors(n)
        assert tfact.split_to_factors(n, dim) == jfact.split_to_factors(n, dim)
        for ratio in (1.5, 2.0, 4.5, 10.0):
            shapes = tfact.split_to_factors(n, dim) + [64, 48][:dim]
            assert (tfact.compute_ranks_tt(shapes, ratio)
                    == jfact.compute_ranks_tt(shapes, ratio))
            assert (tfact.compute_rank_svd(n, 768, ratio)
                    == jfact.compute_rank_svd(n, 768, ratio))
            if dim <= 3:
                t = tfact.tt_linear_spec_from_ratio(n, 3072, ratio, dim)
                j = jfact.tt_linear_spec_from_ratio(n, 3072, ratio, dim)
                assert dataclasses.astuple(t) == dataclasses.astuple(j)
                assert (tfact.svd_spec_from_ratio(n, 768, ratio).rank
                        == jfact.svd_spec_from_ratio(n, 768, ratio).rank)


TEXTS = ["Hello, World! It's a test-case.", "Ünïcödé Àccents façade naïve",
         "中文字符 mixed with ascii", "tabs\tand\nnewlines\r here",
         "[CLS] keeps [MASK] specials [SEP]", "x" * 120 + " tail",
         "unaffable unaffableness aff ##able", "w1 w2 k03 k14 ans7"]


def test_tokenization_matches_jax(tmp_path):
    assert (ttok.build_vocab_from_texts(TEXTS * 3, max_size=40)
            == jtok.build_vocab_from_texts(TEXTS * 3, max_size=40))
    vocab = jtok.build_vocab_from_texts(TEXTS)
    vocab.update({"##able": len(vocab), "##ness": len(vocab) + 1,
                  "un": len(vocab) + 2})
    path = tmp_path / "vocab.txt"
    path.write_text("".join(f"{w}\n" for w in vocab))
    assert ttok.load_vocab(str(path)) == jtok.load_vocab(str(path))
    for lower in (True, False):
        t = ttok.WordPieceTokenizer.from_file(str(path), lowercase=lower)
        j = jtok.WordPieceTokenizer.from_file(str(path), lowercase=lower)
        for a in TEXTS:
            assert t.tokenize(a) == j.tokenize(a)
            for b in (None, TEXTS[0], TEXTS[5]):
                for n in (8, 16, 64):
                    assert t.encode_pair(a, b, n) == j.encode_pair(a, b, n)


@pytest.mark.parametrize("task", sorted(jglue.PROCESSORS))
def test_synthetic_glue_examples_and_features_match_jax(task):
    ex_t = tglue.synthetic_examples(task, 40, seed=3)
    ex_j = jglue.synthetic_examples(task, 40, seed=3)
    assert [dataclasses.astuple(e) for e in ex_t] == \
        [dataclasses.astuple(e) for e in ex_j]
    proc = jglue.PROCESSORS[task]
    assert tglue.PROCESSORS[task].labels == proc.labels
    texts = [e.text_a for e in ex_j] + [e.text_b for e in ex_j if e.text_b]
    tok = jtok.WordPieceTokenizer(jtok.build_vocab_from_texts(texts))
    ft = tglue.convert_examples(ex_t, tok, 24, proc.labels, proc.regression)
    fj = jglue.convert_examples(ex_j, tok, 24, proc.labels, proc.regression)
    assert ft.keys() == fj.keys()
    for k in fj:
        assert ft[k].dtype == fj[k].dtype
        np.testing.assert_array_equal(ft[k], fj[k])


def test_glue_tsv_and_metrics_match_jax(tmp_path):
    rows = ["sentence\tlabel", "a good film\t1", "bad , bad\t0"]
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    for split in ("train", "dev"):
        if split == "dev":
            (tmp_path / "dev.tsv").write_text("\n".join(rows) + "\n")
        t = tglue.PROCESSORS["sst-2"].get_examples(str(tmp_path), split)
        j = jglue.PROCESSORS["sst-2"].get_examples(str(tmp_path), split)
        assert [dataclasses.astuple(e) for e in t] == \
            [dataclasses.astuple(e) for e in j]
    rng = np.random.RandomState(0)
    x = rng.randint(0, 5, 60).astype(np.float32)  # ties
    np.testing.assert_array_equal(tglue._rankdata(x), jglue._rankdata(x))
    for task in sorted(jglue.PROCESSORS):
        if jglue.PROCESSORS[task].regression:
            preds = rng.standard_normal(50).astype(np.float32)
            labels = rng.randint(0, 6, 50).astype(np.float32)
        else:
            n = len(jglue.PROCESSORS[task].labels)
            preds, labels = rng.randint(0, n, 50), rng.randint(0, n, 50)
        assert (tglue.glue_metric(task, preds, labels)
                == jglue.glue_metric(task, preds, labels))
    assert tglue.glue_metric("cola", np.zeros(4), np.zeros(4)) == \
        jglue.glue_metric("cola", np.zeros(4), np.zeros(4))


@pytest.mark.parametrize("seq,stride,words", [(32, 8, 60), (128, 64, 24),
                                              (24, 5, 40)])
def test_squad_features_and_predictions_match_jax(seq, stride, words):
    ex_t = tsquad.synthetic_squad(12, seed=1, context_words=words)
    ex_j = jsquad.synthetic_squad(12, seed=1, context_words=words)
    assert [dataclasses.astuple(e) for e in ex_t] == \
        [dataclasses.astuple(e) for e in ex_j]
    # answer_start on the separating space, as in real SQuAD rows
    ex_j[0] = dataclasses.replace(ex_j[0], answer_start=ex_j[0].answer_start - 1)
    ex_t[0] = dataclasses.replace(ex_t[0], answer_start=ex_t[0].answer_start - 1)
    texts = [e.question for e in ex_j] + [e.context for e in ex_j]
    tok = jtok.WordPieceTokenizer(jtok.build_vocab_from_texts(texts))
    f_t = tsquad.convert_squad_features(ex_t, tok, seq, stride)
    f_j = jsquad.convert_squad_features(ex_j, tok, seq, stride)
    assert [dataclasses.astuple(f) for f in f_t] == \
        [dataclasses.astuple(f) for f in f_j]
    if words > 40:
        assert len(f_j) > len(ex_j)  # the doc-stride windows are exercised
    a_t, a_j = tsquad.features_to_arrays(f_t), jsquad.features_to_arrays(f_j)
    for k in a_j:
        np.testing.assert_array_equal(a_t[k], a_j[k])
    rng = np.random.RandomState(2)
    sl = rng.standard_normal((len(f_j), seq)).astype(np.float32)
    el = rng.standard_normal((len(f_j), seq)).astype(np.float32)
    for n_best, max_len in ((20, 30), (3, 2)):
        p_t = tsquad.compute_predictions(ex_t, f_t, sl, el, n_best, max_len)
        p_j = jsquad.compute_predictions(ex_j, f_j, sl, el, n_best, max_len)
        assert p_t == p_j
    for i, ex in enumerate(ex_j):
        text = p_j[i]["text"]
        assert (tsquad.exact_match_score(text, ex.answer_text)
                == jsquad.exact_match_score(text, ex.answer_text))
        assert (tsquad.f1_score(text, ex.answer_text)
                == jsquad.f1_score(text, ex.answer_text))
    for p, g in (("The Cat!", "cat"), ("a b c", "b c d"), ("", ""), ("x", "")):
        assert tsquad.f1_score(p, g) == jsquad.f1_score(p, g)
        assert tsquad.normalize_answer(p) == jsquad.normalize_answer(p)


def test_squad_json_reader_matches_jax(tmp_path):
    import json
    data = {"data": [{"paragraphs": [{"context": "one two three four", "qas": [
        {"question": "q1", "answers": [{"text": "two", "answer_start": 4}]},
        {"question": "q2", "answers": [], "is_impossible": True},
        {"question": "q3", "answers": []}]}]}]}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(data))
    assert ([dataclasses.astuple(e) for e in tsquad.load_squad_json(str(path))]
            == [dataclasses.astuple(e)
                for e in jsquad.load_squad_json(str(path))])


@pytest.mark.parametrize("seq,seed", [(32, 0), (16, 5)])
def test_mlm_pregeneration_matches_jax(seq, seed):
    assert tpre.synthetic_corpus(20, seed) == jpre.synthetic_corpus(20, seed)
    texts = jpre.synthetic_corpus(30, seed)
    t = tpre.pregenerate_mlm_examples(texts, max_seq_length=seq, seed=seed)
    j = jpre.pregenerate_mlm_examples(texts, max_seq_length=seq, seed=seed)
    assert t.keys() == j.keys()
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1e-30, np.max(np.abs(b))))


@pytest.mark.parametrize("ns,nt", [(2, 2), (2, 4), (3, 6)])
def test_attention_hidden_distill_loss_matches_jax(ns, nt):
    rng = np.random.RandomState(ns * 10 + nt)
    b, h, n, d = 3, 4, 10, 16
    mask = np.ones((b, n), np.float32)
    mask[0, 7:] = 0
    mask[2, 3:] = 0
    add = (1.0 - mask[:, None, None, :]) * -1e9

    def atts(k):
        return [(rng.standard_normal((b, h, n, n)) + add).astype(np.float32)
                for _ in range(k)]

    def reps(k):
        return [rng.standard_normal((b, n, d)).astype(np.float32)
                for _ in range(k + 1)]

    sa, ta, sr, tr = atts(ns), atts(nt), reps(ns), reps(nt)
    got = tdistill.attention_hidden_distill_loss(
        *[[torch.from_numpy(x) for x in xs] for xs in (sa, ta, sr, tr)])
    want = jdistill.attention_hidden_distill_loss(
        *[[jnp.asarray(x) for x in xs] for xs in (sa, ta, sr, tr)])
    for g, w in zip(got, want):
        assert _rel(g.item(), w) <= 1e-6
    # the masked scores (-1e9) weigh nothing once zeroed
    assert float(want[0]) < 10


@pytest.mark.parametrize("temperature", [1.0, 2.0, 0.5])
def test_soft_logits_loss_matches_jax(temperature):
    rng = np.random.RandomState(7)
    s = (3 * rng.standard_normal((16, 3))).astype(np.float32)
    t = (3 * rng.standard_normal((16, 3))).astype(np.float32)
    got = tdistill.soft_logits_loss(torch.from_numpy(s), torch.from_numpy(t),
                                    temperature).item()
    want = float(jdistill.soft_logits_loss(jnp.asarray(s), jnp.asarray(t),
                                           temperature))
    assert _rel(got, want) <= 1e-6
