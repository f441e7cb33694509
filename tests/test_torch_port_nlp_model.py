"""The port's BERT and its factorized layers against the JAX package's
`nlp/`, on weights made from a numpy seed (shapes from `jax.eval_shape`,
nothing initialised by JAX) and carried by `utils/jax_weights.py`: each
embedding and TTM layer, BertForSequenceClassification and
BertForQuestionAnswering dense and under the tt / svd linears x svd / tt
/ ket / ketxs embeddings with padded rows (logits, every layer's
pre-softmax scores with the masked entries zeroed, every hidden state),
the shared Tucker encoder; all within 1e-5 of their scale. Then the
committed JAX student `results/nlp_r05/sst2_student.msgpack` read by the
port, whose dev logits match the JAX forward's, written back byte for
byte; and the parameter counts at BERT-base width, exact, the JAX side
by `jax.eval_shape` and the port's on the meta device."""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dnn_compression_tensor_admm_tpu.models.decompose import count_params as jax_count
from dnn_compression_tensor_admm_tpu.nlp import bert as jb
from dnn_compression_tensor_admm_tpu.nlp import ket_embedding as jket
from dnn_compression_tensor_admm_tpu.nlp import shared_tucker as jst
from dnn_compression_tensor_admm_tpu.nlp import svd_embedding as jsvd
from dnn_compression_tensor_admm_tpu.nlp import tt_embedding as jtt
from dnn_compression_tensor_admm_tpu.nlp import ttm_layers as jttm
from dnn_compression_tensor_admm_tpu.nlp.general_distill import (
    GeneralDistillConfig as JGeneralConfig)
from dnn_compression_tensor_admm_tpu.nlp.pregenerate import synthetic_corpus
from dnn_compression_tensor_admm_tpu.nlp.squad import (
    SquadConfig as JSquadConfig, synthetic_squad)
from dnn_compression_tensor_admm_tpu.nlp.task_distill import (
    DistillConfig as JDistillConfig, prepare_task_data as j_prepare)
from dnn_compression_tensor_admm_tpu.nlp.tokenization import build_vocab_from_texts
from dnn_compression_tensor_admm_tpu.utils import load_variables as jax_load
from dnn_compression_tensor_admm_tpu_torch.models.decompose import count_params
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import cli as tcli
from dnn_compression_tensor_admm_tpu_torch.nlp import ket_embedding as tket
from dnn_compression_tensor_admm_tpu_torch.nlp import shared_tucker as tst
from dnn_compression_tensor_admm_tpu_torch.nlp import svd_embedding as tsvd
from dnn_compression_tensor_admm_tpu_torch.nlp import tt_embedding as ttt
from dnn_compression_tensor_admm_tpu_torch.nlp import ttm_layers as tttm
from dnn_compression_tensor_admm_tpu_torch.nlp.task_distill import task_models
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import load_variables
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5  # of each output's scale


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(module, rng, *args, **kw):
    """Variables of `module`'s shapes (by `jax.eval_shape`, no JAX init),
    filled from the numpy generator: LayerNorm scales near 1, small
    biases, other leaves at flax's xavier scale."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        elif name == "bias":
            a = 0.02 * rng.standard_normal(s.shape)
        else:
            field = math.prod(s.shape[:-2])
            a = rng.standard_normal(s.shape) * math.sqrt(
                2.0 / ((s.shape[-2] + s.shape[-1]) * field))
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got.detach().double().numpy() - want))
                 / max(1e-30, np.max(np.abs(want))))


def load(module: torch.nn.Module, variables):
    module.load_state_dict(jax_to_state_dict(variables))
    return module.eval()


IDS = np.random.RandomState(11).randint(0, 120, (2, 5, 3)).astype(np.int32)


@pytest.mark.parametrize("case", ["svd", "tt_shapes", "tt_auto", "ket",
                                  "ketxs", "ttm_embedding", "ttm_linear"])
def test_embedding_and_ttm_layers_match_jax(case):
    rng = np.random.RandomState(3)
    ids = IDS
    full = None
    if case == "svd":
        j = jsvd.SVDEmbedding(120, 24, compression_ratio=4.0)
        t = tsvd.SVDEmbedding(120, 24, compression_ratio=4.0)
    elif case == "tt_shapes":
        j = jtt.TTEmbedding(120, 16, input_tt_shape=(5, 4, 6),
                            output_tt_shape=(4, 4), tt_ranks=(1, 4, 4, 4, 4, 1))
        t = ttt.TTEmbedding(120, 16, (5, 4, 6), (4, 4), (1, 4, 4, 4, 4, 1))
    elif case == "tt_auto":
        j = jtt.TTEmbedding(215, 64, compression_ratio=4.5)
        t = ttt.TTEmbedding(215, 64, compression_ratio=4.5)
    elif case == "ket":
        j = jket.KetEmbedding(120, 30, order=2, compression_ratio=3.0)
        t = tket.KetEmbedding(120, 30, order=2, compression_ratio=3.0)
        full = "full_table"
    elif case == "ketxs":
        j = jket.KetXSEmbedding(120, 30, order=3, compression_ratio=3.0)
        t = tket.KetXSEmbedding(120, 30, order=3, compression_ratio=3.0)
        full = "full_table"
    elif case == "ttm_embedding":
        j = jttm.TTMEmbedding((5, 4, 6), (2, 4, 3), (1, 3, 5, 1))
        t = tttm.TTMEmbedding((5, 4, 6), (2, 4, 3), (1, 3, 5, 1))
    else:
        j = jttm.TTMLinear((4, 6), (3, 5), (1, 7, 1))
        t = tttm.TTMLinear((4, 6), (3, 5), (1, 7, 1))
        ids = rng.standard_normal((3, 7, 24)).astype(np.float32)
    v = seeded_variables(j, rng, ids)
    if case == "ttm_linear":
        v["params"]["bias"] = rng.standard_normal(15).astype(np.float32)
    load(t, v)
    x = torch.from_numpy(ids) if case == "ttm_linear" else \
        torch.from_numpy(ids).long()
    want = j.apply(v, ids)
    with torch.no_grad():
        got = t(x)
        assert got.shape == want.shape
        assert rel(got, want) <= TOL
        if full is not None:
            assert rel(getattr(t, full)(),
                       j.apply(v, method=getattr(j, full))) <= TOL
    if case.startswith("tt"):
        assert sum(p.numel() for p in t.parameters()) == jax_count(v["params"])


def test_ket_fit_to_dense_lowers_the_error():
    rng = np.random.RandomState(0)
    dense = rng.standard_normal((64, 16)).astype(np.float32)
    m = tket.KetEmbedding(64, 16, order=2, rank=4,
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = float(torch.mean((m.full_table() - torch.from_numpy(dense)) ** 2))
    loss = tket.fit_ket_to_dense(m, dense, steps=20, lr=1e-2)
    assert loss < before
    es, ej = tket.EarlyStopping(patience=2), jket.EarlyStopping(patience=2)
    for x in (3.0, 2.0, 2.5, 2.4, 1.0, 1.5, 1.6, float("nan")):
        assert es.step(x) == ej.step(x)


SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256,
             max_position=64, dropout=0.0, attn_dropout=0.0)
PLANS = [(None, None)] + [(lf, ef) for lf in ("tt", "svd")
                          for ef in ("svd", "tt", "ket", "ketxs")]


def configs(vocab, **over):
    j = jb.BertConfig(vocab_size=vocab, **{**SMALL, **over})
    return j, tb.BertConfig(**dataclasses.asdict(j))


def plans(lf, ef):
    if lf is None and ef is None:
        return None, None
    j = jb.BertCompressionPlan(linear_format=lf, embedding_format=ef,
                               embedding_ratio=4.5)
    return j, tb.BertCompressionPlan(**dataclasses.asdict(j))


def padded_batch(vocab, seed=0, b=3, n=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, n)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    types = np.zeros_like(ids)
    types[:, 12:] = 1
    return ids, mask, types


def compare_outputs(got, want):
    zero = lambda a: np.where(np.asarray(a) <= -1e2, 0.0, a)  # noqa: E731
    for g, w in zip(got["attentions"], want["attentions"]):
        assert rel(torch.where(g <= -1e2, 0.0, g), zero(w)) <= TOL
    assert len(got["hidden_states"]) == len(want["hidden_states"])
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        assert rel(g, w) <= TOL
    assert rel(got["pooled_output"], want["pooled_output"]) <= TOL


@pytest.mark.parametrize("lf,ef", PLANS)
def test_bert_classifier_matches_jax(lf, ef):
    cj, ct = configs(120)
    pj, pt = plans(lf, ef)
    ids, mask, types = padded_batch(120)
    mj = jb.BertForSequenceClassification(cj, num_labels=3, plan=pj)
    v = seeded_variables(mj, np.random.RandomState(1), ids, mask, types)
    mt = load(tb.BertForSequenceClassification(ct, 3, pt), v)
    want = mj.apply(v, ids, mask, types)
    with torch.no_grad():
        got = mt(*(torch.from_numpy(a).long() for a in (ids, mask, types)))
    assert rel(got["logits"], want["logits"]) <= TOL
    compare_outputs(got, want)
    assert count_params(mt) == jax_count(v["params"])


@pytest.mark.parametrize("lf,ef", [(None, None), ("tt", "svd")])
def test_bert_question_answering_matches_jax(lf, ef):
    cj, ct = configs(90, num_layers=3)
    pj, pt = plans(lf, ef)
    ids, mask, types = padded_batch(90, seed=4)
    mj = jb.BertForQuestionAnswering(cj, plan=pj)
    v = seeded_variables(mj, np.random.RandomState(2), ids, mask, types)
    mt = load(tb.BertForQuestionAnswering(ct, pt), v)
    want = mj.apply(v, ids, mask, types)
    with torch.no_grad():
        got = mt(*(torch.from_numpy(a).long() for a in (ids, mask, types)))
    for k in ("start_logits", "end_logits"):
        assert rel(got[k], want[k]) <= TOL
    compare_outputs(got, want)


def test_shared_tucker_encoder_matches_jax():
    cj, ct = configs(50)
    tk = jst.SharedTuckerConfig(rank_layer=6, rank_condim=24, rank_dim=20)
    ids, mask, _ = padded_batch(50, seed=8)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((3, 32, 64)).astype(np.float32)
    add = ((1.0 - mask[:, None, None, :]) * -1e9).astype(np.float32)
    mj = jst.SharedTuckerBertEncoder(cj, tk)
    v = seeded_variables(mj, rng, x, add)
    v["params"]["bias"] = (0.1 * rng.standard_normal((2, 9, 64))).astype(np.float32)
    mt = load(tst.SharedTuckerBertEncoder(ct, tst.SharedTuckerConfig(6, 24, 20)), v)
    want = mj.apply(v, x, add)
    with torch.no_grad():
        got = mt(torch.from_numpy(x), torch.from_numpy(add))
    assert rel(got[0], want[0]) <= TOL
    for g, w in zip(got[1], want[1]):
        assert rel(g, w) <= TOL
    p = {k: jnp.asarray(a) for k, a in v["params"].items() if not isinstance(a, dict)}
    assert rel(mt.rank_regularizer(0.5), mj.rank_regularizer(p, 0.5)) <= 1e-6
    shrunk = mj.shrink_rank(p)
    mt.shrink_rank()
    for k in ("core", "factor_left", "factor_right"):
        np.testing.assert_array_equal(getattr(mt, k).detach().numpy(), shrunk[k])


STUDENT = ROOT / "results" / "nlp_r05" / "sst2_student.msgpack"


def test_committed_jax_student_runs_in_the_port(tmp_path):
    """results/run_nlp.sh's student: hidden 64, 3 layers, 4 heads, FFN 256,
    sequence 32, TT@2x linears and SVD@4.5x embedding on the vocabulary of
    2,048 synthetic SST-2 examples at seed 0."""
    jcfg = JDistillConfig(n_synthetic=2048, max_seq_length=32)
    _, dev, tok, _ = j_prepare(jcfg)
    assert len(tok.vocab) == 215
    cj, ct = configs(215, num_layers=3, max_position=512)
    pj, pt = plans("tt", "svd")
    student = tb.BertForSequenceClassification(ct, 2, pt)
    student.load_state_dict(jax_to_state_dict(load_variables(str(STUDENT))))
    student.eval()
    args = [dev[k] for k in ("input_ids", "attention_mask", "token_type_ids")]
    mj = jb.BertForSequenceClassification(cj, num_labels=2, plan=pj)
    apply = jax.jit(mj.apply)
    want = apply(jax_load(str(STUDENT)), *args)["logits"]
    with torch.no_grad():
        got = student(*(torch.from_numpy(a).long() for a in args))["logits"]
    assert rel(got, want) <= TOL
    assert (got.argmax(-1).numpy() == dev["labels"]).mean() == 1.0
    # the port's --save of it: the JAX package reads the same logits, and
    # the file is the committed one byte for byte
    out = tmp_path / "student.msgpack"
    tcli._save(str(out), student)
    assert rel(got, apply(jax_load(str(out)), *args)["logits"]) <= TOL
    assert out.read_bytes() == STUDENT.read_bytes()


def _vocab(texts):
    return len(build_vocab_from_texts(texts))


def test_bert_base_parameter_counts_match_jax():
    """The counts chip_smoke.py asserts on the card (`NLP_PARAMS`), at
    BERT-base width with the CLI's plan (TT@2x linears, SVD@4.5x
    embedding) on each synthetic corpus's vocabulary."""
    _, _, tok, _ = j_prepare(JDistillConfig())
    v_task = len(tok.vocab)
    v_general = _vocab(synthetic_corpus(JGeneralConfig().n_synthetic_docs, 0))
    ex = synthetic_squad(JSquadConfig().n_synthetic, 0,
                         JSquadConfig().synthetic_context_words)
    v_squad = _vocab([e.question for e in ex] + [e.context for e in ex])
    plan = jb.BertCompressionPlan(linear_format="tt", linear_ratio=2.0,
                                  embedding_format="svd", embedding_ratio=4.5)
    ids = jax.ShapeDtypeStruct((2, 128), jnp.int32)

    def jcount(module):
        return jax_count(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                        ids, ids, ids)["params"])

    def base(vocab):
        return jb.BertConfig(vocab_size=vocab)
    want = {
        "task_teacher": jcount(jb.BertForSequenceClassification(base(v_task))),
        "task_student": jcount(jb.BertForSequenceClassification(
            base(v_task), plan=plan)),
        "general_teacher": jcount(jb.BertModel(base(v_general))),
        "general_student": jcount(jb.BertModel(base(v_general), plan=plan)),
        "squad": jcount(jb.BertForQuestionAnswering(base(v_squad), plan=plan))}
    assert chip_smoke.NLP_PARAMS == want
    # the port's own models, built on the meta device (nothing allocated)
    from dnn_compression_tensor_admm_tpu_torch.nlp.task_distill import (
        DistillConfig)
    teacher, student = task_models(DistillConfig(), v_task, 2, "meta")
    pt = tb.BertCompressionPlan(**dataclasses.asdict(plan))
    with torch.device("meta"):
        general_t = tb.BertModel(tb.BertConfig(vocab_size=v_general))
        general_s = tb.BertModel(tb.BertConfig(vocab_size=v_general), pt)
        squad = tb.BertForQuestionAnswering(tb.BertConfig(vocab_size=v_squad), pt)
    got = {"task_teacher": count_params(teacher),
           "task_student": count_params(student),
           "general_teacher": count_params(general_t),
           "general_student": count_params(general_s),
           "squad": count_params(squad)}
    assert got == want
