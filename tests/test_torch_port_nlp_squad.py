"""The port's `run_squad` against the JAX package's, from the same weights
and the same batch order, dropout off: the per-epoch losses within 1e-4
relative, the dev start and end logits within 1e-4 of their scale, and
the same predictions (`predictions.json`; the n-best texts in order). The
dev set's last batch is padded by repeating its last row in both. The
QA model's pooler gets no gradient: both decay it. On the CPU the port
runs its step and its dev forward eagerly; the captured route is held to
this one on the card (`chip_smoke.py`'s `nlp_captured` gate)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import bert as jb
from dnn_compression_tensor_admm_tpu.nlp import squad as jsq
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import squad as tsq
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict)
from test_torch_port_nlp_model import seeded_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256,
             dropout=0.0, attn_dropout=0.0)


def test_padded_order_repeats_the_last_row():
    assert tsq.padded_order(5, 4).tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    assert tsq.padded_order(8, 4).tolist() == list(range(8))


def test_run_squad_matches_jax(monkeypatch, tmp_path):
    common = dict(max_seq_length=48, doc_stride=16, batch_size=8, epochs=2,
                  lr=1e-3, n_synthetic=24, synthetic_context_words=40,
                  print_fn=lambda *a: None)
    jplan = jb.BertCompressionPlan(linear_format="tt", linear_ratio=2.0,
                                   embedding_format="svd", embedding_ratio=4.5)
    jcfg = jsq.SquadConfig(bert=jb.BertConfig(**SMALL), plan=jplan,
                           output_dir=str(tmp_path / "jax"), **common)
    tcfg = tsq.SquadConfig(bert=tb.BertConfig(**SMALL),
                           plan=tb.BertCompressionPlan(
                               **dataclasses.asdict(jplan)),
                           output_dir=str(tmp_path / "torch"), device="cpu",
                           **common)
    _, dev_ex, train_feats, dev_feats, tok = tsq.squad_data(tcfg)
    # doc-stride windows, and a dev set whose last batch is padded
    assert len(train_feats) > len(dev_ex) and len(dev_feats) % 8, (
        len(train_feats), len(dev_feats))
    train = tsq.features_to_arrays(train_feats)
    bcfg = dataclasses.replace(jcfg.bert, vocab_size=len(tok.vocab))
    args = [train[k][:2] for k in ("input_ids", "attention_mask",
                                   "token_type_ids")]
    init = seeded_variables(jb.BertForQuestionAnswering(bcfg, plan=jplan),
                            np.random.RandomState(0), *args)

    class JaxSeeded(jb.BertForQuestionAnswering):
        def init(self, *a, **k):
            return init

    class TorchSeeded(tb.BertForQuestionAnswering):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.load_state_dict(jax_to_state_dict(init))

    monkeypatch.setattr(jsq, "BertForQuestionAnswering", JaxSeeded)
    monkeypatch.setattr(tsq, "BertForQuestionAnswering", TorchSeeded)
    jvars, jhist = jsq.run_squad(jcfg)
    model, thist = tsq.run_squad(tcfg)
    assert [r["epoch"] for r in thist] == [r["epoch"] for r in jhist] == [1, 2]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t, j)
        assert (t["exact_match"], t["f1"]) == (j["exact_match"], j["f1"])
    dev = tsq.features_to_arrays(dev_feats)
    dargs = [dev[k] for k in ("input_ids", "attention_mask", "token_type_ids")]
    want = jb.BertForQuestionAnswering(bcfg, plan=jplan).apply(jvars, *dargs)
    model.eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a).long() for a in dargs))
    for k in ("start_logits", "end_logits"):
        w = np.asarray(want[k])
        assert np.max(np.abs(got[k].numpy() - w)) <= 1e-4 * np.max(np.abs(w))
    read = {side: {f: json.loads((tmp_path / side / f).read_text())
                   for f in ("predictions.json", "nbest_predictions.json")}
            for side in ("jax", "torch")}
    assert read["torch"]["predictions.json"] == read["jax"]["predictions.json"]
    nbest = {side: {i: [c["text"] for c in v] for i, v in
                    read[side]["nbest_predictions.json"].items()}
             for side in read}
    assert nbest["torch"] == nbest["jax"]
    # the pooler took no gradient and decayed as JAX's did
    pooler = "bert.pooler.dense.weight"
    start = jax_to_state_dict(init)[pooler]
    ended = jax_to_state_dict(jvars)[pooler]
    assert not torch.equal(ended, start)
    assert torch.allclose(model.state_dict()[pooler], ended, rtol=0,
                          atol=1e-6 * float(ended.abs().max()))
