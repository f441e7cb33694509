"""The port's `run_general_distillation` against the JAX package's, from
the same teacher and student weights and the same batch order, dropout
off, at `grad_accum_steps` = 2 (optax.MultiSteps: the running mean of two
micro-batches, one update and one schedule step on the second; an
odd number of micro-batches an epoch, so an update spans two epochs): the
per-epoch losses within 1e-4 relative and the students' hidden states on
the first batch within 1e-4 of their scale. The student's pooler gets no
gradient (the loss reads attentions and hidden states only): both decay
it. On the CPU the port runs its step eagerly; the captured route is held
to this one on the card (`chip_smoke.py`'s `nlp_captured` gate)."""

import dataclasses

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import bert as jb
from dnn_compression_tensor_admm_tpu.nlp import general_distill as jgd
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import general_distill as tgd
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)
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


def test_run_general_distillation_matches_jax(monkeypatch):
    common = dict(max_seq_length=32, batch_size=8, epochs=2, lr=1e-3,
                  n_synthetic_docs=28, grad_accum_steps=2,
                  print_fn=lambda *a: None)
    jplan = jb.BertCompressionPlan(linear_format="tt", linear_ratio=2.0)
    jcfg = jgd.GeneralDistillConfig(bert=jb.BertConfig(**SMALL), plan=jplan,
                                    **common)
    tcfg = tgd.GeneralDistillConfig(
        bert=tb.BertConfig(**SMALL),
        plan=tb.BertCompressionPlan(**dataclasses.asdict(jplan)),
        device="cpu", **common)
    data, tok = tgd.general_data(tcfg)
    n = len(data["input_ids"])
    assert n // 8 == 3, n  # 3 micro-batches an epoch: an update spans both
    bcfg = dataclasses.replace(jcfg.bert, vocab_size=len(tok.vocab))
    args = [data[k][:2] for k in ("input_ids", "attention_mask",
                                  "token_type_ids")]
    rng = np.random.RandomState(0)
    init = {plan is None: seeded_variables(jb.BertModel(bcfg, plan=plan),
                                           rng, *args)
            for plan in (None, jplan)}

    class JaxSeeded(jb.BertModel):
        def init(self, *a, **k):
            return init[self.plan is None]

    class TorchSeeded(tb.BertModel):
        def __init__(self, cfg, plan=None, **kw):
            super().__init__(cfg, plan, **kw)
            self.load_state_dict(jax_to_state_dict(init[plan is None]))

    monkeypatch.setattr(jgd, "BertModel", JaxSeeded)
    monkeypatch.setattr(tgd, "BertModel", TorchSeeded)
    jvars, jhist = jgd.run_general_distillation(jcfg)
    student, thist = tgd.run_general_distillation(tcfg)
    assert [r["epoch"] for r in thist] == [r["epoch"] for r in jhist] == [1, 2]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t, j)
    # the students after 2 epochs: hidden states of the first batch
    b = {k: data[k][:8] for k in ("input_ids", "attention_mask",
                                  "token_type_ids")}
    want = jb.BertModel(bcfg, plan=jplan).apply(
        jvars, b["input_ids"], b["attention_mask"], b["token_type_ids"])
    student.eval()
    with torch.no_grad():
        got = student(*(torch.from_numpy(b[k]).long() for k in (
            "input_ids", "attention_mask", "token_type_ids")))
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= 1e-4 * np.max(np.abs(w))
    # the pooler took no gradient and decayed as JAX's did
    pooler = "pooler.dense.weight"
    start = jax_to_state_dict(init[False])[pooler]
    ended = jax_to_state_dict(jvars)[pooler]
    assert not torch.equal(ended, start)
    assert torch.allclose(student.state_dict()[pooler], ended,
                          rtol=0, atol=1e-6 * float(ended.abs().max()))
    assert state_dict_to_jax(student.state_dict())["params"].keys() == \
        jvars["params"].keys()
