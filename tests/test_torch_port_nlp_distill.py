"""The port's `run_task_distillation` against the JAX package's, from the
same teacher and student weights and the same batch order: the teacher's
fine-tune and dev score, then 2 epochs of stage 1 and of stage 2, with
the per-epoch losses within 1e-4 relative and the same dev predictions
(for STS-B, regression: correlations and predictions within 1e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import bert as jb
from dnn_compression_tensor_admm_tpu.nlp import task_distill as jtd
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import task_distill as ttd
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict
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


@pytest.mark.parametrize("task,teacher_epochs,stage1_epochs", [
    ("sst-2", 2, 2), ("sts-b", 0, 0)])
def test_run_task_distillation_matches_jax(task, teacher_epochs,
                                           stage1_epochs, monkeypatch):
    """From the same initial weights: the JAX side's seeded init is
    replaced by the test's weights, the port's models load them. STS-B
    (the regression head, MSE in stage 2) takes its teacher as given."""
    common = dict(task=task, max_seq_length=32, batch_size=16, n_synthetic=64,
                  stage1_epochs=stage1_epochs, stage2_epochs=2,
                  lr_stage1=1e-3, lr_stage2=1e-3,
                  teacher_epochs=teacher_epochs, teacher_lr=1e-3,
                  print_fn=lambda *a: None)
    jplan = jb.BertCompressionPlan(linear_format="tt", linear_ratio=2.0,
                                   embedding_format="svd", embedding_ratio=4.5)
    jcfg = jtd.DistillConfig(bert=jb.BertConfig(**SMALL), plan=jplan, **common)
    tcfg = ttd.DistillConfig(bert=tb.BertConfig(**SMALL),
                             plan=tb.BertCompressionPlan(
                                 **dataclasses.asdict(jplan)),
                             device="cpu", **common)
    train, dev, tok, proc = jtd.prepare_task_data(jcfg)
    n_labels = 1 if proc.regression else len(proc.labels)
    bcfg = dataclasses.replace(jcfg.bert, vocab_size=len(tok.vocab))
    args = [train[k][:2] for k in ("input_ids", "attention_mask",
                                   "token_type_ids")]
    rng = np.random.RandomState(0)
    init = {plan: seeded_variables(jb.BertForSequenceClassification(
        bcfg, num_labels=n_labels, plan=plan), rng, *args)
        for plan in (None, jplan)}

    class Seeded(jb.BertForSequenceClassification):
        def init(self, *a, **k):
            return init[self.plan]

    monkeypatch.setattr(jtd, "BertForSequenceClassification", Seeded)
    given = init[None] if teacher_epochs == 0 else None
    jparams, jhist = jtd.run_task_distillation(jcfg, given)

    def seeded_models(cfg, vocab, n, device="cpu"):
        teacher, student = models(cfg, vocab, n, device)
        teacher.load_state_dict(jax_to_state_dict(init[None]))
        student.load_state_dict(jax_to_state_dict(init[jplan]))
        return teacher, student

    models = ttd.task_models
    monkeypatch.setattr(ttd, "task_models", seeded_models)
    student, thist, _ = ttd.run_task_distillation(tcfg)
    assert [(r["stage"], r.get("epoch")) for r in thist] == \
        [(r["stage"], r.get("epoch")) for r in jhist]
    metric = "corr" if proc.regression else "acc"
    for t, j in zip(thist, jhist):
        if "loss" in j:
            assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t, j)
        if metric in j:
            tol = 1e-4 if proc.regression else 0.0
            assert abs(t[metric] - j[metric]) <= tol, (t, j)
    # the dev predictions of the distilled students
    dargs = [dev[k] for k in ("input_ids", "attention_mask", "token_type_ids")]
    jlogits = np.asarray(jb.BertForSequenceClassification(
        bcfg, num_labels=n_labels, plan=jplan).apply(jparams, *dargs)["logits"])
    student.eval()
    with torch.no_grad():
        tlogits = student(*(torch.from_numpy(a).long() for a in dargs))["logits"]
    if proc.regression:
        np.testing.assert_allclose(tlogits.numpy(), jlogits,
                                   atol=1e-4 * np.abs(jlogits).max())
    else:
        np.testing.assert_array_equal(tlogits.argmax(-1).numpy(),
                                      jlogits.argmax(-1))
