"""The port's NLP training pieces against the JAX package's `nlp/`:
BertAdam and its schedules over the same gradients (within 1e-6), the
parameters it decays, `factorize_encoder` compared by its reconstruction
(within 1e-4; SVD signs are free), and the NLP command line with
`--device cpu`."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import optimization as jopt
from dnn_compression_tensor_admm_tpu.nlp import shared_tucker as jst
from dnn_compression_tensor_admm_tpu.utils import load_variables as jax_load
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import cli as tcli
from dnn_compression_tensor_admm_tpu_torch.nlp import optimization as topt
from dnn_compression_tensor_admm_tpu_torch.nlp import shared_tucker as tst
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    _jax_path, jax_to_state_dict, state_dict_to_jax)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=30, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position=16)


def tiny_model(plan=None):
    return tb.BertForSequenceClassification(
        tb.BertConfig(**TINY), 2, plan,
        generator=torch.Generator().manual_seed(0))


def test_no_decay_set_is_the_flax_bias_and_scale_leaves():
    model = tiny_model()
    names = set(topt.no_decay_names(model))
    assert names == {
        "bert.embeddings.LayerNorm.weight", "bert.embeddings.LayerNorm.bias",
        *[f"bert.encoder.layer.0.{m}.bias" for m in (
            "attention.self.query", "attention.self.key",
            "attention.self.value", "attention.output.dense",
            "intermediate.dense", "output.dense")],
        *[f"bert.encoder.layer.0.{m}.{p}" for m in (
            "attention.output.LayerNorm", "output.LayerNorm")
          for p in ("weight", "bias")],
        "bert.pooler.dense.bias", "classifier.bias"}
    # the JAX rule, leaf name 'bias' or 'scale', on the same tree
    for plan in (None, tb.BertCompressionPlan("tt", embedding_format="svd")):
        model = tiny_model(plan)
        flax = {n for n, p in model.named_parameters()
                if _flax_leaf(n, p) in ("bias", "scale")}
        assert set(topt.no_decay_names(model)) == flax
        groups = topt.param_groups(model)
        assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
        assert {id(p) for p in groups[1]["params"]} == \
            {id(p) for n, p in model.named_parameters() if n in flax}


def _flax_leaf(name, p):
    leaf = _jax_path(name)[-1]
    return "scale" if leaf == "weight" and p.ndim == 1 else leaf


@pytest.mark.parametrize("schedule", sorted(k for k in jopt.SCHEDULES if k))
def test_schedules_match_jax(schedule):
    for warmup, t_total in ((0.1, 50), (0.3, 7), (0.0, 10)):
        kw = {}
        if schedule == "warmup_cosine_hard_restarts":
            kw = {"cycles": 2.0}
        j = jopt.SCHEDULES[schedule](warmup, t_total, **kw)
        t = topt.SCHEDULES[schedule](warmup, t_total, **kw)
        for step in range(t_total + 3):
            want = float(j(jnp.asarray(step, jnp.int32)))
            assert abs(float(t(step)) - want) <= 1e-7 * max(1.0, abs(want))


@pytest.mark.parametrize("schedule,accum", [
    ("warmup_linear", 1), ("warmup_linear", 2), ("warmup_cosine", 1)])
def test_bert_adam_matches_jax(schedule, accum):
    model = tiny_model(tb.BertCompressionPlan("tt", embedding_format="svd"))
    params = state_dict_to_jax(model.state_dict())["params"]
    rng = np.random.RandomState(3)
    kw = dict(schedule=schedule, warmup=0.2, t_total=5, eps=1e-6,
              weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=accum)
    tx = jopt.bert_adam(1e-2, **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = topt.BertAdam(topt.param_groups(model), 1e-2, **kw)
    named = dict(model.named_parameters())
    for step in range(5 * accum):
        # each tensor's norm from 0.05 to 5: some clipped, some not
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.01, 1.0)
                       ).astype(np.float32), params)
        u, state = update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, u))
        for name, g in jax_to_state_dict({"params": grads}).items():
            named[name].grad = g
        opt.step()
        want = jax_to_state_dict({"params": params})
        for name, p in named.items():
            w = want[name].numpy()
            err = (np.max(np.abs(p.detach().numpy() - w))
                   / max(np.max(np.abs(w)), 1e-12))
            assert err <= 1e-6, (step, name, err)
    assert opt.param_groups[0]["step"] == 5


def test_factorize_encoder_matches_jax():
    # the block stack of a dense BERT, equal in both layouts
    model = tb.BertModel(tb.BertConfig(**{**TINY, "num_layers": 2,
                                          "intermediate_size": 64}),
                         generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    jparams = state_dict_to_jax(sd)["params"]
    np.testing.assert_array_equal(
        tst.stack_encoder_blocks(sd, 2).numpy(),
        np.asarray(jst.stack_encoder_blocks(jparams, 2)))
    # HOOI on a stack near Tucker ranks (6, 12, 10), 36 blocks of 32 x 32
    rng = np.random.RandomState(0)
    core = rng.standard_normal((6, 12, 10))
    f = [np.linalg.qr(rng.standard_normal((n, r)))[0]
         for n, r in ((36, 6), (32, 12), (32, 10))]
    t = np.einsum("ikl,bi,xk,yl->bxy", core, *f)
    t = (t + 1e-3 * rng.standard_normal(t.shape)).astype(np.float32)
    cfg = jst.SharedTuckerConfig(rank_layer=6, rank_condim=12, rank_dim=10)
    want = jst.factorize_encoder(jnp.asarray(t), cfg, n_iter=3)
    got = tst.factorize_encoder(torch.from_numpy(t), tst.SharedTuckerConfig(
        6, 12, 10), n_iter=3)
    want_rec = np.einsum("xk,bkl,ly->bxy", np.asarray(want["factor_left"]),
                         np.einsum("ikl,bi->bkl", np.asarray(want["core"]),
                                   np.asarray(want["factor_layer"])),
                         np.asarray(want["factor_right"]))
    got_rec = tst.reconstruct_blocks(got).numpy()
    assert np.max(np.abs(got_rec - want_rec)) <= 1e-4 * np.max(np.abs(want_rec))
    fit = np.linalg.norm(got_rec - t) / np.linalg.norm(t)
    assert fit < 0.05
    for k in want:
        assert tuple(got[k].shape) == want[k].shape


def _run_cli(*args, cwd):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "dnn_compression_tensor_admm_tpu_torch.nlp",
         *args], cwd=cwd, env=env, stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])["final"]


TINY_FLAGS = ["--hidden-size", "32", "--num-layers", "2", "--num-heads", "4",
              "--intermediate-size", "64", "--max-seq-length", "32",
              "--batch-size", "16", "--dropout", "0", "--device", "cpu"]


def test_nlp_cli_on_cpu(tmp_path):
    final = _run_cli("task-distill", "--n-synthetic", "64",
                     "--teacher-epochs", "1", "--save", "s.msgpack",
                     "--save-teacher", "t.msgpack", *TINY_FLAGS,
                     cwd=tmp_path)
    assert final["stage"] == 2 and np.isfinite(final["loss"])
    student = jax_load(str(tmp_path / "s.msgpack"))["params"]
    assert "core_0" in student["bert"]["encoder.layer.1"]["output.dense"]
    assert "first_factor" in student["bert"]["embeddings"]["word_embeddings"]
    teacher = jax_load(str(tmp_path / "t.msgpack"))["params"]
    assert teacher["classifier"]["kernel"].shape == (32, 2)
    final = _run_cli("squad", "--output-dir", "sq", "--epochs", "1",
                     "--save", "q.msgpack", *TINY_FLAGS, cwd=tmp_path)
    assert {"exact_match", "f1"} <= set(final) and np.isfinite(final["loss"])
    preds = json.loads((tmp_path / "sq" / "predictions.json").read_text())
    nbest = json.loads((tmp_path / "sq" / "nbest_predictions.json").read_text())
    assert len(preds) == 32 and preds.keys() == nbest.keys()
    assert jax_load(str(tmp_path / "q.msgpack"))["params"]["qa_outputs"][
        "kernel"].shape == (32, 2)
    # general distillation in process, from a teacher state
    model, hist = tcli.main(["general-distill", *TINY_FLAGS])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert isinstance(model, tb.BertModel)
    # the card is the default: without CUDA the entry point raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["general-distill", *TINY_FLAGS[:-2]])
