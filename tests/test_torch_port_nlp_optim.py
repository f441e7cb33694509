"""The port's multi-tensor BertAdam against the JAX package's `bert_adam`
where some parameters get no gradient (the student's pooler and
classifier in stage 1 of task distillation, whose loss reads only
attentions and hidden states): optax gives them a zero gradient, so their
m and v decay and a decayed leaf still loses lr_t * wd * p. Every
parameter within 1e-6 of JAX's, with and without gradient accumulation.
Then the lr table on the device against `lr_at`, bit for bit, for every
schedule over every step."""

import jax
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.nlp import optimization as jopt
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as tb
from dnn_compression_tensor_admm_tpu_torch.nlp import optimization as topt
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=30, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position=16)
GRADIENT_FREE = ("bert.pooler.dense.", "classifier.")


def _student():
    return tb.BertForSequenceClassification(
        tb.BertConfig(**TINY), 2,
        tb.BertCompressionPlan("tt", embedding_format="svd"),
        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("accum", [1, 2])
def test_gradient_free_parameters_decay_as_jax_does(accum):
    model = _student()
    named = dict(model.named_parameters())
    free = {n for n in named if n.startswith(GRADIENT_FREE)}
    assert {n.rsplit(".", 1)[-1] for n in free} == {"weight", "bias"}
    params = state_dict_to_jax(model.state_dict())["params"]
    kw = dict(schedule="warmup_linear", warmup=0.1, t_total=6, eps=1e-6,
              weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=accum)
    tx = jopt.bert_adam(1e-2, **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = topt.BertAdam(topt.param_groups(model), 1e-2, **kw)
    rng = np.random.RandomState(5)
    start = {n: p.detach().clone() for n, p in named.items()}
    for step in range(6 * accum):
        grads = jax_to_state_dict({"params": jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.01, 1.0)
                       ).astype(np.float32), params)})
        for name in free:  # no gradient: None in torch, zeros in JAX
            grads[name] = torch.zeros_like(grads[name])
        u, state = update(state_dict_to_jax(grads)["params"], state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, u))
        opt.zero_grad(set_to_none=True)
        for name, p in named.items():
            p.grad = None if name in free else grads[name]
        opt.step()
        want = jax_to_state_dict({"params": params})
        for name, p in named.items():
            w = want[name].numpy()
            err = (np.max(np.abs(p.detach().numpy() - w))
                   / max(np.max(np.abs(w)), 1e-12))
            assert err <= 1e-6, (step, name, err)
    # the decayed kernels of the gradient-free layers moved, their biases
    # (no decay, no gradient) did not
    for name in free:
        moved = not torch.equal(named[name].detach(), start[name])
        assert moved == name.endswith("weight"), name
    assert opt.param_groups[0]["step"] == 6
    assert int(opt._on_device(torch.device("cpu"))["step"]) == 6


@pytest.mark.parametrize("schedule", sorted(topt.SCHEDULES, key=str))
@pytest.mark.parametrize("warmup,t_total", [(0.1, 50), (0.3, 7), (0.0, 10),
                                            (0.1, -1)])
def test_lr_table_is_lr_at_bit_for_bit(schedule, warmup, t_total):
    """The lr each update reads on the device (the table at the device's
    update counter, clamped past the schedule's end) equals `lr_at`'s host
    float32 at every step, for both groups."""
    w = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(2))
    opt = topt.BertAdam([{"params": [w], "weight_decay": 0.01},
                         {"params": [b], "weight_decay": 0.0, "lr": 3e-4}],
                        1e-3, schedule=schedule, warmup=warmup,
                        t_total=t_total)
    for step in range(max(t_total, 1) + 4):
        dev = opt._on_device(torch.device("cpu"))
        for index, group in enumerate(opt.param_groups):
            got = opt._lr(dev, index).numpy()
            want = np.float32(opt.lr_at(group))
            assert got.dtype == np.float32, got.dtype
            assert got.tobytes() == want.tobytes(), (step, index, got, want)
        opt.step()  # no gradients: zeros, one update
    assert opt.param_groups[1]["step"] == max(t_total, 1) + 4
