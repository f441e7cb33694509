"""The pieces of the JAX package's CIFAR recipes that the port gained
beside ResNet56, against the JAX package on the same inputs: the `step`,
`constant` and cosine schedules at every step, Nesterov SGD (`sgd`) and
Adam (`adam`) over five steps, the soft-orthogonality penalty and its
gradient on a decomposed `tkc_resnet32`, and the `gram` and `ns`
projections; then the port's own `admm_grad_add` against autograd of the
penalty, and the EMA shadow of a training run against the recursion over
its parameters after each step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from dnn_compression_tensor_admm_tpu.admm.regularizers import (
    orthogonal_penalty as jax_orthogonal_penalty)
from dnn_compression_tensor_admm_tpu.ops.svd import truncated_left_sv as jax_left_sv
from dnn_compression_tensor_admm_tpu.train.optim import (
    make_optimizer as jax_optimizer, make_schedule as jax_schedule)
from dnn_compression_tensor_admm_tpu_torch.admm import (
    admm_grad_add, admm_init, admm_penalty, build_program, orthogonal_penalty)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset
from dnn_compression_tensor_admm_tpu_torch.models import create_model, decompose_params
from dnn_compression_tensor_admm_tpu_torch.ops.svd import truncated_left_sv
from dnn_compression_tensor_admm_tpu_torch.train import (
    TrainConfig, evaluate_model, train_model)
from dnn_compression_tensor_admm_tpu_torch.train.optim import make_optimizer, make_schedule
from dnn_compression_tensor_admm_tpu_torch.train.state import TrainState, load_train_state
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax

LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# 7 epochs of 3 steps: the step decay every 2 epochs fires 7 // 2 = 3
# times (steps 6, 12, 18); the cosine warms up over the first epoch
@pytest.mark.parametrize("kind", ["step", "constant", "cosine"])
def test_schedule_matches_the_jax_schedule_at_every_step(kind):
    epochs, steps, warmup, decay_epochs, decay_rate = 7, 3, 1, 2, 0.1
    ref = jax_schedule(kind, LR, epochs, steps, warmup, 1e-5, decay_epochs,
                       decay_rate)
    got = make_schedule(kind, LR, epochs, steps, warmup, 1e-5, decay_epochs,
                        decay_rate)
    for step in range(epochs * steps + 5):
        # optax computes in float32
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-8, err_msg=str(step))
    if kind == "step":  # a factor applies from its boundary step itself
        assert [got(s) for s in (5, 6)] == [LR, LR * decay_rate]
        assert got(18) == pytest.approx(LR * decay_rate ** 3, rel=1e-12)


def test_step_schedule_decays_at_least_once():
    """epochs < decay_epochs: optax's table still holds one boundary."""
    ref = jax_schedule("step", LR, 2, 3, decay_epochs=30, decay_rate=0.5)
    got = make_schedule("step", LR, 2, 3, decay_epochs=30, decay_rate=0.5)
    assert [got(s) for s in (0, 89, 90)] == [LR, LR, LR * 0.5]
    assert [float(ref(s)) for s in (89, 90)] == pytest.approx([LR, LR * 0.5])


@pytest.mark.parametrize("opt,lr,wd", [("sgd", 0.1, 1e-4), ("adam", 1e-3, 0.05)])
def test_sgd_and_adam_match_optax_over_5_steps(opt, lr, wd):
    """Nesterov SGD with L2, and Adam, which takes no weight decay at all
    (a weight decay given is ignored, as optax.adam ignores it)."""
    rng = np.random.RandomState(0)
    shapes = [(16, 8), (8,), (3, 5, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    epochs, steps = 5, 1
    tx = jax_optimizer(opt, jax_schedule("step", lr, epochs, steps,
                                         decay_epochs=2, decay_rate=0.5),
                       momentum=0.9, weight_decay=wd)
    sched = make_schedule("step", lr, epochs, steps, decay_epochs=2,
                          decay_rate=0.5)
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = make_optimizer(params, lr, opt=opt, momentum=0.9, weight_decay=wd)
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        for group in topt.param_groups:
            group["lr"] = sched(step)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        topt.step()
    for p, a in zip(params, pj):
        # float32 on both sides; optax takes Adam's bias correction in
        # float32, torch in float64 (~1e-7 apart a step at lr 1e-3)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-6)
    assert max(np.abs(p.detach().numpy() - a).max()
               for p, a in zip(params, p0)) > 1e-3


def test_orthogonal_penalty_and_gradient_match_jax_on_tkc_resnet32():
    dense = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    sd = decompose_params(dense.state_dict(), get_rank_plan("resnet32", "tk", "3"))
    model = create_model("tkc_resnet32", ratio="3")
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    rho = 1e-2
    loss = orthogonal_penalty(params, rho)
    jparams = state_dict_to_jax(model.state_dict())["params"]
    jloss = jax_orthogonal_penalty(jparams, rho)
    # exact-SVD factors are orthonormal: the penalty is float32 rounding
    # summed over 60 factors, and both sides' Grams sum in another order
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4, abs=1e-9)
    factors = [n for n in params if n.endswith(("first_factor", "last_factor"))]
    assert len(factors) == 60
    # away from orthonormality the gradient is the same function
    with torch.no_grad():
        for n in factors:
            params[n].mul_(1.1)
    loss = orthogonal_penalty(params, rho)
    loss.backward()
    jparams = state_dict_to_jax(model.state_dict())["params"]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_orthogonal_penalty(p, rho))(jparams)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for n in factors:
        blk, conv, leaf = n.rsplit(".", 2)
        np.testing.assert_allclose(params[n].grad.numpy(),
                                   np.asarray(jgrads[blk][conv][leaf]),
                                   rtol=1e-4, atol=1e-7, err_msg=n)
        assert float(params[n].grad.abs().max()) > 1e-4


def _with_spectrum(m, n, rank, seed):
    """An m x n float32 matrix with singular values 0.9^i, cut by 10x past
    `rank`: the top-`rank` subspace is well defined, eigh of the Gram
    resolves it in float32, and 8 steps of orthogonal iteration find it
    (the Gram's ratio at the cut, ~0.008, to the 8th power)."""
    rng = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    s = 0.9 ** np.arange(min(m, n))
    s[rank:] *= 0.1
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.parametrize("method", ["gram", "ns"])
@pytest.mark.parametrize("m,n,rank", [(24, 150, 8), (90, 40, 12)])
def test_gram_and_ns_projectors_match_jax(method, m, n, rank):
    a = _with_spectrum(m, n, rank, m + n)
    q = truncated_left_sv(torch.from_numpy(a), rank, method=method).numpy()
    qj = np.asarray(jax_left_sv(jnp.asarray(a), rank, method=method))
    assert q.shape == qj.shape == (m, rank)
    np.testing.assert_allclose(q.T @ q, np.eye(rank), atol=1e-5)
    # bases may differ (two LAPACKs' eigh, signs): compare projectors
    np.testing.assert_allclose(q @ q.T, qj @ qj.T, atol=1e-5)
    u = np.linalg.svd(a.astype(np.float64))[0][:, :rank]
    np.testing.assert_allclose(q @ q.T, u @ u.T, atol=1e-4)


def test_admm_grad_add_equals_the_gradient_of_the_penalty():
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan("resnet32", "tk", "3"))
    state = admm_init(params, program)
    rng = np.random.RandomState(0)
    for n in program.names:  # targets and duals away from W
        state.z[n] = torch.from_numpy(
            rng.standard_normal(state.z[n].shape).astype(np.float32))
        state.u[n] = torch.from_numpy(
            0.1 * rng.standard_normal(state.u[n].shape).astype(np.float32))
    rho = 1e-3
    admm_penalty(params, state, program, rho).backward()
    auto = {n: params[n].grad.clone() for n in program.names}
    model.zero_grad(set_to_none=True)
    admm_grad_add(params, state, program, rho)  # allocates .grad
    admm_grad_add(params, state, program, rho)  # adds to it
    for n in program.names:
        torch.testing.assert_close(params[n].grad, 2 * auto[n], rtol=1e-6,
                                   atol=1e-9)
    assert params["linear.weight"].grad is None  # not a plan layer


def test_ema_shadow_is_the_recursion_over_the_steps(tmp_path):
    """The shadow after 2 epochs x 2 steps equals e <- d e + (1 - d) p
    over the parameters after each optimizer step, started from the
    weights the run starts from; `ema_test_*` is the model evaluated with
    the shadow's parameters and the live BatchNorm buffers."""
    init = create_model("resnet32",
                        generator=torch.Generator().manual_seed(5)).state_dict()
    snapshots = []

    def record(optimizer, args, kwargs):
        snapshots.append([p.detach().clone() for g in optimizer.param_groups
                          for p in g["params"]])

    cfg = TrainConfig(model="resnet32", dataset="synthetic-cifar10",
                      synthetic_size=32, batch_size=8, epochs=2,
                      steps_per_epoch=2, ema_decay=0.9, compute_dtype=None,
                      device="cpu", checkpoint_dir=str(tmp_path),
                      print_fn=lambda *a: None)
    handle = register_optimizer_step_post_hook(record)
    try:
        model, hist = train_model(cfg, init_state_dict=init)
    finally:
        handle.remove()
    assert len(snapshots) == 4
    names = [n for n, _ in model.named_parameters()]
    shadow = [init[n].clone() for n in names]
    for snap in snapshots:
        shadow = [e.mul(0.9).add(p.mul(1 - 0.9)) for e, p in zip(shadow, snap)]
    params = dict(model.named_parameters())
    template = TrainState(step=0, epoch=-1, model=model.state_dict(),
                          optimizer={}, admm=None, ema=params, rng={})
    saved, _ = load_train_state(str(tmp_path), template)
    for n, e in zip(names, shadow):
        assert torch.equal(saved.ema[n], e), n
    # the shadow is not the parameters
    assert not torch.equal(saved.ema["linear.weight"],
                           params["linear.weight"])
    x, y, info = load_dataset("synthetic-cifar10", False, 8)
    ema_model = create_model("resnet32")
    ema_model.load_state_dict({**model.state_dict(), **saved.ema})
    ev = evaluate_model(ema_model, x, y, info)
    assert {k: hist[-1][f"ema_test_{k}"] for k in ev} == ev
    # the live parameters came back after the shadow's eval
    assert evaluate_model(model, x, y, info)["loss"] == hist[-1]["test_loss"]

