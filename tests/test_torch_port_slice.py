"""The PyTorch port's first slice as a whole against the JAX package:
ResNet32 Tucker-2 @3x, ADMM X-step -> Z/U step -> decompose -> eval.

No random stream is compared: both sides start from the same weights
and take the same numpy batch, in float32. Each later stage starts both
sides from the JAX side's result, so errors do not compound: at a random
init the float32 X-step gradient itself is only good to about 0.5% (JAX
0.65%, the port 0.43% against a float64 run of the port). The command
line's end-to-end run is in `test_torch_port_cli.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import (
    compression_ratio as jax_ratio, create_model as jax_model,
    decompose_params as jax_decompose)
from dnn_compression_tensor_admm_tpu.train.losses import cross_entropy as jax_ce
from dnn_compression_tensor_admm_tpu.train.optim import make_optimizer, make_schedule
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.train.losses import cross_entropy
from dnn_compression_tensor_admm_tpu_torch.train.optim import (
    cosine_lr, make_optimizer as torch_optimizer)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RHO, LR, SMOOTHING = 1e-3, 0.1, 0.1


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.fixture(scope="module")
def slice_run(_one_torch_thread):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    jm = jax_model("resnet32", num_classes=10)
    tm = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    v = state_dict_to_jax(tm.state_dict())  # the same weights in JAX layout
    params = dict(tm.named_parameters())
    plan_j, plan_t = jax_plan("resnet32", "tk", "3"), get_rank_plan("resnet32", "tk", "3")
    jprog = jeng.build_program(v["params"], plan_j)
    tprog = teng.build_program(params, plan_t)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        # first projection (update_u=False)
        js, _ = jeng.admm_update(v["params"], jeng.admm_init(v["params"], jprog),
                                 jprog, update_u=False, method="pallas", n_iter=6)
        ts, _ = teng.admm_update(params, teng.admm_init(params, tprog), tprog,
                                 update_u=False, method="kernel", n_iter=6)

        # one X-step with the penalty: JAX side
        tx = make_optimizer("momentum", make_schedule("cosine", LR, 1, 1,
                                                      min_lr=1e-5))

        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return (jax_ce(logits, jnp.asarray(y), SMOOTHING)
                    + jeng.admm_penalty(p, js, jprog, RHO)), mut
        (loss_j, mut), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
        upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        jparams = optax.apply_updates(v["params"], upd)
        # port side
        opt = torch_optimizer(tm.parameters(), cosine_lr(0, LR, 1, 1e-5))
        tm.train()
        logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        loss_t = cross_entropy(logits, torch.from_numpy(y), SMOOTHING) \
            + teng.admm_penalty(params, ts, tprog, RHO)
        opt.zero_grad()
        loss_t.backward()
        opt.step()
        out["loss"] = (float(loss_j), loss_t.item())
        out["params"] = (v["params"], jparams,
                         {k: p.detach().clone() for k, p in params.items()})
        jvars = {"params": jparams, "batch_stats": mut["batch_stats"]}
        out["bn_running_mean"] = (mut["batch_stats"]["bn1"]["mean"],
                                  tm.state_dict()["bn1.running_mean"].clone())
        tm.load_state_dict(jax_to_state_dict(jvars))  # continue from JAX's

        # Z/U step on the updated weights
        js2, jr2 = jeng.admm_update(jparams, js, jprog, update_u=True,
                                    method="pallas", n_iter=6)
        ts2, tr2 = teng.admm_update(params, ts, tprog, update_u=True,
                                    method="kernel", n_iter=6)
        out["zu"] = (js2, jr2, ts2, tr2)

    # decompose (exact SVD HOSVD + HOOI) and eval
    jdec = jax.jit(lambda vs: jax_decompose(vs, plan_j))(jvars)
    tdec = decompose_params(tm.state_dict(), plan_t)
    jc = jax_model("tkc_resnet32", num_classes=10, ratio="3")
    tc = create_model("tkc_resnet32", ratio="3")
    tc.load_state_dict(tdec)
    out["ratio"] = (jax_ratio(jvars, jdec), compression_ratio(tm, tc))
    out["dec"] = (jdec, tdec)
    xe = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out["eval"] = (np.asarray(jax.jit(jc.apply)(jdec, jnp.asarray(xe))),
                       tc.eval()(torch.from_numpy(xe).permute(0, 3, 1, 2)).numpy())
    return out


def test_x_step_loss_and_update_match_jax(slice_run):
    loss_j, loss_t = slice_run["loss"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    before, jparams, tparams = slice_run["params"]
    back = state_dict_to_jax(tparams)["params"]
    flat = [jax.tree_util.tree_flatten_with_path(t)[0]
            for t in (before, jparams, back)]
    for (p, w0), (_, wj), (_, wt) in zip(*flat):
        # the updates (lr x gradient + decay + penalty) agree within the
        # float32 gradient's own accuracy at this init (see the docstring)
        dj, dt = np.asarray(wj) - np.asarray(w0), wt - np.asarray(w0)
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj), str(p)
    m_j, m_t = slice_run["bn_running_mean"]
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-4, atol=1e-6)


def test_zu_step_after_x_step_matches_jax(slice_run):
    js2, jr2, ts2, tr2 = slice_run["zu"]
    for n in jr2:
        z_t = ts2.z[n].permute(2, 3, 1, 0).numpy()
        # inputs already differ by the X-step's float32 rounding (~1e-6)
        assert _rel(z_t, js2.z[n]) < 1e-4, n
        np.testing.assert_allclose(float(tr2[n]), float(jr2[n]), rtol=1e-3,
                                   atol=1e-5, err_msg=n)


def test_decompose_ratio_and_kernels_match_jax(slice_run):
    r_j, r_t = slice_run["ratio"]
    assert r_t == pytest.approx(r_j, rel=1e-12) and round(r_t, 2) == 2.83
    jdec, tdec = slice_run["dec"]
    for name in get_rank_plan("resnet32", "tk", "3").names():
        prefix = name[:-len("weight")]
        blk, conv = prefix.split(".")[0] + "." + prefix.split(".")[1], prefix.split(".")[2]
        jl = jdec["params"][blk][conv]
        w_j = np.einsum("oa,hwba,bi->oihw", jl["last_factor"], jl["core_kernel"],
                        jl["first_factor"])
        w_t = torch.einsum("oa,abhw,bi->oihw", tdec[prefix + "last_factor"],
                           tdec[prefix + "core_kernel"],
                           tdec[prefix + "first_factor"]).numpy()
        # the singular values at the rank cut of these near-random kernels
        # differ by ~1%, so float32 HOOI is only so good: the JAX side's own
        # result is 1.5e-4 from a float64 run at layer3.1.conv2
        assert _rel(w_t, w_j) < 1e-3, name


def test_eval_logits_of_decomposed_model_match_jax(slice_run):
    logits_j, logits_t = slice_run["eval"]
    assert logits_t.shape == (4, 10) and np.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-3, atol=1e-3)
