"""The PyTorch port's TT slice as a whole against the JAX package:
ResNet32 Tensor-Train @3x, first projection -> X-step -> Z/U step ->
decompose to ttm_resnet32 -> eval.

Both sides start from the same weights and take the same numpy batch, in
float32. The port's Z-step takes `method="kernel"` (its plain version on
the CPU), the JAX package's `method="pallas"` with the Pallas kernels in
interpret mode. Each later stage starts both sides from the JAX side's
result, so errors do not compound. The command line's end-to-end run is
in `test_torch_port_cli.py`.
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
from dnn_compression_tensor_admm_tpu_torch.ops.contractions import merge_tt_matrix
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


def _dense_from_tt(sd, prefix):
    """The dense OIHW kernel a TT layer's parameters stand for."""
    def chain(kind):
        names = sorted((k for k in sd if k.startswith(f"{prefix}{kind}_core_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        return merge_tt_matrix([sd[k] for k in names])
    w = torch.einsum("oa,abhw->obhw", chain("out"), sd[prefix + "core_kernel"])
    return torch.einsum("obhw,bi->oihw", w, chain("in")).numpy()


@pytest.fixture(scope="module")
def slice_run(_one_torch_thread):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    jm = jax_model("resnet32", num_classes=10)
    tm = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    v = state_dict_to_jax(tm.state_dict())  # the same weights in JAX layout
    params = dict(tm.named_parameters())
    plan_j = jax_plan("resnet32", "tt", "3", "general")
    plan_t = get_rank_plan("resnet32", "tt", "3")
    jprog = jeng.build_program(v["params"], plan_j)
    tprog = teng.build_program(params, plan_t)
    out = {"kinds": ({g.kind for g in jprog.groups},
                     {g.kind for g in tprog.groups})}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        # first projection (update_u=False)
        js, _ = jeng.admm_update(v["params"], jeng.admm_init(v["params"], jprog),
                                 jprog, update_u=False, method="pallas", n_iter=6)
        ts, _ = teng.admm_update(params, teng.admm_init(params, tprog), tprog,
                                 update_u=False, method="kernel", n_iter=6)
        out["z0"] = (js, ts)

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
        # port side, from its own first projection
        opt = torch_optimizer(tm.parameters(), cosine_lr(0, LR, 1, 1e-5))
        tm.train()
        logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        loss_t = cross_entropy(logits, torch.from_numpy(y), SMOOTHING) \
            + teng.admm_penalty(params, ts, tprog, RHO)
        opt.zero_grad()
        loss_t.backward()
        opt.step()
        out["loss"] = (float(loss_j), loss_t.item())
        jvars = {"params": jparams, "batch_stats": mut["batch_stats"]}
        tm.load_state_dict(jax_to_state_dict(jvars))  # continue from JAX's

        # Z/U step on the updated weights, from the JAX side's state
        ts_j = teng.AdmmState(
            u={n: torch.from_numpy(np.array(js.u[n])).permute(3, 2, 0, 1)
               for n in tprog.names},
            z={n: torch.from_numpy(np.array(js.z[n])).permute(3, 2, 0, 1)
               for n in tprog.names})
        js2, jr2 = jeng.admm_update(jparams, js, jprog, update_u=True,
                                    method="pallas", n_iter=6)
        ts2, tr2 = teng.admm_update(params, ts_j, tprog, update_u=True,
                                    method="kernel", n_iter=6)
        out["zu"] = (js2, jr2, ts2, tr2)

    # decompose (exact-SVD TT-SVD) and eval
    jdec = jax.jit(lambda vs: jax_decompose(vs, plan_j))(jvars)
    tdec = decompose_params(tm.state_dict(), plan_t)
    jc = jax_model("ttm_resnet32", num_classes=10, ratio="3")
    tc = create_model("ttm_resnet32", ratio="3")
    tc.load_state_dict(tdec)
    out["ratio"] = (jax_ratio(jvars, jdec), compression_ratio(tm, tc))
    out["dec"] = (jax_to_state_dict(jax.tree.map(np.asarray, jdec)), tdec)
    xe = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out["eval"] = (np.asarray(jax.jit(jc.apply)(jdec, jnp.asarray(xe))),
                       tc.eval()(torch.from_numpy(xe).permute(0, 3, 1, 2)).numpy())
    return out


def test_programs_bucket_every_layer_as_tt_conv(slice_run):
    kinds_j, kinds_t = slice_run["kinds"]
    assert kinds_j == kinds_t == {"tt_conv"}


def test_first_projection_matches_jax(slice_run):
    js, ts = slice_run["z0"]
    for n in ts.z:
        # same weights, same float32 iteration: summation order only
        assert _rel(ts.z[n].permute(2, 3, 1, 0).numpy(), js.z[n]) < 1e-4, n


def test_x_step_loss_matches_jax(slice_run):
    loss_j, loss_t = slice_run["loss"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)


def test_zu_step_after_x_step_matches_jax(slice_run):
    js2, jr2, ts2, tr2 = slice_run["zu"]
    assert set(jr2) == set(tr2) and len(tr2) == 30
    for n in jr2:
        z_t = ts2.z[n].permute(2, 3, 1, 0).numpy()
        # the port's weights are the JAX side's, carried over exactly
        assert _rel(z_t, js2.z[n]) < 1e-4, n
        # U += W - Z differs only by Z's difference (on a full-rank layer U
        # is rounding alone, so it is held against the size of Z)
        u_t = ts2.u[n].permute(2, 3, 1, 0).numpy()
        assert np.linalg.norm(u_t - js2.u[n]) <= 1e-4 * np.linalg.norm(js2.z[n]), n
        np.testing.assert_allclose(float(tr2[n]), float(jr2[n]), rtol=1e-3,
                                   atol=1e-5, err_msg=n)


def test_decompose_ratio_and_kernels_match_jax(slice_run):
    r_j, r_t = slice_run["ratio"]
    assert r_t == pytest.approx(r_j, rel=1e-12) and round(r_t, 2) == 2.78
    jdec, tdec = slice_run["dec"]
    for name in get_rank_plan("resnet32", "tt", "3").names():
        prefix = name[:-len("weight")]
        # TT-SVD by exact SVD in two LAPACKs: cores may differ in sign, the
        # kernels they stand for only by float32 rounding at the rank cut
        assert _rel(_dense_from_tt(tdec, prefix),
                    _dense_from_tt(jdec, prefix)) < 1e-3, name


def test_eval_logits_of_decomposed_model_match_jax(slice_run):
    logits_j, logits_t = slice_run["eval"]
    assert logits_t.shape == (4, 10) and np.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-3, atol=1e-3)
