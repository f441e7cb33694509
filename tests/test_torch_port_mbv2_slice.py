"""The PyTorch port's MobileNetV2-CIFAR SVD@2x slice against the JAX
package: the svd_conv Z/U step by the port's kernel route (the Tucker-2
kernel as K = 1 at r0 = r1; its plain version on the CPU) against the JAX
package's Pallas route in interpret mode on three of the model's buckets,
[1, 1, 144, 24] at r = 18, [2, 1, 32, 192] and [2, 1, 192, 32] at r = 24;
the whole 28-layer plan layer by layer (exact SVD on both sides, whatever
the method); the kernel route's fit on the whole plan; then decompose and
the logits of the decomposed model.

Both sides start from the same weights (the port's dense model at full
width, its random init from a seed) and ADMM state, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.hp import SVDSpec as JaxSVDSpec
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, SVDSpec, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.layers.common import oihw_to_hwio
from dnn_compression_tensor_admm_tpu_torch.models import create_model, decompose_params
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)
from tests import torch_port_jax as jitted

# three buckets of the SVD 2 table: name -> rank
BUCKETS = {"bottlenecks.3.conv1.weight": 18,   # [144, 24]: resident, rp = 20
           "bottlenecks.4.conv3.weight": 24,   # [32, 192] x 2
           "bottlenecks.5.conv3.weight": 24,
           "bottlenecks.5.conv1.weight": 24,   # [192, 32] x 2
           "bottlenecks.6.conv1.weight": 24}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _zu_step(params_t, params_j, plan_t, plan_j, method, rng):
    """One Z/U step on both sides from the same weights and a state away
    from W; the port's "kernel" against the JAX package's "pallas" in
    interpret mode. -> (port state, port residuals, JAX state, JAX
    residuals, the port's program)."""
    tprog = teng.build_program(params_t, plan_t)
    jprog = jeng.build_program(params_j, plan_j)
    names = list(tprog.names)
    state = teng.AdmmState(
        u={n: torch.from_numpy(0.01 * rng.standard_normal(
            params_t[n].shape).astype(np.float32)) for n in names},
        z={n: params_t[n].detach().clone() for n in names})
    jstate = jeng.AdmmState(  # HWIO on the JAX side
        u={n: jnp.asarray(oihw_to_hwio(t.numpy())) for n, t in state.u.items()},
        z={n: jnp.asarray(oihw_to_hwio(t.numpy())) for n, t in state.z.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        js, jr = jitted.admm_update(
            params_j, jstate, jprog, update_u=True,
            method="pallas" if method == "kernel" else method, n_iter=6)
    ts, tr = teng.admm_update(params_t, state, tprog, update_u=True,
                              method=method, n_iter=6)
    return ts, tr, js, jr, tprog


@pytest.fixture(scope="module")
def slice_run(_one_torch_thread):
    rng = np.random.RandomState(0)
    dense = create_model("mobilenetv2_cifar",
                         generator=torch.Generator().manual_seed(0))
    sd = dense.state_dict()
    # non-trivial BN statistics, so the logits read them in eval mode
    for k, t in sd.items():
        if k.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif k.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    v = state_dict_to_jax(sd)
    params_t = dict(dense.named_parameters())
    params_j = v["params"]
    out = {"kernel": _zu_step(
        params_t, params_j,
        RankPlan("svd", {n: SVDSpec(r) for n, r in BUCKETS.items()}),
        JaxRankPlan("svd", {n: JaxSVDSpec(r) for n, r in BUCKETS.items()}),
        "kernel", rng)}
    plan_t = get_rank_plan("mobilenetv2_cifar", "svd", "2")
    plan_j = JaxRankPlan("svd", {n: JaxSVDSpec(s.rank)
                                 for n, s in plan_t.layers.items()})
    out["plan_svd"] = _zu_step(params_t, params_j, plan_t, plan_j, "svd", rng)

    # decompose the dense model's weights on both sides, then the logits
    jdec = jax.tree.map(np.asarray, jitted.decompose(v, plan_j))
    tdec = decompose_params(jax_to_state_dict(v), plan_t)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jlogits = jitted.apply(jax_model("svdc_mobilenetv2_cifar", num_classes=10,
                                      ratio="2"), jdec, jnp.asarray(x))
    tc = create_model("svdc_mobilenetv2_cifar", ratio="2")
    tc.load_state_dict(tdec)
    with torch.no_grad():
        tlogits = tc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    out["dec"] = (jax_to_state_dict(jdec), tdec, plan_t,
                  np.asarray(jlogits), tlogits.numpy())
    out["dense"] = (params_t, plan_t)
    return out


def _check_zu(run, tol):
    ts, tr, js, jr, _ = run
    assert set(jr) == set(tr) == set(ts.z)
    for n in tr:
        z_t = oihw_to_hwio(ts.z[n].numpy())
        assert _rel(z_t, js.z[n]) < tol, n
        u_t = oihw_to_hwio(ts.u[n].numpy())
        assert np.linalg.norm(u_t - js.u[n]) <= tol * np.linalg.norm(js.z[n]), n
        np.testing.assert_allclose(float(tr[n]), float(jr[n]), rtol=tol,
                                   err_msg=n)


def test_zu_step_on_three_buckets_matches_the_pallas_kernel(slice_run):
    run = slice_run["kernel"]
    buckets = []
    for g in run[4].groups:
        o, i = g.param_shape[:2]
        r = g.spec.rank
        buckets.append((g.kind, len(g.names), o, i, r,
                        tk.plan_name(1, o, i, r, r),
                        tk.kernel_supported((len(g.names), 1, o, i), r, r)))
    assert sorted(buckets) == [
        ("svd_conv", 1, 144, 24, 18, "resident", True),
        ("svd_conv", 2, 32, 192, 24, "resident", True),
        ("svd_conv", 2, 192, 32, 24, "resident", True)]
    # the same float32 iteration (the Tucker-2 kernel at K = 1, r0 = r1),
    # summed in another order
    _check_zu(run, 1e-4)


def test_zu_step_on_the_whole_plan_matches_jax_exact_svd(slice_run):
    run = slice_run["plan_svd"]
    assert len(run[4].groups) == 16 and len(run[0].z) == 28
    # exact SVDs in two LAPACKs: Z by float32 rounding at the rank cut
    _check_zu(run, 1e-4)


@pytest.mark.parametrize("method", ["kernel", "subspace"])
def test_other_methods_fit_the_plan_as_well_as_exact_svd(slice_run, method):
    # the kernel route (its plain version here: all 16 buckets pass the
    # gate) and 'subspace' (exact SVD for an SVD layer, as in JAX) against
    # exact SVD: ||Z - W|| / ||W|| within 0.02, chip_smoke.py's criterion
    params, plan = slice_run["dense"]
    program = teng.build_program(params, plan)
    state = teng.admm_init(params, program)
    errs = {}
    for m in ("svd", method):
        new, _ = teng.admm_update(params, state, program, update_u=False,
                                  method=m, n_iter=6)
        num = sum(torch.sum((new.z[n] - params[n].detach()) ** 2)
                  for n in program.names)
        den = sum(torch.sum(params[n].detach() ** 2) for n in program.names)
        errs[m] = (num / den).sqrt().item()
    assert errs["svd"] <= errs[method] <= errs["svd"] + 0.02, errs
    if method == "subspace":
        assert errs[method] == errs["svd"]


def test_decompose_matches_jax(slice_run):
    jdec, tdec, plan, _, _ = slice_run["dec"]
    assert set(jdec) == set(tdec)
    for name in plan.names():
        p = name[:-len("weight")]
        w_t, w_j = ((sd[p + "last_factor"] @ sd[p + "first_factor"]).numpy()
                    for sd in (tdec, jdec))
        # exact SVDs in two LAPACKs: factors may differ in sign, the
        # weights they stand for by float32 rounding at the rank cut
        assert _rel(w_t, w_j) < 1e-4, name
    for k in tdec:  # everything else is carried through
        if not k.endswith(("first_factor", "last_factor")):
            np.testing.assert_array_equal(tdec[k].numpy(), jdec[k].numpy(),
                                          err_msg=k)


def test_decomposed_logits_match_jax(slice_run):
    _, _, _, jlogits, tlogits = slice_run["dec"]
    assert tlogits.shape == (2, 10) and np.isfinite(tlogits).all()
    # float32 through ~54 layers in two frameworks
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
