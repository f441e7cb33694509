"""The PyTorch port's ImageNet ResNet-50 slice against the JAX package:
the Z/U step by the port's kernel route (the plain versions on the CPU)
against the JAX package's Pallas route in interpret mode on three of
the model's buckets (a 1x1 TT conv [256, 1, 1024] at rank 75, a 3x3 TT
conv of shapes (8, 8, 9, 8, 8), and a K = 9 Tucker-2 conv beside an SVD
1x1 conv in one plan); the whole TT@3x plan layer by layer by exact SVD
on both sides; the whole TK@3x plan (tk_conv and svd_conv buckets)
through one kernel-route step; then decompose to ttm_resnet50 (1x1 and
strided 3x3 TT convs) and the logits of the decomposed model.

Exact SVD at a random init cuts flat spectra, where the singular
subspace at the rank cut moves ~1000 times float32 rounding; those
comparisons hold Z to 2e-3 and the fit ||W - Z|| to 1e-4.

Both sides start from the same weights (the port's dense ResNet-50 at
full width, its random init from a seed) and ADMM state, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.ops.pallas.subspace_kernel import tt_supported_pallas
from dnn_compression_tensor_admm_tpu.ops.pallas.tucker_kernel import pallas_tk_supported
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.layers.common import oihw_to_hwio
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.ops.contractions import merge_tt_matrix
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)
from tests import torch_port_jax as jitted

# the buckets held against the Pallas kernels, one layer each
TT_LAYERS = ("layer3.1.conv1.weight",   # 1x1, (256, 1, 1024) at 75
             "layer1.1.conv2.weight")   # 3x3, (8, 8, 9, 8, 8) at 55
TK_LAYERS = ("layer1.0.conv2.weight",   # tk_conv [1, 9, 64, 64] at 32/64
             "layer1.1.conv3.weight")   # svd_conv [256, 64] at 32


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


def _dense_from_tt(sd, prefix):
    """The dense OIHW kernel a TT layer's parameters stand for."""
    def chain(kind):
        names = sorted((k for k in sd if k.startswith(f"{prefix}{kind}_core_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        return merge_tt_matrix([sd[k] for k in names])
    w = torch.einsum("oa,abhw->obhw", chain("out"), sd[prefix + "core_kernel"])
    return torch.einsum("obhw,bi->oihw", w, chain("in")).numpy()


def _subset(plan, cls, names):
    return cls(plan.fmt, {n: plan.layers[n] for n in names})


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
    dense = create_model("resnet50", generator=torch.Generator().manual_seed(0))
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
    tt_t, tt_j = get_rank_plan("resnet50", "tt", "3"), jax_plan("resnet50",
                                                                "tt", "3")
    tk_t, tk_j = get_rank_plan("resnet50", "tk", "3"), jax_plan("resnet50",
                                                                "tk", "3")
    out = {
        "tt_kernel": _zu_step(params_t, params_j,
                              _subset(tt_t, RankPlan, TT_LAYERS),
                              _subset(tt_j, JaxRankPlan, TT_LAYERS),
                              "kernel", rng),
        "tk_kernel": _zu_step(params_t, params_j,
                              _subset(tk_t, RankPlan, TK_LAYERS),
                              _subset(tk_j, JaxRankPlan, TK_LAYERS),
                              "kernel", rng),
        "tt_svd": _zu_step(params_t, params_j, tt_t, tt_j, "svd", rng),
        "dense": (dense, params_t, tk_t)}

    # decompose the dense model's weights on both sides, then the logits
    jdec = jax.tree.map(np.asarray, jitted.decompose(v, tt_j))
    tdec = decompose_params(jax_to_state_dict(v), tt_t)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jlogits = jitted.apply(jax_model("ttm_resnet50", num_classes=1000,
                                      ratio="3"), jdec, jnp.asarray(x))
    tc = create_model("ttm_resnet50", ratio="3")
    tc.load_state_dict(tdec)
    out["dec"] = (jax_to_state_dict(jdec), tdec, tt_t,
                  compression_ratio(dense, tc))
    # the forward of both packages on the same decomposed weights (the
    # JAX side's, carried across)
    tc.load_state_dict(out["dec"][0])
    with torch.no_grad():
        tlogits = tc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    out["logits"] = (np.asarray(jlogits), tlogits.numpy())
    return out


def _check_zu(run, tol, fit_tol=None):
    ts, tr, js, jr, _ = run
    assert set(jr) == set(tr) == set(ts.z)
    for n in tr:
        z_t = oihw_to_hwio(ts.z[n].numpy())
        assert _rel(z_t, js.z[n]) < tol, n
        u_t = oihw_to_hwio(ts.u[n].numpy())
        assert np.linalg.norm(u_t - js.u[n]) <= tol * np.linalg.norm(js.z[n]), n
        np.testing.assert_allclose(float(tr[n]), float(jr[n]),
                                   rtol=fit_tol or tol, err_msg=n)


def test_tt_zu_step_on_two_buckets_matches_the_pallas_kernel(slice_run):
    run = slice_run["tt_kernel"]
    launches = []
    for g in run[4].groups:
        spec = g.spec
        numel = int(np.prod(g.param_shape))
        assert tt_supported_pallas(1, numel, spec.tt_shapes, spec.tt_ranks)
        launches += [(rows, cols, r, sk.plan_name(rows, cols, r))
                     for rows, cols, r in sk.sweep_steps(spec.tt_shapes,
                                                         spec.tt_ranks)
                     if r != rows]
    # the 1x1 conv's one launch takes the workspace plan; the 3x3 conv's
    # first step is full rank (8 rows at rank 8) and launches nothing
    assert sorted(launches) == [(64, 576, 55, "padded"),
                                (256, 1024, 75, "workspace"),
                                (440, 8, 8, "padded"),
                                (495, 64, 55, "padded")]
    # the same float32 iteration (orthogonal iteration with Newton-Schulz),
    # summed in another order
    _check_zu(run, 1e-4)


def test_tk_and_svd_buckets_in_one_zu_step_match_the_pallas_kernel(slice_run):
    run = slice_run["tk_kernel"]
    buckets = []
    for g in run[4].groups:
        o, i, kh, kw = g.param_shape
        sp = teng.tk_ranks(g.spec, g.param_shape)
        shape = (len(g.names), kh * kw, o, i)
        assert pallas_tk_supported(shape)
        buckets.append((g.kind, shape, sp.out_rank, sp.in_rank,
                        tk.plan_name(*shape[1:], sp.out_rank, sp.in_rank)))
    assert sorted(buckets) == [
        ("svd_conv", (1, 1, 256, 64), 32, 32, "workspace"),
        ("tk_conv", (1, 9, 64, 64), 32, 64, "streamed")]
    _check_zu(run, 1e-4)


def test_tt_zu_step_on_the_whole_plan_matches_jax_exact_svd(slice_run):
    run = slice_run["tt_svd"]
    assert len(run[4].groups) == 12 and len(run[0].z) == 34
    # TT-SVD by exact SVDs in two LAPACKs at flat spectra (1.07e-3 seen,
    # layer4.0.conv2); the fit is well conditioned
    _check_zu(run, 2e-3, fit_tol=1e-4)


def test_tk_plan_runs_through_one_kernel_route_step(slice_run):
    # all 15 buckets, tk_conv (K = 9) and svd_conv (K = 1) at once, by
    # the kernel route (its plain version here: every bucket passes the
    # gate) against exact HOOI / SVD: ||Z - W|| / ||W|| within 0.02,
    # chip_smoke.py's criterion
    dense, params, plan = slice_run["dense"]
    program = teng.build_program(params, plan)
    assert {g.kind for g in program.groups} == {"tk_conv", "svd_conv"}
    state = teng.admm_init(params, program)
    errs = {}
    for m in ("svd", "kernel"):
        new, res = teng.admm_update(params, state, program, update_u=False,
                                    method=m, n_iter=6)
        assert len(res) == 44
        num = sum(torch.sum((new.z[n] - params[n].detach()) ** 2)
                  for n in program.names)
        den = sum(torch.sum(params[n].detach() ** 2) for n in program.names)
        errs[m] = (num / den).sqrt().item()
    assert errs["kernel"] <= errs["svd"] + 0.02, errs


def test_decompose_matches_jax(slice_run):
    jdec, tdec, plan, ratio = slice_run["dec"]
    assert set(jdec) == set(tdec)
    assert round(ratio, 2) == 2.51
    for name in plan.names():
        p = name[:-len("weight")]
        # TT-SVD by exact SVD in two LAPACKs: cores may differ in sign, the
        # kernels they stand for (1x1 and strided 3x3 alike) by rounding
        # at the flat rank cuts of a random init
        assert _rel(_dense_from_tt(tdec, p), _dense_from_tt(jdec, p)) < 2e-3, name
    for k in tdec:  # everything else is carried through
        if not any(s in k for s in ("_core_", "core_kernel")):
            np.testing.assert_array_equal(tdec[k].numpy(), jdec[k].numpy(),
                                          err_msg=k)


def test_decomposed_logits_match_jax(slice_run):
    jlogits, tlogits = slice_run["logits"]
    assert tlogits.shape == (2, 1000) and np.isfinite(tlogits).all()
    # float32 through ~50 layers in two frameworks, TT chains merged in
    # another order: the largest difference over the largest logit
    assert np.abs(tlogits - jlogits).max() <= 2e-5 * np.abs(jlogits).max()
