"""The PyTorch port's DeiT-small TT@2x against the JAX package, at a cut
depth: a 2-block DeiT-small (embed 384, 6 heads, its blocks 0 and 1 with
their TT 2 specs) at 64 x 64, dense and `ttm_` logits, `decompose_params`
of block 0 (compared by the decomposed model's logits, never by cores),
one Z/U step
(the two attention projections, at r = 320 and r = 256 near full rank, by
the kernel route against the JAX package's Pallas route in interpret
mode; the other six layers by exact SVD on both sides), and the plain
subspace iteration near full rank against the Pallas kernel. The full
model's parameter counts and ratio are the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import (
    compression_ratio as jax_ratio, create_model as jax_model,
    decompose_params as jax_decompose)
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.ops.pallas import (
    dominant_left_subspace_batched as jax_subspace)
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, count_params, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)

NAME = "deit_small_patch16_224"
DIM, HEADS, DEPTH, IMG = 384, 6, 2, 64
# Pallas-gated buckets: [352, 384] at r = 320 and [288, 384] at r = 256
PROJ = ("blocks.0.attn.proj.weight", "blocks.1.attn.proj.weight")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _plans(names=None):
    """The TT 2 plan of blocks 0 and 1 (or of `names`), in both packages."""
    plan_j, plan_t = jax_plan(NAME, "tt", "2"), get_rank_plan(NAME, "tt", "2")
    names = names or [n for n in plan_t.names()
                      if n.startswith(("blocks.0.", "blocks.1."))]
    return (JaxRankPlan("tt", {n: plan_j.spec(n) for n in names}),
            RankPlan("tt", {n: plan_t.spec(n) for n in names}))


def _models(plan_j=None, plan_t=None):
    kw = dict(img_size=IMG, embed_dim=DIM, depth=DEPTH, num_heads=HEADS,
              num_classes=1000, drop_path_rate=0.0)
    mode = {} if plan_t is None else {"mode": "factorized"}
    return (JaxViT(plan=plan_j, **mode, **kw),
            VisionTransformer(plan=plan_t, generator=torch.Generator()
                              .manual_seed(0), **mode, **kw).eval())


def _logits(jm, tm, variables, x):
    with torch.no_grad():
        lt = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    lj = np.asarray(jm.apply(variables, jnp.asarray(x)))
    return lt, lj


@pytest.fixture(scope="module")
def dense():
    jm, tm = _models()
    x = np.random.RandomState(1).standard_normal(
        (2, IMG, IMG, 3)).astype(np.float32)
    return jm, tm, state_dict_to_jax(tm.state_dict()), x


def test_dense_logits_match_jax(dense):
    jm, tm, v, x = dense
    lt, lj = _logits(jm, tm, v, x)
    assert lt.shape == (2, 1000)
    # float32 through two blocks in two frameworks
    assert np.abs(lt - lj).max() <= 1e-5 * np.abs(lj).max()


def test_decompose_and_compressed_logits_match_jax(dense):
    """Block 0's four layers (r = 320 in the middle); block 1 stays dense
    (the JAX side compiles each layer's TT-SVD: 0.8 s a layer)."""
    jm, tm, v, x = dense
    plan_j, plan_t = _plans([n for n in get_rank_plan(NAME, "tt", "2").names()
                             if n.startswith("blocks.0.")])
    jdec = jax.tree.map(np.asarray, jax_decompose(v, plan_j))
    tdec = decompose_params(tm.state_dict(), plan_t)
    jc, tc = _models(plan_j, plan_t)
    tc.load_state_dict(tdec)
    # each package's decomposition through its own model, then across:
    # the JAX cores in the port's model
    lt, lj = _logits(jc, tc, jdec, x)
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()
    tc.load_state_dict(jax_to_state_dict(jdec))
    lt2, _ = _logits(jc, tc, jdec, x)
    assert np.abs(lt2 - lj).max() <= 1e-5 * np.abs(lj).max()
    assert compression_ratio(tm, tc) == jax_ratio(v, jdec)


@pytest.fixture(scope="module")
def zu_step(dense):
    _, tm, v, _ = dense
    rng = np.random.RandomState(2)
    params = dict(tm.named_parameters())
    plan_j, plan_t = _plans()
    tprog = teng.build_program(params, plan_t)
    state = teng.AdmmState(
        u={n: torch.from_numpy(0.01 * rng.standard_normal(params[n].shape)
                               .astype(np.float32)) for n in tprog.names},
        z={n: params[n].detach().clone() for n in tprog.names})
    out = {}
    for names, t_method, j_method in (
            (PROJ, "kernel", "pallas"),
            ([n for n in tprog.names if n not in PROJ], "svd", "svd")):
        sub_j, sub_t = _plans(list(names))
        jprog = jeng.build_program(v["params"], sub_j)
        tsub = teng.build_program(params, sub_t)
        ts = teng.AdmmState(u={n: state.u[n] for n in names},
                            z={n: state.z[n] for n in names})
        js = jeng.AdmmState(
            u={n: jnp.asarray(ts.u[n].numpy().T) for n in names},
            z={n: jnp.asarray(ts.z[n].numpy().T) for n in names})
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DCTA_PALLAS_INTERPRET", "1")
            js2, jr2 = jeng.admm_update(v["params"], js, jprog, update_u=True,
                                        method=j_method, n_iter=6)
        ts2, tr2 = teng.admm_update(params, ts, tsub, update_u=True,
                                    method=t_method, n_iter=6)
        out[t_method] = (names, js2, jr2, ts2, tr2)
    return out


# Z against the JAX package's, relative. The kernel route: the same
# float32 iteration near full rank (r / min(rows, cols) = 0.91 and 0.89),
# summed in another order. The svd route: exact SVDs in two LAPACKs, which
# cut a flat random spectrum where neighbouring singular values lie ~1e-4
# apart, so the weights they stand for agree to the float32 rounding at
# the cut (2.2e-4 seen), as decompose's do in the DeiT-tiny slice tests.
ZU_TOL = {"kernel": 1e-4, "svd": 1e-3}


@pytest.mark.parametrize("route", ["kernel", "svd"])
def test_zu_step_matches_jax(zu_step, route):
    names, js2, jr2, ts2, tr2 = zu_step[route]
    tol = ZU_TOL[route]
    assert set(jr2) == set(tr2) == set(names)
    assert int(ts2.nonfinite) == 0
    for n in names:
        z_t = ts2.z[n].numpy().T
        assert _rel(z_t, js2.z[n]) < tol, n
        u_t = ts2.u[n].numpy().T
        assert np.linalg.norm(u_t - js2.u[n]) <= tol * np.linalg.norm(js2.z[n]), n
        np.testing.assert_allclose(float(tr2[n]), float(jr2[n]), rtol=tol,
                                   err_msg=n)


@pytest.mark.parametrize("L,rows,cols,r", [
    (2, 72, 96, 64),    # wide at r / rows = 0.89, as [352, 384] at 320
    (2, 96, 72, 64),    # tall at r / cols = 0.89: the lift
])
def test_plain_matches_pallas_near_full_rank(L, rows, cols, r):
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    q_j = np.asarray(jax_subspace(jnp.asarray(t), r, iters=8, interpret=True))
    q_t = sk.dominant_left_subspace_batched(torch.from_numpy(t), r,
                                            iters=8).numpy()
    # products, not factors: the projectors and the projected slices
    proj_t = q_t @ q_t.transpose(0, 2, 1)
    proj_j = q_j @ q_j.transpose(0, 2, 1)
    assert np.linalg.norm(proj_t - proj_j, axis=(1, 2)).max() < 1e-4
    assert _rel(proj_t @ t, proj_j @ t) < 1e-5


def test_parameter_counts_and_ratio_equal_jax():
    """At 224 x 224: 22,050,664 parameters dense, 14,391,736 compressed."""
    dense_t = create_model(NAME)
    comp_t = create_model(f"ttm_{NAME}", ratio="2")
    x = jnp.zeros((1, 224, 224, 3))
    vd = jax.eval_shape(jax_model(NAME).init, jax.random.PRNGKey(0), x)
    vc = jax.eval_shape(jax_model(f"ttm_{NAME}", ratio="2").init,
                        jax.random.PRNGKey(0), x)
    assert (count_params(dense_t), count_params(comp_t)) == (22_050_664,
                                                             14_391_736)
    assert compression_ratio(dense_t, comp_t) == jax_ratio(vd, vc)
    assert round(jax_ratio(vd, vc), 2) == 1.53
