"""The PyTorch port's DeiT-tiny TT@2x slice against the JAX package: one
X-step (loss, gradients and the AdamW update, with the ADMM penalty), the
Z/U step on three representative tt_linear buckets, decompose to
ttm_deit_tiny_patch16_224 and the compression ratio.

DeiT-tiny at full width and depth with the full TT 2 plan, at a 32 x 32
input and batch 4, drop path off. Both sides start from the same weights
and take the same numpy inputs, in float32. The port's Z-step takes
`method="kernel"` (its plain version on the CPU), the JAX package's
`method="pallas"` with the Pallas kernels in interpret mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import (
    compression_ratio as jax_ratio, create_model as jax_model)
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.train.losses import cross_entropy as jax_ce
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda.subspace_kernel import tt_supported
from dnn_compression_tensor_admm_tpu_torch.ops.ttd import tt2ten
from dnn_compression_tensor_admm_tpu_torch.train.losses import cross_entropy
from dnn_compression_tensor_admm_tpu_torch.train.optim import make_optimizer
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)
from tests import torch_port_jax as jitted

NAME = "deit_tiny_patch16_224"
RHO, LR, WD, SMOOTHING = 1e-3, 5e-4, 1e-4, 0.1
# three buckets of one layer each: 720 x 192 at r = 96; 180 x 768 at r = 96
# and 2304 x 32 at r = 30; 144 x 768 at r = 96 and 2304 x 32 at r = 28
ZU_LAYERS = ("blocks.0.mlp.fc1.weight", "blocks.0.mlp.fc2.weight",
             "blocks.1.mlp.fc2.weight")


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


def _jax_state(state):
    """The port's ADMM state in the JAX package's layout (Dense [in, out])."""
    def to_jax(d):
        return {n: jnp.asarray(t.numpy().T) for n, t in d.items()}
    return jeng.AdmmState(u=to_jax(state.u), z=to_jax(state.z))


@pytest.fixture(scope="module")
def slice_run(_one_torch_thread):
    rng = np.random.RandomState(0)
    tm = create_model(NAME, img_size=32, drop_path_rate=0.0,
                      generator=torch.Generator().manual_seed(0))
    v = state_dict_to_jax(tm.state_dict())
    jm = JaxViT(img_size=32, embed_dim=192, depth=12, num_heads=3,
                num_classes=1000, drop_path_rate=0.0)
    params = dict(tm.named_parameters())
    plan_j, plan_t = jax_plan(NAME, "tt", "2"), get_rank_plan(NAME, "tt", "2")
    jprog = jeng.build_program(v["params"], plan_j)
    tprog = teng.build_program(params, plan_t)
    out = {"kinds": ({g.kind for g in jprog.groups},
                     {g.kind for g in tprog.groups})}

    # an ADMM state away from W, the same on both sides
    ts = teng.AdmmState(
        u={n: torch.from_numpy(0.01 * rng.standard_normal(params[n].shape)
                               .astype(np.float32)) for n in tprog.names},
        z={n: params[n].detach() + torch.from_numpy(
            0.01 * rng.standard_normal(params[n].shape).astype(np.float32))
           for n in tprog.names})
    js = _jax_state(ts)

    # one X-step: loss, gradients and the AdamW update
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 1000, 4).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return (jax_ce(logits, jnp.asarray(y), SMOOTHING)
                + jeng.admm_penalty(p, js, jprog, RHO))
    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    tx = optax.adamw(LR, weight_decay=WD)
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    jparams = optax.apply_updates(v["params"], upd)
    opt = make_optimizer(tm.parameters(), LR, opt="adamw", weight_decay=WD)
    tm.train()
    logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                torch.Generator().manual_seed(0))
    loss_t = cross_entropy(logits, torch.from_numpy(y), SMOOTHING) \
        + teng.admm_penalty(params, ts, tprog, RHO)
    opt.zero_grad()
    loss_t.backward()
    grads_t = {n: p.grad.clone() for n, p in params.items()}
    opt.step()
    out["x_step"] = (float(loss_j), loss_t.item(),
                     state_dict_to_jax(grads_t)["params"], grads,
                     state_dict_to_jax(tm.state_dict())["params"], jparams)

    # the Z/U step on three buckets, from the same weights and state
    sub_j = JaxRankPlan("tt", {n: plan_j.spec(n) for n in ZU_LAYERS})
    sub_t = RankPlan("tt", {n: plan_t.spec(n) for n in ZU_LAYERS})
    jsub = jeng.build_program(jparams, sub_j)
    tsub = teng.build_program(params, sub_t)
    ts_sub = teng.AdmmState(u={n: ts.u[n] for n in ZU_LAYERS},
                            z={n: ts.z[n] for n in ZU_LAYERS})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        js2, jr2 = jitted.admm_update(jparams, _jax_state(ts_sub), jsub,
                                      update_u=True, method="pallas", n_iter=6)
    ts2, tr2 = teng.admm_update(params, ts_sub, tsub, update_u=True,
                                method="kernel", n_iter=6)
    # every bucket takes the kernel route (its plain version on the CPU)
    gated = [tt_supported(len(g.names), math.prod(g.param_shape),
                          g.spec.tt_shapes, g.spec.tt_ranks)
             for g in tsub.groups]
    out["zu"] = (js2, jr2, ts2, tr2, gated)

    # decompose (exact-SVD TT-SVD) of the JAX side's stepped weights
    jvars = {"params": jparams}
    out["dec"] = (jax.tree.map(np.asarray, jitted.decompose(jvars, plan_j)),
                  decompose_params(jax_to_state_dict(jvars), plan_t))
    return out


def test_programs_bucket_every_layer_as_tt_linear(slice_run):
    kinds_j, kinds_t = slice_run["kinds"]
    assert kinds_j == kinds_t == {"tt_linear"}


def test_x_step_matches_jax(slice_run):
    loss_j, loss_t, grads_t, grads_j, params_t, params_j = slice_run["x_step"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(grads_j)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    assert flat_j.keys() == flat_t.keys() and len(flat_t) == 152
    for path in flat_j:
        # float32 gradients through 12 blocks in two frameworks (~1e-5 seen),
        # held within 1% as in the TT slice tests
        assert _rel(flat_t[path], flat_j[path]) < 1e-2, path
    flat_pj = dict(jax.tree_util.tree_flatten_with_path(params_j)[0])
    flat_pt = dict(jax.tree_util.tree_flatten_with_path(params_t)[0])
    for path in flat_pj:
        # AdamW's first step moves each weight by lr * g / (|g| + eps) plus
        # the decay: by about lr wherever g is not within rounding of 0
        # (the key bias's gradient is 0 up to rounding, so its sign is
        # noise); there the two sides agree to float32 rounding of the
        # weight, 2 ulp (1e-7 is 0.02% of lr)
        np.testing.assert_allclose(flat_pt[path], flat_pj[path], rtol=0,
                                   atol=2 * LR, err_msg=str(path))
        g = np.abs(np.asarray(flat_j[path]))
        big = g > 1e-3 * g.max()
        assert big.any(), path
        np.testing.assert_allclose(flat_pt[path][big],
                                   np.asarray(flat_pj[path])[big],
                                   rtol=2.4e-7, atol=1e-7, err_msg=str(path))


def test_zu_step_on_three_buckets_matches_jax(slice_run):
    js2, jr2, ts2, tr2, gated = slice_run["zu"]
    assert gated == [True] * 3
    assert set(jr2) == set(tr2) == set(ZU_LAYERS)
    for n in ZU_LAYERS:
        z_t = ts2.z[n].numpy().T
        # the same float32 iteration: summation order only
        assert _rel(z_t, js2.z[n]) < 1e-4, n
        u_t = ts2.u[n].numpy().T
        assert np.linalg.norm(u_t - js2.u[n]) <= 1e-4 * np.linalg.norm(js2.z[n]), n
        np.testing.assert_allclose(float(tr2[n]), float(jr2[n]), rtol=1e-4,
                                   err_msg=n)


def test_decompose_matches_jax(slice_run):
    jdec, tdec = slice_run["dec"]
    jdec = jax_to_state_dict(jdec)
    assert set(jdec) == set(tdec)
    plan = get_rank_plan(NAME, "tt", "2")
    for name in plan.names():
        spec = plan.spec(name)
        prefix = name[:-len("weight")]
        n = len(spec.tt_shapes)
        w_t, w_j = (tt2ten([sd[f"{prefix}core_{j}"] for j in range(n)],
                           spec.tt_shapes).numpy() for sd in (tdec, jdec))
        # exact SVDs in two LAPACKs: cores may differ in sign, the weights
        # they stand for only by float32 rounding at the rank cut
        assert _rel(w_t, w_j) < 1e-3, name
    for k in tdec:  # everything else is carried through
        if "core_" not in k:
            np.testing.assert_array_equal(tdec[k].numpy(), jdec[k].numpy(),
                                          err_msg=k)


def test_compression_ratio_equals_jax():
    """At 224 x 224, the configuration's own input: 5,717,416 parameters
    dense, 3,036,552 compressed."""
    dense = create_model(NAME)
    compressed = create_model(f"ttm_{NAME}", ratio="2")
    ratio = compression_ratio(dense, compressed)
    x = jnp.zeros((1, 224, 224, 3))
    vd = jax.eval_shape(jax_model(NAME).init, jax.random.PRNGKey(0), x)
    vc = jax.eval_shape(jax_model(f"ttm_{NAME}", ratio="2").init,
                        jax.random.PRNGKey(0), x)
    assert ratio == jax_ratio(vd, vc) == 5_717_416 / 3_036_552
    assert round(ratio, 2) == 1.88
