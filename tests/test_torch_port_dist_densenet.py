"""The data-parallel X-step of an ImageNet DenseNet, whose dense layers are
recomputed in the backward (`torch.utils.checkpoint`; the JAX package's
`nn.remat`), over 2 gloo ranks in processes of their own
(`torch_port_dist_workers.py`), against the JAX package's X-step on the
same batch sharded over a 2 x 1 mesh's 'data' axis.

A module fixture runs one 2-rank job: one X-step with the ADMM penalty of
DenseNet121's TK@2x plan (cut to the model's layers) on the DenseNet of
tests/test_torch_port_zoo_models.py (block config (2, 2, 2, 2), 64 x 64),
each rank holding 4 of the batch's 8 rows. Its BatchNorms normalise by the
global batch in the forward and again in the recompute, and move their
running statistics once, in the forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_dist_workers as w
from test_torch_port_dist_train import RUN_RTOL, UPDATE_RTOL
from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models.densenet import (
    DenseNetInet as JaxDenseNetInet)
from dnn_compression_tensor_admm_tpu.parallel.mesh import make_mesh as jax_mesh
from dnn_compression_tensor_admm_tpu.train.losses import cross_entropy as jax_ce
from dnn_compression_tensor_admm_tpu.train.optim import make_optimizer, make_schedule
from dnn_compression_tensor_admm_tpu_torch.models.densenet import (
    RematBatchNorm2d)
from dnn_compression_tensor_admm_tpu_torch.parallel.data_parallel import (
    GlobalBatchNorm2d, GlobalRematBatchNorm2d, convert_global_batchnorm)
from dnn_compression_tensor_admm_tpu_torch.parallel.launch import (
    file_init_method, spawn)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("densenet2")
    spawn(w.densenet_job, 2, file_init_method(str(d)), str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)["xstep"]
            for r in range(2)]


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's X-step (remat on, as registered) on the same 8
    rows sharded over a 2 x 1 mesh's 'data' axis: loss, parameters before
    and after, and the batch statistics after it as port buffers."""
    model, program, state, x, y = w.densenet_xstep_inputs()
    v = state_dict_to_jax(model.state_dict())
    plan = jax_plan("densenet121", "tk", "2")
    plan = dataclasses.replace(plan, layers={
        n: s for n, s in plan.layers.items() if n in program.names})
    jprog = jeng.build_program(v["params"], plan)
    hwio = lambda t: jnp.asarray(t.permute(2, 3, 1, 0).numpy())  # noqa: E731
    js = jeng.AdmmState(u={n: hwio(state.u[n]) for n in jprog.paths},
                        z={n: hwio(state.z[n]) for n in jprog.paths})
    mesh = jax_mesh(n_data=2, n_layer=1, devices=jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    ys = jax.device_put(jnp.asarray(y.astype(np.int32)),
                        NamedSharding(mesh, P("data")))
    jm = JaxDenseNetInet(block_config=w.DENSENET_BLOCKS)
    assert jm.remat

    def loss_fn(p, xb, yb):
        logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               xb, train=True, mutable=["batch_stats"])
        return (jax_ce(logits, yb, w.SMOOTHING)
                + jeng.admm_penalty(p, js, jprog, w.RHO)), mut

    (loss, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], xs, ys)
    tx = make_optimizer("momentum", make_schedule("cosine", w.LR, 1, 1,
                                                  min_lr=1e-5))
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    stats = jax_to_state_dict({"batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    return dict(loss=float(loss), before=v["params"],
                after=optax.apply_updates(v["params"], upd), stats=stats,
                layers=len(program.names))


def test_densenet_data_parallel_x_step_matches_jax_sharded_step(ranks,
                                                                 jax_step):
    """Loss, each parameter's update and every running mean to the
    tolerances of the ResNet32 step's test (test_torch_port_dist_train.py),
    the running variances through torch's n / (n - 1); each running
    statistic moved once, and both ranks end equal."""
    assert jax_step["layers"] == 11  # the plan's layers of this DenseNet
    (loss0, after0, buf0), (loss1, after1, buf1) = ranks
    # each rank's loss is its rows' mean plus the penalty
    np.testing.assert_allclose((loss0 + loss1) / 2, jax_step["loss"],
                               rtol=RUN_RTOL)
    for n in after0:  # the ranks step alike
        assert torch.equal(after0[n], after1[n]), n
    for n in buf0:
        assert torch.equal(buf0[n], buf1[n]), n
    back = state_dict_to_jax(after0)["params"]
    flat = [jax.tree_util.tree_flatten_with_path(t)[0]
            for t in (jax_step["before"], jax_step["after"], back)]
    for (p, w0), (_, wj), (_, wt) in zip(*flat):
        dj, dt = np.asarray(wj) - np.asarray(w0), wt - np.asarray(w0)
        assert np.linalg.norm(dt - dj) <= UPDATE_RTOL * np.linalg.norm(dj), \
            str(p)
    counts = [n for n in buf0 if n.endswith("num_batches_tracked")]
    assert len(counts) == 2 * 8 + 3 + 2  # dense layers, transitions, ends
    for name in counts:
        bn = name[:-len("num_batches_tracked")]
        # one update a step: a recompute that updated again would count 2
        assert int(buf0[name]) == 1, bn
        np.testing.assert_allclose(buf0[bn + "running_mean"].numpy(),
                                   jax_step["stats"][bn + "running_mean"],
                                   rtol=1e-4, atol=1e-6, err_msg=bn)
        # from 1: torch folds in the unbiased variance, flax the biased
        n_vals = 8 * np.prod(_spatial(bn))
        var_t = (buf0[bn + "running_var"].numpy() - 0.9) / 0.1
        var_j = (jax_step["stats"][bn + "running_var"].numpy() - 0.9) / 0.1
        np.testing.assert_allclose(var_t * (n_vals - 1) / n_vals, var_j,
                                   rtol=1e-4, atol=1e-6, err_msg=bn)


def _spatial(bn: str):
    """The map size a BatchNorm of the DenseNet sees at 64 x 64."""
    if bn.startswith("features.norm0"):
        return (32, 32)
    if bn.startswith("features.norm5"):
        return (2, 2)
    block = int(bn.split("denseblock")[1][0]) if "denseblock" in bn else \
        int(bn.split("transition")[1][0])
    side = 16 >> (block - 1)
    return (side, side)


def test_convert_global_batchnorm_takes_the_recomputed_batchnorm():
    model = w.densenet_xstep_inputs()[0]
    convert_global_batchnorm(model, None, 2)
    kinds = {type(m) for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)}
    assert kinds == {GlobalBatchNorm2d, GlobalRematBatchNorm2d}
    layer = model.features.denseblock1.denselayer1
    assert type(layer.norm1) is GlobalRematBatchNorm2d


@pytest.mark.parametrize("bn", [torch.nn.BatchNorm1d(4),
                                torch.nn.SyncBatchNorm(4),
                                type("OwnBatchNorm2d", (RematBatchNorm2d,),
                                     {})(4)],
                         ids=["batchnorm1d", "syncbatchnorm", "subclass"])
def test_convert_global_batchnorm_raises_for_a_batchnorm_it_does_not_know(bn):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), bn)
    with pytest.raises(NotImplementedError, match="no global-batch form"):
        convert_global_batchnorm(model, None, 2)
