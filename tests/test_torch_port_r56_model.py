"""CIFAR ResNet56 Tucker-2 @3x in the PyTorch port against the JAX
package, on the same weights (moved by the port's `utils/jax_weights.py`)
and inputs, in float32: the dense logits, the Z-step's buckets and ranks,
the parameter counts, decompose, and the compressed model's logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.models import decompose_params as jax_decompose
from dnn_compression_tensor_admm_tpu.models.decompose import count_params as jax_count
from dnn_compression_tensor_admm_tpu_torch.admm import build_program
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.configs.hp import RankPlan
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, count_params, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax

# float32 convolutions through 57 layers in two frameworks (ResNet32's 35
# agree within 1e-4 in test_torch_port_models.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# (layers, out rank, in rank) of ResNet56 TK@3x's 10 buckets, by shape
BUCKETS = [(2, 16, 16), (8, 14, 14), (8, 13, 13), (1, 32, 16), (9, 20, 20),
           (8, 18, 18), (1, 40, 20), (5, 26, 26), (5, 24, 24), (7, 22, 22)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dense():
    """The port's ResNet56 at a seeded init with random BatchNorm
    statistics (so eval mode reads them), and its weights in JAX layout."""
    tm = create_model("resnet56", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.1, b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)))
    return tm.eval(), state_dict_to_jax(tm.state_dict())


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)


def _logits(tm, jm, v, x):
    with torch.no_grad():
        t = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return t, np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))


def test_dense_logits_match_jax(dense, images):
    tm, v = dense
    logits_t, logits_j = _logits(tm, jax_model("resnet56", num_classes=10), v,
                                 images)
    assert logits_t.shape == (2, 10) and np.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t, logits_j, **LOGIT_TOL)


def test_program_buckets_and_ranks_match_jax(dense):
    tm, v = dense
    tprog = build_program(dict(tm.named_parameters()),
                          get_rank_plan("resnet56", "tk", "3"))
    jprog = jeng.build_program(v["params"], jax_plan("resnet56", "tk", "3"))

    def buckets(prog):
        return sorted((g.names, g.spec.out_rank, g.spec.in_rank)
                      for g in prog.groups)

    assert buckets(tprog) == buckets(jprog)
    assert len(tprog.names) == 54
    assert [(len(g.names), g.spec.out_rank, g.spec.in_rank)
            for g in tprog.groups] == BUCKETS


@pytest.mark.parametrize("name,params", [("resnet56", 853_018),
                                         ("tkc_resnet56", 275_266),
                                         ("ttm_resnet56", 275_266)])
def test_parameter_counts_match_jax(name, params):
    kw = {"ratio": "3"} if name != "resnet56" else {}
    jm = jax_model(name, num_classes=10, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    assert count_params(create_model(name, **kw)) == params
    assert jax_count(shapes["params"]) == params


# one layer of each of three buckets: full rank in both modes (32/16), a
# transition (40/20) and the widest bucket (22/22); the JAX package's
# decompose of all 54 layers takes ~2 minutes here
DECOMPOSED = ("layer2.0.conv1.weight", "layer3.0.conv1.weight",
              "layer3.8.conv2.weight")


@pytest.mark.parametrize("name", DECOMPOSED)
def test_decompose_matches_jax(dense, name):
    tm, v = dense
    spec = get_rank_plan("resnet56", "tk", "3").spec(name)
    tsd = decompose_params(tm.state_dict(), RankPlan("tk", {name: spec}))
    jplan = jax_plan("resnet56", "tk", "3")
    jv = jax_decompose(v, JaxRankPlan("tk", {name: jplan.spec(name)}))
    blk, conv = name.rsplit(".", 2)[0], name.split(".")[2]
    jl = jv["params"][blk][conv]
    w_j = np.einsum("oa,hwba,bi->oihw", jl["last_factor"], jl["core_kernel"],
                    jl["first_factor"])
    prefix = name[:-len("weight")]
    w_t = torch.einsum("oa,abhw,bi->oihw", tsd[prefix + "last_factor"],
                       tsd[prefix + "core_kernel"],
                       tsd[prefix + "first_factor"]).numpy()
    # exact-SVD HOSVD + 10 HOOI sweeps on both sides: the singular values
    # at the rank cut of these random kernels lie ~1% apart, so float32
    # HOOI agrees to ~1e-4 (ResNet32's bound in test_torch_port_slice.py)
    rel = np.linalg.norm(w_t - w_j) / np.linalg.norm(w_j)
    assert rel < 1e-3
    if (spec.out_rank, spec.in_rank) == (32, 16):  # full rank: W itself
        np.testing.assert_allclose(w_t, tm.state_dict()[name].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_compressed_logits_match_jax(dense, images):
    """The port's decompose of all 54 layers, moved into the JAX package's
    `tkc_resnet56`: both compressed forwards on the same factors."""
    tm, _ = dense
    tsd = decompose_params(tm.state_dict(), get_rank_plan("resnet56", "tk", "3"))
    tc = create_model("tkc_resnet56", ratio="3")
    tc.load_state_dict(tsd)
    assert round(compression_ratio(tm, tc), 2) == 3.10
    logits_t, logits_j = _logits(
        tc, jax_model("tkc_resnet56", num_classes=10, ratio="3"),
        state_dict_to_jax(tsd), images)
    assert np.isfinite(logits_t).all()
    # three convolutions a factorized layer, float32 in both frameworks
    np.testing.assert_allclose(logits_t, logits_j, **LOGIT_TOL)
