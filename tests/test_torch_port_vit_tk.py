"""The PyTorch port's DeiT-tiny TK@2x modules against the JAX package's:
the rank plan, the Tucker-2 linear layer (both modes, `factorize_dense`),
its weights moved across packages, and the compression ratio of the
full-size `tkc_deit_tiny_patch16_224`.

Inputs are numpy arrays made from a seed, in float32; both packages take
the same weights (the port's, moved by its `utils/jax_weights.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.hp import TKSpec as JaxTKSpec
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.layers.tk_linear import TKLinear as JaxTKLinear
from dnn_compression_tensor_admm_tpu.models import (
    compression_ratio as jax_ratio, create_model as jax_model)
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.utils.torch_import import variables_to_torch
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, TKSpec, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.layers import TKLinear
from dnn_compression_tensor_admm_tpu_torch.models import compression_ratio, create_model
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)

NAME = "deit_tiny_patch16_224"


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


def test_plan_equals_the_jax_table():
    tp, jp = get_rank_plan(NAME, "tk", "2"), jax_plan(NAME, "tk", "2")
    assert set(tp.names()) == set(jp.names()) and len(tp.layers) == 48
    for n in tp.names():
        t, j = tp.spec(n), jp.spec(n)
        assert isinstance(t, TKSpec) and (t.out_rank, t.in_rank) == (
            j.out_rank, j.in_rank), n
    ranks = {n.split(".")[-2]: (tp.spec(n).out_rank, tp.spec(n).in_rank)
             for n in tp.names()}
    assert ranks == {"qkv": (128, 72), "proj": (72, 72), "fc1": (128, 72),
                     "fc2": (72, 128)}


@pytest.mark.parametrize("mode", ["chain", "reconstruct"])
@pytest.mark.parametrize("in_f,out_f,ranks,bias", [
    (48, 144, (24, 16), True),    # qkv-like, both ranks cut
    (192, 48, (16, 32), True),    # fc2-like
    (20, 30, (40, 8), False),     # out rank clamped to 30, no bias
])
def test_tk_linear_matches_jax(in_f, out_f, ranks, bias, mode):
    layer = TKLinear(in_f, out_f, TKSpec(*ranks), bias=bias, mode=mode,
                     generator=torch.Generator().manual_seed(in_f))
    if bias:
        with torch.no_grad():
            layer.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = np.random.RandomState(out_f).standard_normal((3, 5, in_f)).astype(
        np.float32)
    v = state_dict_to_jax(layer.state_dict())
    assert set(v["params"]) == ({"first_factor", "core", "last_factor"}
                                | ({"bias"} if bias else set()))
    jl = JaxTKLinear(in_f, out_f, JaxTKSpec(*ranks), use_bias=bias,
                     mode=mode)
    want = jl.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,ranks", [
    ((144, 48), (24, 16)),
    ((48, 192), (16, 32)),
    ((30, 20), (12, 12)),
])
def test_factorize_dense_matches_jax(shape, ranks):
    w = np.random.RandomState(shape[0]).standard_normal(shape).astype(
        np.float32)
    b = np.arange(shape[0], dtype=np.float32)
    t = TKLinear.factorize_dense(torch.from_numpy(w), TKSpec(*ranks),
                                 torch.from_numpy(b))
    j = JaxTKLinear.factorize_dense(jnp.asarray(w), JaxTKSpec(*ranks),
                                    jnp.asarray(b))
    assert set(t) == set(j) == {"first_factor", "core", "last_factor", "bias"}
    for k in t:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
    np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))

    def weight(p):
        return (np.asarray(p["last_factor"]) @ np.asarray(p["core"])
                @ np.asarray(p["first_factor"]))
    # exact SVDs in two LAPACKs and 10 HOOI sweeps: the factors may differ
    # in sign, the weight they stand for by float32 rounding
    assert _rel(weight(t), weight(j)) < 1e-4


def test_tk_vit_weights_move_as_the_jax_package_names_them():
    names = ["blocks.0.attn.qkv.weight", "blocks.1.mlp.fc1.weight"]
    jm = JaxViT(img_size=32, embed_dim=48, depth=2, num_heads=3,
                num_classes=10,
                plan=JaxRankPlan("tk", {n: JaxTKSpec(8, 6) for n in names}))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 32, 32, 3))))
    sd = jax_to_state_dict(v)
    ref = variables_to_torch(v)
    assert set(sd) == set(ref)
    assert {k for k in sd if k.startswith("blocks.0.attn.qkv.")} == {
        f"blocks.0.attn.qkv.{p}"
        for p in ("first_factor", "core", "last_factor", "bias")}
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm = VisionTransformer(img_size=32, embed_dim=48, depth=2, num_heads=3,
                           num_classes=10, mode="chain",
                           plan=RankPlan("tk", {n: TKSpec(8, 6)
                                                for n in names}))
    tm.load_state_dict(sd)  # the port's names and shapes, strictly
    back = state_dict_to_jax(tm.state_dict())["params"]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_v = dict(jax.tree_util.tree_flatten_with_path(v["params"])[0])
    assert flat_b.keys() == flat_v.keys()
    for k in flat_v:
        np.testing.assert_array_equal(flat_b[k], flat_v[k], err_msg=str(k))


def test_compression_ratio_equals_jax():
    """At 224 x 224, the configuration's own input: 5,717,416 parameters
    dense, 4,876,456 compressed."""
    dense = create_model(NAME)
    compressed = create_model(f"tkc_{NAME}", ratio="2")
    assert all(isinstance(compressed.blocks[b].mlp.fc1, TKLinear)
               for b in range(12))
    ratio = compression_ratio(dense, compressed)
    x = jnp.zeros((1, 224, 224, 3))
    vd = jax.eval_shape(jax_model(NAME).init, jax.random.PRNGKey(0), x)
    vc = jax.eval_shape(jax_model(f"tkc_{NAME}", ratio="2").init,
                        jax.random.PRNGKey(0), x)
    assert ratio == jax_ratio(vd, vc) == 5_717_416 / 4_876_456
    assert round(ratio, 2) == 1.17
    assert create_model(f"tkr_{NAME}", ratio="2").blocks[0].attn.qkv.mode \
        == "reconstruct"
