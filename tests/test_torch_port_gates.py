"""The port's kernel gates over the JAX package's rank plans: for each
plan, the layers whose Z-step bucket each gate takes, the Pallas
kernel's (its VMEM plan) and the port's CUDA kernel's (its shared-memory
plans). The models' parameter shapes come from `jax.eval_shape`; the
buckets are the JAX package's `build_program`, viewed as the port's
kernel routes view them. ROADMAP.md's gate table quotes these counts."""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.ops.pallas.subspace_kernel import tt_supported_pallas
from dnn_compression_tensor_admm_tpu.ops.pallas.tucker_kernel import pallas_tk_supported
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs.hp import RankPlan, TKSpec
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk


def _groups(name, fmt, ratio, tt_type, size):
    shapes = jax.eval_shape(jax_model(name).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    plan = jax_plan(name, fmt, ratio, tt_type)
    return jeng.build_program(shapes["params"], plan).groups


@pytest.mark.parametrize("name,ratio,tt_type,size,pallas,layers", [
    ("deit_tiny_patch16_224", "2", "general", 224, 48, 48),
    ("deit_small_patch16_224", "2", "general", 224, 12, 48),
    ("resnet50", "3", "general", 224, 19, 34),
    ("resnet50", "3", "special", 224, 19, 34),
    ("resnet18", "2", "general", 224, 9, 16),
    ("resnet18", "2", "special", 224, 8, 16),
    ("mobilenetv2", "2", "general", 224, 31, 33),
    ("resnet56", "3", "general", 32, 54, 54),
])
def test_subspace_gate_takes_every_layer_of_the_tt_plans(name, ratio, tt_type,
                                                         size, pallas, layers):
    # the workspace plan takes every bucket; the port's gate takes at
    # least what the Pallas gate takes
    counts = {"pallas": 0, "port": 0, "layers": 0}
    for g in _groups(name, "tt", ratio, tt_type, size):
        assert g.kind in ("tt_conv", "tt_linear")
        l, numel = len(g.names), math.prod(g.param_shape)
        ok_pallas = tt_supported_pallas(l, numel, g.spec.tt_shapes,
                                        g.spec.tt_ranks)
        ok_port = sk.tt_supported(l, numel, g.spec.tt_shapes,
                                  g.spec.tt_ranks)
        assert ok_port or not ok_pallas, g.names
        counts["pallas"] += l * ok_pallas
        counts["port"] += l * ok_port
        counts["layers"] += l
    assert counts == {"pallas": pallas, "port": layers, "layers": layers}


def _tucker2_bucket(g):
    """[L, K, O, I] and ranks of a bucket as the Tucker-2 kernel takes it
    (linears and SVD layers as K = 1), or None for an SVD conv past 1x1."""
    l = len(g.names)
    if g.kind in ("tk_conv", "svd_conv"):
        kh, kw, i, o = g.param_shape  # HWIO
        if g.kind == "svd_conv" and (kh, kw) != (1, 1):
            return None
    else:
        (i, o), kh, kw = g.param_shape, 1, 1  # Dense [in, out]
    if g.kind.startswith("svd"):
        r0 = r1 = min(g.spec.rank, o, i)
    else:
        sp = g.spec.clamped((o, i, kh, kw))
        r0, r1 = sp.out_rank, sp.in_rank
    return (l, kh * kw, o, i), r0, r1


@pytest.mark.parametrize("name,fmt,ratio,size,pallas,port,layers", [
    ("deit_tiny_patch16_224", "tk", "2", 224, 48, 0, 48),
    ("resnet50", "tk", "3", 224, 24, 3, 44),
    ("resnet18", "tk", "2", 224, 12, 4, 16),
    ("vgg16", "tk", "2", 224, 6, 1, 13),
    ("mobilenetv2", "svd", "2", 224, 22, 7, 29),
    ("densenet40", "tk", "2", 32, 38, 16, 38),
    ("resnet56", "tk", "3", 32, 54, 54, 54),
])
def test_tucker2_gate_on_the_tk_and_svd_plans(name, fmt, ratio, size, pallas,
                                              port, layers):
    # the Tucker-2 kernel has no plan past a block yet (ROADMAP Queue 2)
    counts = {"pallas": 0, "port": 0, "layers": 0}
    for g in _groups(name, fmt, ratio, "general", size):
        counts["layers"] += len(g.names)
        bucket = _tucker2_bucket(g)
        if bucket is None:
            continue
        shape, r0, r1 = bucket
        counts["pallas"] += len(g.names) * pallas_tk_supported(shape)
        counts["port"] += len(g.names) * tk.kernel_supported(shape, r0, r1)
    assert counts == {"pallas": pallas, "port": port, "layers": layers}


@pytest.mark.parametrize("shape,r", [
    ((1, 25000, 25000), 24000),  # five r x r Newton-Schulz matrices > 2**31
    ((1, 70000000, 32), 30),     # one layer > 2**31 floats
])
def test_subspace_gate_refuses_shapes_past_int32(shape, r):
    # the CUDA source sizes its regions and indexes a layer in int
    assert not sk.subspace_supported(shape, r)


def _refused_tk_bucket(device):
    # 3x3 convs 128 -> 128 at Tucker-2 ranks 64: past a block's shared memory
    plan = RankPlan("tk", {f"c{j}": TKSpec(64, 64) for j in range(2)})
    g = torch.Generator().manual_seed(0)
    params = {n: torch.randn(128, 128, 3, 3, generator=g).to(device)
              for n in plan.layers}
    program = teng.build_program(params, plan)
    assert not tk.kernel_supported((2, 9, 128, 128), 64, 64)
    return params, program


def test_refused_bucket_goes_layer_by_layer_on_the_cpu():
    params, program = _refused_tk_bucket("cpu")
    state = teng.admm_init(params, program)
    kern, res_k = teng.admm_update(params, state, program, method="kernel",
                                   n_iter=3)
    sub, res_s = teng.admm_update(params, state, program, method="subspace",
                                  n_iter=3)
    for n in params:
        assert torch.equal(kern.z[n], sub.z[n]) and torch.equal(res_k[n],
                                                                res_s[n])


def test_refused_bucket_raises_off_the_cpu():
    # no card here: a meta tensor stands in for one, the gate decides first
    params, program = _refused_tk_bucket("meta")
    state = teng.admm_init(params, program)
    with pytest.raises(ValueError, match="gate refuses"):
        teng.admm_update(params, state, program, method="kernel", n_iter=3)
