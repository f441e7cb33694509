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


@pytest.mark.parametrize("name,fmt,ratio,size,pallas,port,workspace,layers", [
    ("deit_tiny_patch16_224", "tk", "2", 224, 48, 48, 48, 48),
    ("resnet50", "tk", "3", 224, 24, 44, 41, 44),
    ("resnet18", "tk", "2", 224, 12, 16, 12, 16),
    ("vgg16", "tk", "2", 224, 6, 13, 12, 13),
    ("mobilenetv2", "svd", "2", 224, 22, 29, 22, 29),
    ("densenet40", "tk", "2", 32, 38, 38, 22, 38),
    ("resnet56", "tk", "3", 32, 54, 54, 0, 54),
    ("mobilenetv2_cifar", "svd", "2", 32, 21, 28, 21, 28),
    ("mobilenetv2_cifar", "tk", "2", 32, 21, 28, 21, 28),
])
def test_tucker2_gate_on_the_tk_and_svd_plans(name, fmt, ratio, size, pallas,
                                              port, workspace, layers):
    # the workspace plan takes every bucket past a block; the port's gate
    # takes at least what the Pallas gate takes, bucket by bucket
    counts = {"pallas": 0, "port": 0, "workspace": 0, "layers": 0}
    for g in _groups(name, fmt, ratio, "general", size):
        counts["layers"] += len(g.names)
        bucket = _tucker2_bucket(g)
        if bucket is None:
            continue
        shape, r0, r1 = bucket
        ok_pallas = pallas_tk_supported(shape)
        ok_port = tk.kernel_supported(shape, r0, r1)
        assert ok_port or not ok_pallas, g.names
        counts["pallas"] += len(g.names) * ok_pallas
        counts["port"] += len(g.names) * ok_port
        counts["workspace"] += len(g.names) * (
            tk.plan_name(*shape[1:], r0, r1) == "workspace")
    assert counts == {"pallas": pallas, "port": port, "workspace": workspace,
                      "layers": layers}


@pytest.mark.parametrize("shape,r", [
    ((1, 25000, 25000), 24000),  # five r x r Newton-Schulz matrices > 2**31
    ((1, 70000000, 32), 30),     # one layer > 2**31 floats
])
def test_subspace_gate_refuses_shapes_past_int32(shape, r):
    # the CUDA source sizes its regions and indexes a layer in int
    assert not sk.subspace_supported(shape, r)


@pytest.mark.parametrize("shape,r0,r1", [
    ((1, 1, 4, 30000), 2, 2),        # a chunk row of X_k past half a block
    ((1, 1, 29100, 4), 2, 2),        # the same along O (a transposed chunk)
    ((1, 1, 50000, 64), 32, 32),     # both: the Gram (50,000^2) past 2**31
    ((1, 40000, 256, 256), 8, 8),    # one layer past 2**31 floats
])
def test_tucker2_gate_refuses_shapes_past_a_chunk_row_or_int32(shape, r0, r1):
    # the workspace plan streams at least one row of X_k per chunk buffer,
    # and the CUDA source sizes its regions and indexes a layer in int
    assert not tk.kernel_supported(shape, r0, r1)


def test_tucker2_gate_takes_shapes_just_inside_those_limits():
    for shape in ((1, 1, 4, 29000), (1, 1, 29000, 4)):
        assert tk.plan_name(*shape[1:], 2, 2) == "workspace"
        assert tk.kernel_supported(shape, 2, 2)
        p = tk.ws_plan(*shape[1:], 2, 2)
        assert p.stage >= p.ldc and p.smem_floats <= tk.MAX_SMEM_BYTES // 4


def _refused_tk_bucket(device, monkeypatch):
    """3x3 convs 128 -> 128 at Tucker-2 ranks 64 (the workspace plan) on
    the CPU, with the gate made to refuse them: a bucket the gate really
    refuses has a side past ~29,000, too large for the layer-by-layer
    route on the CPU. Off the CPU (meta tensors), such a bucket: 1 x 1
    convs 4 -> 30,000 at ranks 2."""
    if device == "cpu":
        monkeypatch.setattr(teng, "kernel_supported", lambda *a: False)
        shape = (128, 128, 3, 3)
        plan = RankPlan("tk", {f"c{j}": TKSpec(64, 64) for j in range(2)})
    else:
        shape = (30000, 4, 1, 1)
        plan = RankPlan("tk", {f"c{j}": TKSpec(2, 2) for j in range(2)})
        assert not tk.kernel_supported((2, 1, 30000, 4), 2, 2)
    g = torch.Generator().manual_seed(0)
    params = {n: torch.randn(*shape, generator=g).to(device)
              for n in plan.layers}
    program = teng.build_program(params, plan)
    return params, program


def test_refused_bucket_goes_layer_by_layer_on_the_cpu(monkeypatch):
    params, program = _refused_tk_bucket("cpu", monkeypatch)
    state = teng.admm_init(params, program)
    kern, res_k = teng.admm_update(params, state, program, method="kernel",
                                   n_iter=3)
    sub, res_s = teng.admm_update(params, state, program, method="subspace",
                                  n_iter=3)
    for n in params:
        assert torch.equal(kern.z[n], sub.z[n]) and torch.equal(res_k[n],
                                                                res_s[n])


def test_refused_bucket_raises_off_the_cpu(monkeypatch):
    # no card here: a meta tensor stands in for one, the gate decides first
    params, program = _refused_tk_bucket("meta", monkeypatch)
    state = teng.admm_init(params, program)
    with pytest.raises(ValueError, match="gate refuses"):
        teng.admm_update(params, state, program, method="kernel", n_iter=3)
