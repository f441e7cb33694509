"""The model zoo's names and plans in the PyTorch port against the JAX
package's: every reference model name builds in the port (on the meta
device: shapes without memory or compute), each compressed name's rank
plan equals the JAX package's (layer names, spec types, ranks, TT shapes;
a reference table or the automatic plan), every plan layer is a weight of
the dense model (so no remapped key is dropped), the parameter counts
equal the JAX package's (each traced here with `jax.eval_shape`), and the
port's JSON holds every table of the JAX package's, value for value.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.configs.auto_plan import (
    auto_rank_plan as jax_auto_plan, layer_inventory as jax_inventory)
from dnn_compression_tensor_admm_tpu.configs.plans import (
    reference_tables as jax_tables)
from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_plan)
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu_torch.admm import build_program
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.configs.auto_plan import (
    auto_rank_plan, layer_inventory, split_to_factors)
from dnn_compression_tensor_admm_tpu_torch.configs.plans import (
    reference_tables)
from dnn_compression_tensor_admm_tpu_torch.models import (
    count_params, create_model, parse_compressed_name)

# every @register_model name of the reference repo, as the JAX package's
# tests/test_auto_plan.py lists them
REFERENCE_MODEL_NAMES = [
    "densenet100", "densenet40", "mobilenetv2", "mobilenetv2_cifar",
    "resnet20", "resnet32", "resnet56", "stftkc_resnet32",
    "svdc_mobilenetv2", "svdc_mobilenetv2_cifar", "svdm_mobilenetv2",
    "svdm_mobilenetv2_cifar", "svdr_mobilenetv2_cifar",
    "tkc_densenet121", "tkc_densenet201", "tkc_densenet264",
    "tkc_mobilenetv2", "tkc_mobilenetv2_cifar", "tkc_resnet18",
    "tkc_resnet20", "tkc_resnet32", "tkc_resnet50", "tkc_vgg16",
    "tkc_vgg16_bn", "tkm_deit_small_patch16_224",
    "tkm_deit_tiny_patch16_224", "tkm_mobilenetv2_cifar", "tkm_resnet18",
    "tkm_resnet20", "tkm_resnet32", "tkm_resnet50",
    "tkr_deit_small_patch16_224", "tkr_deit_tiny_patch16_224",
    "tkr_densenet40", "tkr_mobilenetv2_cifar", "tkr_resnet18",
    "tkr_resnet20", "tkr_resnet32", "tkr_resnet34", "tkr_resnet50",
    "tkr_resnet56", "ttm_deit_small_patch16_224",
    "ttm_deit_tiny_patch16_224", "ttm_resnet18", "ttm_resnet20",
    "ttm_resnet32", "ttm_vit_small_patch16_224",
    "ttr_deit_small_patch16_224", "ttr_deit_tiny_patch16_224",
    "ttr_mobilenetv2", "ttr_resnet18", "ttr_resnet20", "ttr_resnet32",
    "ttr_resnet34", "ttr_resnet50", "ttr_resnet56",
    "ttr_vit_small_patch16_224",
]
_CIFAR = ("resnet20", "resnet32", "resnet56", "densenet40", "densenet100",
          "mobilenetv2_cifar")
# the layers each MobileNetV2 table covers in the JAX package: a key that
# a remapping dropped would leave its layer dense without an error
MBV2_LAYERS = {"svd": 29, "tk": 33, "tt": 33}


def _as_dict(plan):
    return {n: (type(s).__name__, vars(s)) for n, s in plan.layers.items()}


def _base_fmt(name):
    parsed = parse_compressed_name(name)
    return (name, None) if parsed is None else parsed[:2]


# (model, format) -> the JAX package's parameter count
_JAX_COUNTS = {}


def _jax_count(name):
    """The JAX package's parameter count, from `jax.eval_shape` alone,
    traced once for each (model, format): the mode of a format (m, r, c)
    moves no parameter."""
    key = _base_fmt(name)
    if key not in _JAX_COUNTS:
        sz = 32 if key[0] in _CIFAR else 224
        m = jax_model(name)
        shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, sz, sz, 3)),
                                               train=False))
        _JAX_COUNTS[key] = sum(math.prod(s.shape) for s in
                               jax.tree_util.tree_leaves(shapes["params"]))
    return _JAX_COUNTS[key]


def _port_model(name):
    with torch.device("meta"):
        return create_model(name)


@pytest.mark.parametrize("name", REFERENCE_MODEL_NAMES)
def test_name_builds_with_the_jax_plan_and_counts(name):
    model = _port_model(name)
    assert count_params(model) == _jax_count(name)
    base, fmt = _base_fmt(name)
    if fmt is None:
        return
    dense = _port_model(base)
    assert count_params(dense) == _jax_count(base)
    plan = get_rank_plan(name, fmt, "2")
    want = jax_plan(name, "tk" if fmt == "stftk" else fmt, "2")
    assert plan.fmt == want.fmt
    assert _as_dict(plan) == _as_dict(want)
    # every plan layer is a weight of the dense model
    program = build_program(dict(dense.named_parameters()), plan)
    assert len(program.names) == len(plan.layers)


@pytest.mark.parametrize("fmt", sorted(MBV2_LAYERS))
def test_mobilenetv2_plans_cover_every_table_key(fmt):
    plan = get_rank_plan("mobilenetv2", fmt, "2")
    assert len(plan.layers) == MBV2_LAYERS[fmt]
    dense = _port_model("mobilenetv2")
    assert len(build_program(dict(dense.named_parameters()),
                             plan).names) == MBV2_LAYERS[fmt]


def test_json_holds_every_jax_table():
    ours, theirs = reference_tables(), jax_tables()
    for fmt in theirs:
        if fmt.startswith("_"):
            continue
        for model in theirs[fmt]:
            for key, table in theirs[fmt][model].items():
                assert ours[fmt][model][key] == table, (fmt, model, key)


@pytest.mark.parametrize("model", ["resnet20", "mobilenetv2",
                                   "deit_tiny_patch16_224", "densenet40"])
def test_layer_inventory_equals_jax(model):
    """Depthwise convs read [C, 1, k, k] in torch, [k, k, 1, C] in JAX:
    both leave them out, as they do the stems and heads."""
    assert dict(layer_inventory(model)) == dict(jax_inventory(model))


@pytest.mark.parametrize("model,fmt,ratio,tt_type", [
    ("resnet20", "tk", 3.0, "general"), ("resnet20", "tt", 3.0, "special"),
    ("resnet56", "tt", 2.5, "general"), ("mobilenetv2", "svd", 4.0,
                                         "general"),
    ("deit_tiny_patch16_224", "svd", 2.0, "general"),
    ("deit_tiny_patch16_224", "tt", 3.0, "general"),
    ("vgg16", "tk", 7.0, "general")])
def test_auto_plan_equals_jax(model, fmt, ratio, tt_type):
    assert _as_dict(auto_rank_plan(model, fmt, ratio, tt_type=tt_type)) == \
        _as_dict(jax_auto_plan(model, fmt, ratio, tt_type=tt_type))


def test_numeric_ratio_falls_back_to_the_auto_plan():
    # ResNet32 registers ratios 1.5/2/3/5 only; 7 is planned automatically
    plan = get_rank_plan("tkc_resnet32", "tk", "7")
    assert _as_dict(plan) == _as_dict(jax_plan("resnet32", "tk", "7"))
    with pytest.raises(ValueError, match="ratio > 1"):
        auto_rank_plan("resnet20", "tk", 1.0)


def test_split_to_factors_equals_jax():
    from dnn_compression_tensor_admm_tpu.nlp.factorization import (
        split_to_factors as jax_split)
    for n in (1, 7, 12, 64, 96, 192, 320, 576, 768, 1000, 1280, 2304, 4096):
        for dim in (1, 2, 3):
            assert split_to_factors(n, dim) == jax_split(n, dim), (n, dim)
    assert np.prod(split_to_factors(960, 2)) == 960
