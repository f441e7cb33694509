"""Rank plans of the PyTorch port against the JAX package's resolver."""

import pytest

from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_plan)
from dnn_compression_tensor_admm_tpu_torch.configs import TKSpec, get_rank_plan


def _as_dict(plan):
    return {n: (type(s).__name__, vars(s)) for n, s in plan.layers.items()}


@pytest.mark.parametrize("ratio", ["1.5", "2", "3", "5"])
def test_resnet32_tk_plan_equals_jax(ratio):
    assert _as_dict(get_rank_plan("resnet32", "tk", ratio)) == \
        _as_dict(jax_plan("resnet32", "tk", ratio))


def test_resnet32_tk3_plan_shape():
    plan = get_rank_plan("tkc_resnet32", "tk", "3")
    assert plan.fmt == "tk" and len(plan.layers) == 30
    for b in range(5):
        for c in (1, 2):
            assert plan.spec(f"layer1.{b}.conv{c}.weight") == TKSpec(16, 16)
    # clamping to the layer's shape gives the five buckets of the Z-step
    assert plan.spec("layer2.0.conv1.weight").clamped((32, 16, 3, 3)) == TKSpec(24, 16)
    assert plan.spec("layer3.0.conv1.weight").clamped((64, 32, 3, 3)) == TKSpec(32, 25)
    assert plan.spec("layer3.4.conv2.weight").clamped((64, 64, 3, 3)) == TKSpec(25, 23)


def test_unknown_plan_raises():
    # a numeric ratio without a table takes the automatic plan (as in the
    # JAX package); a name that is no ratio, or an unknown model, raises
    with pytest.raises(KeyError):
        get_rank_plan("resnet32", "tk", "sc")
    with pytest.raises(KeyError):
        get_rank_plan("no_such_net", "tk", "7")
