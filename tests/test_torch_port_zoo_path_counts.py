"""The parameter counts and compression ratios that `chip_smoke.py` asserts
on its VGG16 TK@2x and DenseNet121 TK@2x main paths (`VGG16_PARAMS`,
`DENSENET121_PARAMS`, the paths' `ratio`): the JAX package's counts of
`vgg16`/`tkc_vgg16` and `densenet121`/`tkc_densenet121` at ratio "2", each
traced by `jax.eval_shape` alone, and the port's on the meta device."""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu_torch.models import (count_params,
                                                          create_model)


def _jax_count(name, **kw):
    m = jax_model(name, **kw)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 224, 224, 3)),
                                           train=False))
    return sum(math.prod(s.shape)
               for s in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("key,want", [
    ("vgg16_tk", chip_smoke.VGG16_PARAMS),
    ("densenet121_tk", chip_smoke.DENSENET121_PARAMS)])
def test_main_path_counts_and_ratio_match_jax(key, want):
    path = chip_smoke.PATHS[key]
    assert path["params"] == want
    ratio = path["ratio_arg"]
    jax_counts = (_jax_count(path["dense"]),
                  _jax_count(path["model"], ratio=ratio))
    with torch.device("meta"):
        port = (count_params(create_model(path["dense"])),
                count_params(create_model(path["model"], ratio=ratio)))
    assert port == jax_counts == want
    assert round(want[0] / want[1], 2) == path["ratio"]
