"""ResNet32 models of the PyTorch port against the JAX package's, on the
same weights (moved by the port's `utils/jax_weights.py`) and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.utils.torch_import import variables_to_torch
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# float32 convolutions through ~35 layers in two frameworks
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_variables(name, seed=0):
    m = jax_model(name, num_classes=10, **({"ratio": "3"} if "_" in name else {}))
    v = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    # non-trivial BN statistics, so eval mode reads them
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.asarray, v)
    for path, a in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        leaf = path[-1].key
        node = v["batch_stats"]
        for k in path[:-1]:
            node = node[k.key]
        node[leaf] = (rng.uniform(0.5, 1.5, a.shape) if leaf == "var"
                      else rng.normal(0, 0.1, a.shape)).astype(np.float32)
    return m, v


def _port(name, variables):
    m = create_model(name, **({"ratio": "3"} if "_" in name else {}))
    m.load_state_dict(jax_to_state_dict(variables))
    return m


def _batch(n=4, seed=1):
    return np.random.RandomState(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet32", "tkc_resnet32", "tkr_resnet32",
                                  "ttm_resnet32", "ttr_resnet32"])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_jax(name, train):
    jm, v = _jax_variables(name)
    x = _batch()
    out = jm.apply(v, jnp.asarray(x), train=train,
                   mutable=["batch_stats"] if train else False)
    logits_j = np.asarray(out[0] if train else out)
    tm = _port(name, v).train(train)
    with torch.no_grad():
        logits_t = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(logits_t, logits_j, **LOGIT_TOL)


def test_bn_running_stats_after_one_train_forward():
    jm, v = _jax_variables("resnet32")
    x = _batch(n=8)
    _, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = _port("resnet32", v).train()
    with torch.no_grad():
        tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    sd = tm.state_dict()
    bs = mut["batch_stats"]["layer3.4"]["bn2"]
    np.testing.assert_allclose(sd["layer3.4.bn2.running_mean"].numpy(),
                               np.asarray(bs["mean"]), rtol=1e-4, atol=1e-5)
    # flax folds the biased batch variance into its running variance,
    # torch the unbiased one: var_torch_batch = var_flax_batch * n/(n-1),
    # n = batch*H*W = 8*8*8 here. With momentum 0.1:
    # running_torch - running_flax = 0.1 * var_batch / (n - 1).
    n = 8 * 8 * 8
    var0 = v["batch_stats"]["layer3.4"]["bn2"]["var"]
    batch_var = (np.asarray(bs["var"]) - 0.9 * var0) / 0.1
    expected = 0.9 * var0 + 0.1 * batch_var * n / (n - 1)
    np.testing.assert_allclose(sd["layer3.4.bn2.running_var"].numpy(), expected,
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(sd["layer3.4.bn2.running_var"].numpy(),
                           np.asarray(bs["var"]), rtol=1e-7, atol=0)


@pytest.mark.parametrize("name", ["resnet32", "tkc_resnet32", "ttm_resnet32"])
def test_converter_matches_variables_to_torch_and_round_trips(name):
    _, v = _jax_variables(name)
    sd = jax_to_state_dict(v)
    ref = variables_to_torch(v)
    for k, a in ref.items():
        if k.endswith("core_kernel"):  # variables_to_torch keeps it HWIO
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    extra = set(sd) - set(ref)
    assert extra and all(k.endswith("num_batches_tracked") for k in extra)
    back = state_dict_to_jax(sd)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_v] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    # and every state-dict key of the port's own model is covered
    assert set(sd) == set(create_model(name, **({"ratio": "3"} if "_" in name
                                                 else {})).state_dict())
