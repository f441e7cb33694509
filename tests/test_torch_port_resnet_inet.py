"""ImageNet ResNet models of the PyTorch port against the JAX package's:
the rank tables the port copies, dense ResNet-18 and ResNet-50 logits on
the same weights (moved by the port's `utils/jax_weights.py`) in eval and
in train mode, the converter against the JAX package's
`variables_to_torch` and back, parameter counts and ratios of the
compressed models, and the Z-step's bucketing of ResNet-50 TT@3x and
TK@3x with the subspace launches and Tucker-2 plans it gives.

Global pooling takes any input size, so the inputs stay small: a batch
of 2 at 32 x 32 in eval mode (the stem, the max pool and three strided
stages take it to 1 x 1), at 64 x 64 in train mode (2 x 2 at the last
stage: batch statistics of 8 values a channel, not 2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.plans import reference_tables as jax_tables
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.utils.torch_import import variables_to_torch
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.configs.plans import reference_tables
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, count_params, create_model)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
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


# Largest difference over the largest magnitude. Eval mode: float32
# convolutions through ~50 layers in two frameworks, on random weights
# whose logits reach ~900 (ResNet-50) with these BN statistics; 2.5e-6
# seen. Train mode: flax's BatchNorm takes the batch variance in one
# pass, E[x^2] - E[x]^2, torch in two; through 53 batch-normalised layers
# of ResNet-50 the logits (up to ~6) agree within ~2.6e-4 of their scale
# (ResNet-18 6e-6), the running means within 1e-4 absolute.
EVAL_TOL, TRAIN_TOL = 2e-5, 1e-3


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
# the JAX package's counts (`count_params` of `init`; RESULTS.md: ResNet-50
# 25.56 M dense, TT@3x general 10.19 M, 2.509x)
DENSE_PARAMS = {"resnet18": 11_689_512, "resnet50": 25_557_032}
COMPRESSED = {  # name, ratio, tt_type -> (count, ratio to 2 decimals)
    ("ttm_resnet50", "3", "general"): (10_187_501, 2.51),
    ("ttm_resnet50", "3", "special"): (9_517_360, 2.69),
    ("tkc_resnet50", "3", "general"): (8_685_608, 2.94),
    ("ttm_resnet18", "2", "special"): (4_230_481, 2.76),
}


def _with_bn_stats(v, rng):
    """Non-trivial BN statistics, so eval-mode logits read them."""
    v = jax.tree.map(np.asarray, v)
    for path, a in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        node = v["batch_stats"]
        for k in path[:-1]:
            node = node[k.key]
        node[path[-1].key] = (rng.uniform(0.5, 1.5, a.shape)
                              if path[-1].key == "var"
                              else rng.normal(0, 0.1, a.shape)
                              ).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def jax_dense():
    """name -> (JAX model, its variables with non-trivial BN statistics)."""
    rng = np.random.RandomState(0)
    out = {}
    for name in DENSE_PARAMS:
        m = jax_model(name, num_classes=1000)
        v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        out[name] = (m, _with_bn_stats(v, rng))
    return out


def _shapes(name, **kw):
    """The JAX model's parameters as zeros (shapes alone, no compile)."""
    m = jax_model(name, num_classes=1000, **kw)
    v = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 3))))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), v["params"])


@pytest.mark.parametrize("fmt,model,key", [
    ("tt", "resnet50", "3|general"), ("tt", "resnet50", "3|special"),
    ("tk", "resnet50", "3|general"), ("tt", "resnet18", "2|general"),
    ("tt", "resnet18", "2|special"), ("tk", "resnet18", "2|general")])
def test_rank_tables_are_the_jax_packages(fmt, model, key):
    assert (json.dumps(reference_tables()[fmt][model][key])
            == json.dumps(jax_tables()[fmt][model][key]))


# a BN of the last stage (2 x 2 at 64 x 64: n = 8 values a channel) and
# one of a downsample branch (16 x 16 or 8 x 8)
BN_CHECKS = {"resnet50": [("layer4.1.bn2", 8), ("layer1.0.downsample.1", 512)],
             "resnet18": [("layer4.1.bn2", 8), ("layer2.0.downsample.1", 128)]}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(DENSE_PARAMS))
def test_dense_logits_match_jax(jax_dense, name, train):
    jm, v = jax_dense[name]
    size = 64 if train else 32
    x = np.random.RandomState(1).standard_normal((2, size, size, 3)).astype(
        np.float32)
    tm = create_model(name)
    tm.load_state_dict(jax_to_state_dict(v))
    tm.train(train)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if train:
        # batch statistics: the logits agree; the running means too, and
        # the running variances by torch's n/(n-1) (unbiased) against
        # flax's biased batch variance
        logits_j, upd = jm.apply(v, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        with torch.no_grad():
            logits_t = tm(xt)
        stats = jax_to_state_dict({"batch_stats": jax.tree.map(
            np.asarray, upd["batch_stats"])})
        sd = tm.state_dict()
        for k, n in BN_CHECKS[name]:
            np.testing.assert_allclose(sd[f"{k}.running_mean"].numpy(),
                                       stats[f"{k}.running_mean"].numpy(),
                                       rtol=1e-4, atol=1e-4)
            block, module = k.rsplit(".", 1) if "bn" in k else (
                k[:len("layer1.0")], k[len("layer1.0."):])
            prior = v["batch_stats"][block][module]["var"]
            # 0.9 prior + 0.1 batch variance on each side
            var_t = (sd[f"{k}.running_var"].numpy() - 0.9 * prior) / 0.1
            var_j = (stats[f"{k}.running_var"].numpy() - 0.9 * prior) / 0.1
            # flax's one-pass variance: 1.1e-3 apart seen; the factor
            # itself is 14% at n = 8
            np.testing.assert_allclose(var_t * (n - 1) / n, var_j,
                                       rtol=5e-3, atol=1e-5)
    else:
        logits_j = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
            logits_t = tm(xt)
    assert logits_t.dtype == torch.float32 and logits_t.shape == (2, 1000)
    _close(logits_t.numpy(), logits_j, TRAIN_TOL if train else EVAL_TOL)


@pytest.mark.parametrize("name", list(DENSE_PARAMS))
def test_converter_matches_variables_to_torch_and_round_trips(jax_dense,
                                                              name):
    _, v = jax_dense[name]
    sd = jax_to_state_dict(v)
    ref = variables_to_torch(v)
    for k, a in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    # the downsample branch's conv and BN inside a dotted block name
    assert tuple(sd["layer3.0.downsample.0.weight"].shape) == (
        (1024, 512, 1, 1) if name == "resnet50" else (256, 128, 1, 1))
    assert "layer3.0.downsample.1.running_var" in sd
    extra = set(sd) - set(ref)
    assert extra and all(k.endswith("num_batches_tracked") for k in extra)
    back = state_dict_to_jax(sd)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_v] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    assert set(sd) == set(create_model(name).state_dict())


@pytest.mark.parametrize("name,ratio,tt_type", list(COMPRESSED))
def test_parameter_counts_and_ratios(name, ratio, tt_type):
    base = name.split("_", 1)[1]
    dense = create_model(base)
    compressed = create_model(name, ratio=ratio, tt_type=tt_type)
    count, rounded = COMPRESSED[(name, ratio, tt_type)]
    assert count_params(dense) == DENSE_PARAMS[base]
    assert count_params(compressed) == count
    # the JAX package's own counts of the same models
    for jname, kw, want in ((base, {}, DENSE_PARAMS[base]),
                            (name, dict(ratio=ratio, tt_type=tt_type), count)):
        params = _shapes(jname, **kw)
        assert sum(a.size for a in jax.tree.leaves(params)) == want
    assert round(compression_ratio(dense, compressed), 2) == rounded


def test_resnet34_parameter_count_matches_jax():
    params = _shapes("resnet34")
    assert (count_params(create_model("resnet34"))
            == sum(a.size for a in jax.tree.leaves(params)) == 21_797_672)


# the ResNet-50 TT@3x Z-step: 36 sweep steps, of which the 9 full-rank
# ones launch nothing, and Tucker-2 TK@3x's 15 buckets
TT_LAUNCH_PLANS = {"padded": 12, "unpadded": 1, "workspace": 14}
TK_PLANS = {"resident": 1, "streamed": 1, "workspace": 13}


@pytest.mark.parametrize("fmt", ["tt", "tk"])
def test_bucketing_matches_jax(fmt):
    dense = create_model("resnet50")
    tprog = teng.build_program(dict(dense.named_parameters()),
                               get_rank_plan("resnet50", fmt, "3"))
    jprog = jeng.build_program(_shapes("resnet50"),
                               jax_plan("resnet50", fmt, "3"))
    n_groups, n_layers = (12, 34) if fmt == "tt" else (15, 44)
    assert len(tprog.groups) == len(jprog.groups) == n_groups
    assert sum(len(g.names) for g in tprog.groups) == n_layers
    # the same buckets; names within one follow each package's parameter
    # order (the port's by module, flax's sorted as strings)
    jgroups = {frozenset(g.names): g for g in jprog.groups}
    for tg in tprog.groups:
        jg = jgroups[frozenset(tg.names)]
        assert tg.kind == jg.kind
        kh, kw, i, o = jg.param_shape  # HWIO on the JAX side
        assert tg.param_shape == (o, i, kh, kw)
        assert type(tg.spec).__name__ == type(jg.spec).__name__
        assert vars(tg.spec) == vars(jg.spec)
    if fmt == "tt":
        assert {g.kind for g in tprog.groups} == {"tt_conv"}
        steps = [(len(g.names), rows, cols, r) for g in tprog.groups
                 for rows, cols, r in sk.sweep_steps(g.spec.tt_shapes,
                                                     g.spec.tt_ranks)]
        launches = [s for s in steps if s[3] != s[1]]
        assert (len(steps), len(launches)) == (36, 27)
        plans = [sk.plan_name(*s[1:]) for s in launches]
        assert {p: plans.count(p) for p in set(plans)} == TT_LAUNCH_PLANS
        assert all(sk.subspace_supported(s[:3], s[3]) for s in launches)
        # the widest rows and the largest ranks the card runs
        assert (3, 32, 73728, 30) in launches
        assert {s[3] for s in launches} >= {105, 130}
    else:
        kinds = [g.kind for g in tprog.groups]
        assert (kinds.count("tk_conv"), kinds.count("svd_conv")) == (5, 10)
        plans = []
        for g in tprog.groups:
            o, i, kh, kw = g.param_shape
            sp = teng.tk_ranks(g.spec, g.param_shape)
            shape = (len(g.names), kh * kw, o, i)
            assert tk.kernel_supported(shape, sp.out_rank, sp.in_rank)
            plans.append(tk.plan_name(*shape[1:], sp.out_rank, sp.in_rank))
        assert {p: plans.count(p) for p in set(plans)} == TK_PLANS
