"""MobileNetV2-CIFAR models of the PyTorch port against the JAX package's,
dense, plain-SVD and Tucker-2 at ratio 2: logits on the same weights
(moved by the port's `utils/jax_weights.py`), parameter counts and ratios,
the Z-step's bucketing of both rank tables, a full-rank `SVDConv2d`, and
the command line end to end on the CPU at a tiny size.

The JAX model's widths are fixed, so the inputs stay small: a batch of 2
at 16 x 16 (two stride-2 blocks take it to 4 x 4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import count_params as jax_count
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.utils.torch_import import variables_to_torch
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.configs import SVDSpec, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.layers import SVDConv2d
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, count_params, create_model)
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32
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


# float32 convolutions through ~54 layers in two frameworks
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX package's counts (`count_params` of `init` at 32 x 32)
DENSE_PARAMS = 2_237_770
COMPRESSED_PARAMS = {"svdc_mobilenetv2_cifar": 1_289_754,
                     "tkc_mobilenetv2_cifar": 1_383_294}
RATIOS = {"svdc_mobilenetv2_cifar": 1.74, "tkc_mobilenetv2_cifar": 1.62}


def _kw(name):
    return {"ratio": "2"} if "_" in name else {}


@pytest.fixture(scope="module")
def jax_variables():
    """name -> (JAX model, its variables with non-trivial BN statistics)."""
    out = {}
    rng = np.random.RandomState(0)
    for name in ("mobilenetv2_cifar", *COMPRESSED_PARAMS):
        m = jax_model(name, num_classes=10, **_kw(name))
        v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 16, 16, 3))))
        for path, a in jax.tree_util.tree_flatten_with_path(
                v["batch_stats"])[0]:
            node = v["batch_stats"]
            for k in path[:-1]:
                node = node[k.key]
            node[path[-1].key] = (rng.uniform(0.5, 1.5, a.shape)
                                  if path[-1].key == "var"
                                  else rng.normal(0, 0.1, a.shape)
                                  ).astype(np.float32)
        out[name] = (m, v)
    return out


def _port(name, variables):
    m = create_model(name, **_kw(name))
    m.load_state_dict(jax_to_state_dict(variables))
    return m.eval()


@pytest.mark.parametrize("name", ["mobilenetv2_cifar", "svdc_mobilenetv2_cifar",
                                  "svdr_mobilenetv2_cifar",
                                  "tkc_mobilenetv2_cifar"])
def test_logits_match_jax(jax_variables, name):
    # eval mode on the same BN statistics (flax's running variance is
    # biased, torch's unbiased, so training-mode updates differ)
    jm, v = jax_variables[name.replace("svdr_", "svdc_")]
    x = np.random.RandomState(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    logits_j = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        logits_t = _port(name, v)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), logits_j, **LOGIT_TOL)


@pytest.mark.parametrize("name", ["mobilenetv2_cifar", *COMPRESSED_PARAMS])
def test_converter_matches_variables_to_torch_and_round_trips(jax_variables,
                                                              name):
    _, v = jax_variables[name]
    sd = jax_to_state_dict(v)
    ref = variables_to_torch(v)
    for k, a in ref.items():
        if k.endswith("core_kernel"):  # variables_to_torch keeps it HWIO
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    # a depthwise HWIO [3, 3, 1, C] kernel is OIHW [C, 1, 3, 3]
    assert tuple(sd["bottlenecks.16.conv2.weight"].shape) == (960, 1, 3, 3)
    extra = set(sd) - set(ref)
    assert extra and all(k.endswith("num_batches_tracked") for k in extra)
    back = state_dict_to_jax(sd)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_v] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    assert set(sd) == set(create_model(name, **_kw(name)).state_dict())


@pytest.mark.parametrize("name", list(COMPRESSED_PARAMS))
def test_parameter_counts_and_ratios(jax_variables, name):
    dense = create_model("mobilenetv2_cifar")
    compressed = create_model(name, ratio="2")
    assert count_params(dense) == DENSE_PARAMS
    assert count_params(compressed) == COMPRESSED_PARAMS[name]
    # the JAX package's own counts of the same models
    assert jax_count(jax_variables["mobilenetv2_cifar"][1]["params"]) == (
        DENSE_PARAMS)
    assert jax_count(jax_variables[name][1]["params"]) == (
        COMPRESSED_PARAMS[name])
    assert round(compression_ratio(dense, compressed), 2) == RATIOS[name]


@pytest.mark.parametrize("fmt,kind", [("svd", "svd_conv"), ("tk", "tk_conv")])
def test_bucketing_matches_jax(jax_variables, fmt, kind):
    dense = create_model("mobilenetv2_cifar")
    tprog = teng.build_program(dict(dense.named_parameters()),
                               get_rank_plan("mobilenetv2_cifar", fmt, "2"))
    params_j = jax_variables["mobilenetv2_cifar"][1]["params"]
    jprog = jeng.build_program(params_j, jax_plan("mobilenetv2_cifar", fmt,
                                                  "2"))
    assert len(tprog.groups) == len(jprog.groups) == 16
    assert sum(len(g.names) for g in tprog.groups) == 28
    # the same buckets; names within one follow each package's parameter
    # order (the port's by module, flax's sorted as strings)
    jgroups = {frozenset(g.names): g for g in jprog.groups}
    for tg in tprog.groups:
        jg = jgroups[frozenset(tg.names)]
        assert tg.kind == jg.kind == kind
        kh, kw, i, o = jg.param_shape  # HWIO on the JAX side
        assert tg.param_shape == (o, i, kh, kw) == (o, i, 1, 1)
        assert type(tg.spec).__name__ == type(jg.spec).__name__
        assert vars(tg.spec) == vars(jg.spec)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["chain", "reconstruct"])
def test_full_rank_svd_conv_reproduces_the_dense_conv(stride, mode):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(24, 16, 1, 1, generator=g)
    b = torch.randn(24, generator=g)
    x = torch.randn(2, 16, 9, 9, generator=g)
    layer = SVDConv2d(16, 24, 1, SVDSpec(16), stride=stride, mode=mode)
    layer.load_state_dict(SVDConv2d.factorize_dense(w, SVDSpec(16), b))
    with torch.no_grad(), full_f32():
        out, ref = layer(x), F.conv2d(x, w, b, stride)
    assert out.shape == ref.shape == (2, 24, 5 if stride == 2 else 9,
                                      5 if stride == 2 else 9)
    # a rank-16 SVD of a 24 x 16 matrix is exact up to float32 rounding
    assert (torch.linalg.vector_norm(out - ref)
            / torch.linalg.vector_norm(ref)).item() < 1e-5


def test_svd_conv_refuses_kernels_past_1x1():
    with pytest.raises(ValueError, match="1x1"):
        SVDConv2d(8, 8, 3, SVDSpec(4), padding=1)


@pytest.mark.parametrize("fmt,model,ratio", [
    ("svd", "svdc_mobilenetv2_cifar", "1.74"),
    ("tk", "tkc_mobilenetv2_cifar", "1.62")])
def test_cli_admm_decompose_eval_on_cpu(tmp_path, capsys, fmt, model, ratio):
    common = ["--device", "cpu", "--dataset", "synthetic-cifar10",
              "--synthetic-size", "8", "--batch-size", "4", "--ratio", "2",
              "--lr", "0.05", "--fp32"]
    cli_main(["--model", "mobilenetv2_cifar", "--admm", "--format", fmt,
              "--epochs", "1", "--steps-per-epoch", "1", "--smoothing", "0.1",
              "--save-model", "--save-log", "--output-dir",
              str(tmp_path / "admm"), *common])
    (dense,) = (tmp_path / "admm").glob(f"*_admm_{fmt}_*_model.msgpack")
    (log,) = (tmp_path / "admm").glob("*.log")
    (row,) = [json.loads(r) for r in log.read_text().splitlines()]
    assert np.isfinite(row["train_loss"]) and len(row["admm_residuals"]) == 28
    cli_main(["--model", model, "--decompose", "--model-path", str(dense),
              "--epochs", "1", "--steps-per-epoch", "1", "--save-model",
              "--output-dir", str(tmp_path / "ft"), *common])
    assert f"compression {ratio}x" in capsys.readouterr().out
    (ft,) = (tmp_path / "ft").glob("*_model.msgpack")
    r = cli_main(["--model", model, "--eval", "--model-path", str(ft),
                  *common])
    assert set(r) == {"acc1", "acc5", "loss"} and np.isfinite(r["loss"])
    rt = cli_main(["--model", model, "--runtime", "--model-path", str(ft),
                   *common])
    assert rt["ms_per_image"] > 0
