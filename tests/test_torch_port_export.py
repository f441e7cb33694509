"""Export from the port: the ONNX file of `utils/onnx_export.py` against
the JAX package's exporter on the same variables (byte for byte for dense,
Tucker-2 and SVD trees; for TT trees the same graph, the merged chains
within 1e-6 of their scale), `chip_smoke.py`'s ONNX runner against the JAX
ONNX test's numpy runtime and against the port's forward, the
`torch.export` program of `utils/export.py` against the eager forward,
and the CLI's `--export-onnx` / `--export` / `--export-savedmodel`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.hp import SVDSpec as JaxSVDSpec
from dnn_compression_tensor_admm_tpu.configs.hp import TTLinearSpec as JaxTTLinearSpec
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.utils import checkpoint as jax_ckpt
from dnn_compression_tensor_admm_tpu.utils.onnx_export import (
    export_onnx as jax_export_onnx)
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.configs import (
    RankPlan, SVDSpec, TTLinearSpec)
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.utils.export import (
    export_model, export_savedmodel, load_exported)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict
from dnn_compression_tensor_admm_tpu_torch.utils import onnx_export as ox
from dnn_compression_tensor_admm_tpu_torch.utils.onnx_export import (
    export_onnx, pb_fields)
from test_onnx_export import run_onnx as jax_run_onnx
from torch_port_jax import seeded_variables

VIT = dict(img_size=32, embed_dim=48, depth=2, num_heads=3, num_classes=10)
# the TT ViT's four linears a block: (out, in) -> the TT shapes, out first
TT_SHAPES = {"attn.qkv": (12, 12, 6, 8), "attn.proj": (6, 8, 6, 8),
             "mlp.fc1": (12, 16, 6, 8), "mlp.fc2": (6, 8, 12, 16)}
TT_RANKS = (1, 6, 8, 6, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tt_vit_plans():
    names = [f"blocks.{i}.{k}.weight" for i in range(VIT["depth"])
             for k in TT_SHAPES]
    out = {n: {"attn.qkv": 144, "mlp.fc1": 192}.get(
        ".".join(n.split(".")[2:4]), 48) for n in names}
    shape = {n: TT_SHAPES[".".join(n.split(".")[2:4])] for n in names}
    return (RankPlan("tt", {n: TTLinearSpec.create(shape[n], TT_RANKS, out[n])
                            for n in names}),
            JaxRankPlan("tt", {n: JaxTTLinearSpec.create(shape[n], TT_RANKS,
                                                         out[n])
                               for n in names}))


def _svd_resnet50_plans():
    """Plain SVD of ResNet-50's bottleneck 1x1 convs at a quarter of full
    rank (neither package builds an SVD CIFAR ResNet: its SVD conv takes
    1x1 kernels alone, and those ResNets have none)."""
    names, planes = {}, 64
    for stage, n in enumerate((3, 4, 6, 3), start=1):
        for i in range(n):
            cin = 4 * planes if i else (64 if stage == 1 else 2 * planes)
            names[f"layer{stage}.{i}.conv1.weight"] = min(cin, planes) // 4
            names[f"layer{stage}.{i}.conv3.weight"] = planes // 4
        planes *= 2
    return (RankPlan("svd", {n: SVDSpec(r) for n, r in names.items()}),
            JaxRankPlan("svd", {n: JaxSVDSpec(r) for n, r in names.items()}))


def _models(key):
    """(JAX seeded variables, the port model carrying them, input side,
    ViT heads or None)."""
    if key in ("vit", "tt_vit"):
        tplan, jplan = _tt_vit_plans() if key == "tt_vit" else (None, None)
        jm = JaxViT(**VIT, plan=jplan)
        tm = VisionTransformer(**VIT, plan=tplan)
        heads = VIT["num_heads"]
    elif key == "svd_resnet50":
        tplan, jplan = _svd_resnet50_plans()
        jm = jax_model("resnet50", num_classes=10, plan=jplan)
        tm = create_model("resnet50", num_classes=10, plan=tplan)
        assert "layer4.2.conv3.first_factor" in tm.state_dict()
        heads = None
    else:
        name, kw = {"resnet20": ("resnet20", {}),
                    "tkc_resnet32": ("tkc_resnet32", {"ratio": "3"}),
                    "ttm_resnet20": ("ttm_resnet20", {"ratio": "3"})}[key]
        jm = jax_model(name, num_classes=10, **kw)
        tm = create_model(name, num_classes=10, **kw)
        heads = None
    v = seeded_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    tm.load_state_dict(jax_to_state_dict(v))
    return v, tm.eval(), 32, heads


def _both(key, tmp_path):
    """The JAX exporter's bytes and the port's, for the same weights."""
    v, tm, size, heads = _models(key)
    kw = dict(num_classes=10, input_size=size, num_heads=heads)
    want = jax_export_onnx(v, str(tmp_path / "jax.onnx"), **kw)
    got = export_onnx(tm, str(tmp_path / "port.onnx"), **kw)
    with open(tmp_path / "port.onnx", "rb") as f:
        assert f.read() == got
    return want, got, tm


def _graph(data):
    """(nodes' bytes, [(initializer name, dims, array)], inputs, outputs)."""
    g = pb_fields(pb_fields(data)[7][0])
    inits = []
    for tb in g.get(5, []):
        f = pb_fields(tb)
        dtype = {1: np.float32, 7: np.int64}[f[2][0]]
        inits.append((f[8][0].decode(), tuple(f.get(1, [])),
                      np.frombuffer(f[9][0], dtype=dtype)))
    return g[1], inits, g[11], g[12]


@pytest.mark.parametrize("key", ["resnet20", "tkc_resnet32", "svd_resnet50",
                                 "vit"])
def test_onnx_bytes_equal_the_jax_exporter(tmp_path, key):
    want, got, _ = _both(key, tmp_path)
    assert got == want


@pytest.mark.parametrize("key", ["ttm_resnet20", "tt_vit"])
def test_tt_onnx_graph_equals_the_jax_exporter(tmp_path, key):
    """The same nodes, inputs, outputs and initializer names and shapes;
    the TT chains (merged by each package in its own order) within 1e-6
    of their scale, every other initializer equal."""
    want, got, _ = _both(key, tmp_path)
    w_nodes, w_inits, w_in, w_out = _graph(want)
    g_nodes, g_inits, g_in, g_out = _graph(got)
    assert (g_nodes, g_in, g_out) == (w_nodes, w_in, w_out)
    assert [i[:2] for i in g_inits] == [i[:2] for i in w_inits]
    merged = 0
    for (name, _, g), (_, _, w) in zip(g_inits, w_inits):
        if np.array_equal(g, w):
            continue
        merged += 1
        assert name.endswith((".first.w", ".last.w", ".m0", ".m1")), name
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-6 * scale, name
    assert merged > 0


@pytest.mark.parametrize("key", ["tkc_resnet32", "ttm_resnet20", "tt_vit"])
def test_chip_smoke_onnx_runner(tmp_path, key):
    """`chip_smoke.run_onnx` (torch ops) against the JAX ONNX test's numpy
    runtime on the same file within 1e-5, and against the port's
    forward within the JAX test's rtol = atol = 2e-3."""
    _, data, tm = _both(key, tmp_path)
    x = np.random.RandomState(1).rand(1, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        y, n_nodes = chip_smoke.run_onnx(data, torch.from_numpy(x))
        y_model = tm(torch.from_numpy(x))
    assert n_nodes == len(_graph(data)[0])
    y_numpy = jax_run_onnx(data, x)
    np.testing.assert_allclose(y.numpy(), y_numpy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), y_model.numpy(),
                               rtol=chip_smoke.ONNX_TOL,
                               atol=chip_smoke.ONNX_TOL)


def test_onnx_runner_refuses_an_unknown_op():
    graph = ox.OnnxGraph("g")
    graph.inputs.append(ox.value_info("input", [1, 2]))
    out = graph.node("Tanh", ["input"])
    graph.outputs.append(ox.value_info(out, [1, 2]))
    with pytest.raises(ValueError, match="Tanh"):
        chip_smoke.run_onnx(graph.serialize(), torch.zeros(1, 2))


@pytest.mark.parametrize("key", ["tkc_resnet32", "ttm_resnet20", "tt_vit"])
def test_torch_export_program_equals_the_eager_forward(tmp_path, key):
    _, tm, size, _ = _models(key)
    path = str(tmp_path / "m.pt2")
    blob = export_model(tm, (2, 3, size, size), path)
    x = torch.from_numpy(
        np.random.RandomState(2).rand(2, 3, size, size).astype(np.float32))
    with torch.no_grad():
        want = tm(x)
        for program in (load_exported(path), load_exported(blob)):
            got = program.module()(x)
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= 1e-6 * float(
                want.abs().max())


def test_export_savedmodel_raises():
    _, tm, _, _ = _models("resnet20")
    with pytest.raises(RuntimeError, match="--export-onnx"):
        export_savedmodel(tm, (1, 3, 32, 32), "unused")


def test_onnx_export_refuses_other_families(tmp_path):
    """ImageNet MobileNetV2 with the JAX package's error, naming the
    port's --export; MobileNetV2-CIFAR and DenseNet40 too, whose trees
    have a `conv1` but no residual stages."""
    for name in ("mobilenetv2", "mobilenetv2_cifar", "densenet40"):
        with torch.device("meta"):
            sd = create_model(name, num_classes=10).state_dict()
        tree = {"params": {k.split(".")[0]: {} for k in sd}}
        with pytest.raises(ValueError, match="ResNet and ViT/DeiT families "
                           "only.*--export \\(torch.export\\)"):
            export_onnx(tree, str(tmp_path / "x.onnx"), num_classes=10,
                        input_size=32)
    assert not os.path.exists(tmp_path / "x.onnx")


def test_cli_export_flags(tmp_path, capsys):
    """--pretrained --export-onnx --export writes both files from a JAX
    msgpack and returns without evaluating; with --eval it evaluates
    too; --export-savedmodel is refused."""
    v, tm, _, _ = _models("tkc_resnet32")
    ckpt = str(tmp_path / "m.msgpack")
    jax_ckpt.save_variables(ckpt, v)
    onnx_path, program_path = str(tmp_path / "m.onnx"), str(tmp_path / "m.pt2")
    common = ["--model", "tkc_resnet32", "--ratio", "3", "--device", "cpu",
              "--synthetic-size", "32", "--batch-size", "3", "--pretrained",
              "--model-path", ckpt]
    done = cli_main([*common, "--export-onnx", onnx_path,
                     "--export", program_path])
    assert set(done) == {"export_onnx_s", "export_s"}
    assert "acc1" not in capsys.readouterr().out
    with open(onnx_path, "rb") as f:
        assert f.read() == export_onnx(tm, str(tmp_path / "direct.onnx"),
                                       num_classes=10, input_size=32)
    program = load_exported(program_path)
    x = torch.rand(3, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.allclose(program.module()(x), tm(x), rtol=1e-6,
                              atol=1e-6)
    r = cli_main([*common, "--export-onnx", onnx_path, "--eval"])
    assert set(r) == {"acc1", "acc5", "loss"}
    with pytest.raises(RuntimeError, match="--export-onnx"):
        cli_main([*common, "--export-savedmodel", str(tmp_path / "sm")])
