"""`.pth` checkpoints across packages: a file the JAX package writes with
its `utils/torch_import.py` (`variables_to_torch`, `save_torch_state_dict`:
the reference's torch naming, Tucker-2 and TT core kernels HWIO, no
BatchNorm counters) loads into the port through `load_any_variables` and
`--pretrained --model-path`, equal bit for bit to the same variables
carried by `utils/jax_weights.py`; the port's `state_dict_to_torch` gives
the JAX package's names, shapes and values; wrapped files, non-strict
loads and bfloat16 tensors as the JAX package takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.utils import checkpoint as jax_ckpt
from dnn_compression_tensor_admm_tpu.utils.torch_import import (
    save_torch_state_dict as jax_save_pth, variables_to_torch)
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import load_any_variables
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict
from dnn_compression_tensor_admm_tpu_torch.utils.torch_import import (
    load_torch_state_dict, save_torch_state_dict, state_dict_to_torch,
    torch_to_state_dict)
from torch_port_jax import seeded_variables

VIT = dict(img_size=32, embed_dim=48, depth=2, num_heads=3, num_classes=10)
# (port name, kwargs, input side) of each model whose JAX-written .pth
# must load: dense and Tucker-2 CIFAR ResNets, a TT one, torchvision's
# ResNet-18 names (conv1, layerN.M.downsample.0/.1, fc) and a DeiT
MODELS = {
    "resnet20": ("resnet20", {}, 32),
    "tkc_resnet32": ("tkc_resnet32", {"ratio": "3"}, 32),
    "ttm_resnet20": ("ttm_resnet20", {"ratio": "3"}, 32),
    "resnet18": ("resnet18", {"num_classes": 1000}, 32),
    "deit": (None, {}, 32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(key):
    """The JAX model's seeded variables and the port's model."""
    name, kw, size = MODELS[key]
    if name is None:
        jm, tm = JaxViT(**VIT), VisionTransformer(**VIT)
    else:
        jm = jax_model(name, **{"num_classes": 10, **kw})
        tm = create_model(name, **{"num_classes": 10, **kw})
    v = seeded_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    return v, tm


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("key", list(MODELS))
def test_jax_written_pth_loads_bit_for_bit(tmp_path, key):
    """The file the JAX package writes loads to the state dict its
    variables give through `jax_weights`, bit for bit (Tucker-2 and TT
    core kernels HWIO -> OIHW, the BatchNorm counters 0); the port's own
    torch state dict of the same weights loads to the same tensors."""
    v, tm = _models(key)
    path = str(tmp_path / f"{key}.pth")
    jax_save_pth(path, variables_to_torch(v))
    want = jax_to_state_dict(v)
    got = load_any_variables(path, tm.state_dict)
    _assert_same(got, {k: want[k] for k in tm.state_dict()})
    tm.load_state_dict(got)
    torch.save(tm.state_dict(), tmp_path / "own.pt")
    _assert_same(load_any_variables(str(tmp_path / "own.pt"), tm.state_dict),
                 got)


@pytest.mark.parametrize("key", ["tkc_resnet32", "ttm_resnet20", "deit"])
def test_state_dict_to_torch_is_variables_to_torch(key):
    """Names, shapes, dtypes and values of the JAX package's
    `variables_to_torch` for the same weights."""
    v, tm = _models(key)
    tm.load_state_dict(jax_to_state_dict(v))
    want = variables_to_torch(v)
    got = state_dict_to_torch(tm)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        a = np.asarray(a)
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_tucker2_pth_that_failed_before_loads(tmp_path):
    """The fault this module repairs: the JAX-written `tkc_resnet32` file
    (core kernels HWIO, no `num_batches_tracked`) was refused by
    `load_any_variables(path, model.state_dict)` with 'does not hold the
    model's tensors'."""
    v, tm = _models("tkc_resnet32")
    sd = variables_to_torch(v)
    assert sd["layer1.0.conv1.core_kernel"].shape == (3, 3, 16, 16)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "tkc_resnet32.pth")
    jax_save_pth(path, sd)
    got = load_any_variables(path, tm.state_dict)
    assert got["layer1.0.conv1.core_kernel"].shape == (16, 16, 3, 3)
    assert int(got["bn1.num_batches_tracked"]) == 0
    tm.load_state_dict(got)


def test_torchvision_file_keeps_its_counters(tmp_path):
    """A torchvision-style ResNet-18 file with BatchNorm counters and
    wrapped in {'model': ...}: the counters are the file's, every other
    tensor the jax_weights route's."""
    v, tm = _models("resnet18")
    sd = {k: torch.from_numpy(np.ascontiguousarray(a))
          for k, a in variables_to_torch(v).items()}
    counters = {k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(7)
                for k in sd if k.endswith("running_mean")}
    path = str(tmp_path / "r18.pth")
    torch.save({"model": {**sd, **counters}, "epoch": 90}, path)
    got = load_any_variables(path, tm.state_dict)
    want = jax_to_state_dict(v)
    for k, t in got.items():
        assert torch.equal(t, counters[k] if k in counters else want[k]), k
    assert "downsample.0" in "".join(got) and "fc.weight" in got


def test_wrapped_file_and_non_strict_load(tmp_path):
    """{'state_dict': ...} unwraps and drops what is not a tensor; strict
    raises KeyError for a missing head and for an unmapped tensor;
    non-strict keeps the model's own head (JAX
    tests/test_torch_import.py::test_wrapped_state_dict_and_nonstrict)."""
    v, tm = _models("resnet20")
    sd = {k: torch.from_numpy(np.ascontiguousarray(a))
          for k, a in variables_to_torch(v).items()}
    sd.pop("linear.weight")
    sd.pop("linear.bias")
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    loaded = load_torch_state_dict(path)
    assert "conv1.weight" in loaded and "epoch" not in loaded
    with pytest.raises(KeyError, match="missing 2"):
        load_any_variables(path, tm.state_dict)
    with pytest.raises(ValueError, match="need a model template"):
        load_any_variables(path)
    back = torch_to_state_dict(loaded, tm.state_dict(), strict=False)
    assert torch.equal(back["linear.weight"], tm.state_dict()["linear.weight"])
    assert torch.equal(back["conv1.weight"], jax_to_state_dict(v)["conv1.weight"])
    full = {**back, "extra.weight": torch.zeros(2)}
    assert torch_to_state_dict(full, tm.state_dict(), strict=False).keys() \
        == back.keys()
    with pytest.raises(KeyError, match="1 unmapped"):
        torch_to_state_dict(full, tm.state_dict())


def test_bfloat16_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "bf16.pth")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    torch.save({"w": t}, path)
    out = load_torch_state_dict(path)
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], t.float())
    with pytest.raises(ValueError, match="the model has"):
        torch_to_state_dict({"w": torch.zeros(3, 2)}, {"w": torch.zeros(2, 3)})


def test_square_core_kernel_layout():
    """A core kernel square in all four dims fits both layouts: a file
    with BatchNorm counters is the port's own (OIHW), one without is the
    reference's (HWIO)."""
    core = torch.arange(81, dtype=torch.float32).reshape(3, 3, 3, 3)
    template = {"c.core_kernel": torch.zeros(3, 3, 3, 3),
                "bn.num_batches_tracked": torch.tensor(0)}
    ref = torch_to_state_dict({"c.core_kernel": core}, template)
    assert torch.equal(ref["c.core_kernel"], core.permute(3, 2, 0, 1))
    own = torch_to_state_dict({"c.core_kernel": core,
                               "bn.num_batches_tracked": torch.tensor(4)},
                              template)
    assert torch.equal(own["c.core_kernel"], core)
    assert int(own["bn.num_batches_tracked"]) == 4


def test_cli_pretrained_reads_a_jax_written_pth(tmp_path):
    """`--pretrained --model-path x.pth --eval` gives the eval numbers of
    the same weights read from the JAX package's msgpack."""
    v, _ = _models("tkc_resnet32")
    pth, msgpack = str(tmp_path / "m.pth"), str(tmp_path / "m.msgpack")
    jax_save_pth(pth, variables_to_torch(v))
    jax_ckpt.save_variables(msgpack, v)
    common = ["--model", "tkc_resnet32", "--ratio", "3", "--device", "cpu",
              "--synthetic-size", "64", "--fp32", "--pretrained", "--eval"]
    r_pth = cli_main([*common, "--model-path", pth])
    r_msgpack = cli_main([*common, "--model-path", msgpack])
    assert r_pth == r_msgpack and np.isfinite(r_pth["loss"])
    # and --pretrained fine-tunes from the .pth
    model, hist = cli_main(["--model", "tkc_resnet32", "--ratio", "3",
                            "--device", "cpu", "--synthetic-size", "64",
                            "--fp32", "--pretrained", "--model-path", pth,
                            "--epochs", "1", "--steps-per-epoch", "1",
                            "--batch-size", "16"])
    assert np.isfinite(hist[-1]["train_loss"])
