"""The port's msgpack checkpoints against the JAX package's: what flax's
`msgpack_serialize` writes (the JAX package's `utils/checkpoint.py`) the
port's own codec reads to the same bytes, and what the port writes flax
reads to the same bytes, for float32, bfloat16, int32, scalars and nested
dicts; anything outside that subset raises."""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_serialize as flax_serialize

from dnn_compression_tensor_admm_tpu.utils import checkpoint as jax_ckpt
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.utils import checkpoint as ckpt
from dnn_compression_tensor_admm_tpu_torch.utils import msgpack as pmsg
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables():
    """A nested tree of every leaf type the codec takes, from a seed."""
    rng = np.random.RandomState(0)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16))
    return {
        "params": {
            "blocks.0": {"attn": {"kernel": rng.standard_normal((6, 4))
                                  .astype(np.float32),
                                  "bias": np.zeros(4, np.float32)}},
            "bf16": bf16,
            "ints": np.arange(-70_000, 70_000, 7, dtype=np.int32),
            "empty": np.zeros((0, 3), np.float32),
            "scalar": np.float32(1.5),
            "count": np.int64(-3),
        },
        "batch_stats": {"bn": {"mean": rng.standard_normal(17)
                               .astype(np.float32)}},
        "meta": {"step": 123_456, "neg": -40, "rate": 0.25, "name": "x" * 40,
                 "flag": True, "none": None, "list": [1, 2.5, "a"],
                 "raw": b"\x00\x01" * 200,
                 "many": {f"k{i}": i for i in range(20)}},
    }


def _leaf_bytes(a):
    if isinstance(a, torch.Tensor):  # bfloat16: its bits
        return a.view(torch.int16).numpy().tobytes()
    return np.asarray(a).tobytes()


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)):
            dtype = "bfloat16" if isinstance(g, torch.Tensor) else g.dtype.name
            assert dtype == w.dtype.name, k
            assert tuple(g.shape) == w.shape, k
            assert _leaf_bytes(g) == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


def test_port_reads_what_flax_writes(tmp_path):
    v = _variables()
    path = tmp_path / "jax.msgpack"
    jax_ckpt.save_variables(str(path), v)
    got = ckpt.load_variables(str(path))
    _assert_same_tree(got, v)
    assert isinstance(got["params"]["bf16"], torch.Tensor)
    assert got["params"]["bf16"].dtype == torch.bfloat16
    # the JAX package's save takes numpy scalars to 0-d arrays (ExtType 1);
    # flax's serialiser alone writes them as ExtType 3, read back as scalars
    assert got["params"]["scalar"].shape == ()
    assert isinstance(pmsg.unpackb(flax_serialize(v))["params"]["scalar"],
                      np.float32)
    assert pmsg.packb(v) == flax_serialize(v)


def test_flax_reads_what_the_port_writes(tmp_path):
    v = _variables()
    path = tmp_path / "port.msgpack"
    ckpt.save_variables(str(path), v)
    _assert_same_tree(jax_ckpt.load_variables(str(path)), v)
    # the same file, byte for byte, as flax's own
    jax_ckpt.save_variables(str(tmp_path / "jax.msgpack"), v)
    assert path.read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_bfloat16_tensor_round_trips_through_flax(tmp_path):
    t = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    path = tmp_path / "bf16.msgpack"
    ckpt.save_variables(str(path), {"w": t})
    back = jax_ckpt.load_variables(str(path))["w"]
    assert back.dtype == jnp.bfloat16
    assert np.asarray(back).view(np.int16).tobytes() == _leaf_bytes(t)
    assert torch.equal(ckpt.load_variables(str(path))["w"], t)


def test_bfloat16_checkpoint_to_state_dict(tmp_path):
    """A bfloat16 flax checkpoint reaches the port's state dict in
    bfloat16, a Dense kernel [in, out] as a Linear weight [out, in]."""
    rng = np.random.RandomState(1)
    kernel = jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(4), jnp.bfloat16)
    path = tmp_path / "bf16.msgpack"
    jax_ckpt.save_variables(str(path), {"params": {"head": {
        "kernel": kernel, "bias": bias}}})
    sd = jax_to_state_dict(ckpt.load_variables(str(path)))
    assert sd.keys() == {"head.weight", "head.bias"}
    assert sd["head.weight"].dtype == torch.bfloat16
    assert _leaf_bytes(sd["head.weight"].contiguous()) == np.asarray(
        kernel).T.copy().tobytes()
    assert _leaf_bytes(sd["head.bias"]) == np.asarray(bias).tobytes()


@pytest.mark.parametrize("payload,match", [
    (msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}),
     "extension type 2"),
    (msgpack.packb({"x": msgpack.ExtType(7, b"abc")}), "extension type 7"),
    # flax's form of an array over 2**30 bytes
    (msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                          "shape": {"0": 2}, "chunks": {}}}), "chunked"),
    (msgpack.packb({1: 2}), "not a str"),
    (msgpack.packb({"a": 1})[:-1], "truncated"),
    (b"\xc1", "type byte 0xc1"),
])
def test_unsupported_input_raises(payload, match):
    with pytest.raises(pmsg.MsgpackError, match=match):
        pmsg.unpackb(payload)


def test_unsupported_leaf_raises():
    with pytest.raises(pmsg.MsgpackError, match="complex"):
        pmsg.packb({"c": complex(1, 2)})
    with pytest.raises(pmsg.MsgpackError, match="not a str"):
        pmsg.packb({1: 2})


def test_load_any_variables_reads_both_formats(tmp_path):
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    ckpt.save_variables(str(tmp_path / "m.msgpack"), state_dict_to_jax(sd))
    torch.save(sd, tmp_path / "m.pt")
    for name in ("m.msgpack", "m.pt"):
        got = ckpt.load_any_variables(str(tmp_path / name), model.state_dict)
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd), name
    # the JAX package reads the port's file to the same variables
    v = jax_ckpt.load_variables(str(tmp_path / "m.msgpack"))
    back = jax_to_state_dict(v)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    other = create_model("resnet32", num_classes=100)
    with pytest.raises(ValueError, match="does not hold the model's tensors"):
        ckpt.load_any_variables(str(tmp_path / "m.msgpack"), other.state_dict)
    with pytest.raises(ValueError, match="a checkpoint is a"):
        ckpt.load_any_variables(str(tmp_path / "m.npz"))


def test_cli_pretrained_fine_tunes_a_msgpack_checkpoint(tmp_path):
    """`--pretrained` reads an already factorized model (here a Tucker-2
    ResNet32 with BatchNorm statistics) from the JAX package's format."""
    model = create_model("tkc_resnet32", ratio="3",
                         generator=torch.Generator().manual_seed(0))
    ckpt.save_variables(str(tmp_path / "tk.msgpack"),
                        state_dict_to_jax(model.state_dict()))
    _, hist = cli_main(["--model", "tkc_resnet32", "--ratio", "3",
                        "--pretrained", "--model-path",
                        str(tmp_path / "tk.msgpack"), "--device", "cpu",
                        "--synthetic-size", "8", "--batch-size", "4",
                        "--epochs", "1", "--steps-per-epoch", "1", "--fp32"])
    assert np.isfinite(hist[-1]["train_loss"])
    assert np.isfinite(hist[-1]["test_loss"])
