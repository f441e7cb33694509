"""The port's CIFAR-10/100 and MNIST file readers against the JAX
package's, on small files in the datasets' own formats that the test
writes (the CIFAR-10 batches also as the `cifar-10-python.tar.gz` the
readers extract), then a training run of `resnet20` from those files
through the command line with `--data-dir` and `--num-classes`."""

import gzip
import os
import pickle
import re
import struct
import tarfile

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.data import datasets as jds
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.data import datasets as tds


def _pickle(path, d):
    with open(path, "wb") as f:
        pickle.dump(d, f)


def _cifar_rows(rng, n):
    return rng.randint(0, 256, size=(n, 3072)).astype(np.uint8)


def _write_cifar10(root, rng, n=6):
    """cifar-10-batches-py: five train batches and a test batch of n."""
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        _pickle(os.path.join(base, fn),
                {b"data": _cifar_rows(rng, n),
                 b"labels": list(rng.randint(0, 10, n))})
    return base


def _same(a, b):
    (xa, ya, ia), (xb, yb, ib) = a, b
    assert xa.dtype == xb.dtype == np.uint8 and xa.shape == xb.shape
    assert xa.tobytes() == xb.tobytes() and ya.dtype == yb.dtype
    assert ya.tobytes() == yb.tobytes()
    assert (ia.num_classes, ia.input_size, ia.mean, ia.std) == (
        ib.num_classes, ib.input_size, ib.mean, ib.std)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_reader_matches_jax(tmp_path, train):
    _write_cifar10(str(tmp_path), np.random.RandomState(0))
    got = tds.load_dataset("cifar10", train, data_dir=str(tmp_path))
    assert got[0].shape == ((30 if train else 6), 32, 32, 3)
    _same(got, jds.load_dataset("cifar10", train, str(tmp_path)))


def test_cifar10_tarball_is_extracted_on_first_use(tmp_path):
    src, dst_t, dst_j = (tmp_path / d for d in ("src", "port", "jax"))
    src.mkdir()
    base = _write_cifar10(str(src), np.random.RandomState(1))
    for dst in (dst_t, dst_j):
        dst.mkdir()
        with tarfile.open(dst / "cifar-10-python.tar.gz", "w:gz") as tf:
            tf.add(base, arcname="cifar-10-batches-py")
    got = tds.load_dataset("cifar10", True, data_dir=str(dst_t))
    assert (dst_t / "cifar-10-batches-py" / "test_batch").exists()
    _same(got, jds.load_dataset("cifar10", True, str(dst_j)))
    _same(tds.load_dataset("cifar10", True, data_dir=str(dst_t)), got)


@pytest.mark.parametrize("train", [True, False])
def test_cifar100_reader_matches_jax(tmp_path, train):
    rng = np.random.RandomState(2)
    base = tmp_path / "cifar-100-python"
    base.mkdir()
    for fn, n in (("train", 10), ("test", 4)):
        _pickle(base / fn, {b"data": _cifar_rows(rng, n),
                            b"fine_labels": list(rng.randint(0, 100, n)),
                            b"coarse_labels": list(rng.randint(0, 20, n))})
    got = tds.load_dataset("cifar100", train, data_dir=str(tmp_path))
    assert got[2].num_classes == 100 and len(got[1]) == (10 if train else 4)
    _same(got, jds.load_dataset("cifar100", train, str(tmp_path)))


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_reader_matches_jax(tmp_path, gz):
    rng = np.random.RandomState(3)
    for prefix, n in (("train", 7), ("t10k", 3)):
        images = (struct.pack(">IIII", 2051, n, 28, 28)
                  + rng.randint(0, 256, (n, 28, 28)).astype(np.uint8).tobytes())
        labels = (struct.pack(">II", 2049, n)
                  + rng.randint(0, 10, n).astype(np.uint8).tobytes())
        for stem, data in ((f"{prefix}-images-idx3-ubyte", images),
                           (f"{prefix}-labels-idx1-ubyte", labels)):
            path = tmp_path / (stem + (".gz" if gz else ""))
            path.write_bytes(gzip.compress(data) if gz else data)
    for train in (True, False):
        got = tds.load_dataset("mnist", train, data_dir=str(tmp_path))
        assert got[0].shape == ((7 if train else 3), 28, 28, 1)
        _same(got, jds.load_dataset("mnist", train, str(tmp_path)))


@pytest.mark.parametrize("name,missing", [
    ("cifar10", "cifar-10-python.tar.gz"),
    ("cifar100", os.path.join("cifar-100-python", "train")),
    ("mnist", "train-images-idx3-ubyte.gz")])
def test_a_missing_file_raises_with_its_path(tmp_path, name, missing):
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / missing))):
        tds.load_dataset(name, True, data_dir=str(tmp_path))


def test_cli_trains_resnet20_from_cifar10_files(tmp_path):
    _write_cifar10(str(tmp_path), np.random.RandomState(4), n=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, hist = cli_main(
            ["--model", "resnet20", "--dataset", "cifar10", "--data-dir",
             str(tmp_path), "--num-classes", "12", "--epochs", "1",
             "--batch-size", "4", "--steps-per-epoch", "2", "--fp32",
             "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert model.linear.out_features == 12
    assert np.isfinite(hist[-1]["train_loss"]) and "test_acc1" in hist[-1]

