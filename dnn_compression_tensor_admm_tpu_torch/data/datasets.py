"""Dataset geometry, the CIFAR-10/100 and MNIST file readers and the
deterministic synthetic datasets (counterpart of the JAX package's
`data/datasets.py`).

The readers parse the python-pickle CIFAR batches (`cifar-10-batches-py`,
extracted from `cifar-10-python.tar.gz` on first use;
`cifar-100-python`) and MNIST's idx files (plain or gzipped) from
`data_dir` into uint8 NHWC arrays. Nothing is downloaded: a missing file
raises with the path it looked for, and a file dataset without a
`data_dir` raises.

The synthetic generator is the JAX package's numpy arithmetic, so both
packages see the same bytes for the same name and size. It renders only
the prototypes the labels use and fills the images in chunks: at
ImageNet geometry the JAX code stacks all 1000 float64 prototypes
(1.2 GB) and a float64 copy of the whole set.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional, Tuple

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    num_classes: int
    input_size: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]


_INFO = {
    "cifar10": DatasetInfo("cifar10", 10, 32, CIFAR10_MEAN, CIFAR10_STD),
    "cifar100": DatasetInfo("cifar100", 100, 32, CIFAR100_MEAN, CIFAR100_STD),
    "mnist": DatasetInfo("mnist", 10, 28, (0.1307,), (0.3081,)),
    "imagenet": DatasetInfo("imagenet", 1000, 224, IMAGENET_MEAN,
                            IMAGENET_STD),
}


def _split_synthetic(name: str):
    """-> (base_name, mode) where mode is None | 'easy' | 'hard'."""
    if name.startswith("synthetic-hard-"):
        return name[len("synthetic-hard-"):], "hard"
    if name.startswith("synthetic-"):
        return name[len("synthetic-"):], "easy"
    return name, None


def dataset_info(name: str) -> DatasetInfo:
    return _INFO[_split_synthetic(name)[0]]


def _synthetic(info: DatasetInfo, train: bool, n: Optional[int] = None,
               hard: bool = False):
    """Class-conditional low-frequency patterns plus noise. `hard` renders
    15% of the images from another class's prototype (label kept), with
    amplitude jitter and 2x noise, so accuracy stays below 100%."""
    n = n or (50_000 if train else 10_000)
    rng = np.random.RandomState(0 if train else 1)
    y = rng.randint(0, info.num_classes, size=n).astype(np.int32)
    s = info.input_size
    c = len(info.mean)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    prng = np.random.RandomState(1234)
    freqs = []
    for _ in range(info.num_classes):  # every class's draws, in order
        f = prng.uniform(1, 4, size=(2, c))
        ph = prng.uniform(0, 2 * np.pi, size=(2, c))
        freqs.append((f, ph))

    def proto(k):  # float64 [s, s, c]
        f, ph = freqs[k]
        return 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * yy[..., None] + ph[0]) +
                             np.sin(2 * np.pi * f[1] * xx[..., None] + ph[1]))

    render = y
    if hard:
        k = info.num_classes
        render = y.copy()
        flip = rng.rand(n) < 0.15
        render[flip] = rng.randint(0, k, size=int(flip.sum()))
        amp = rng.uniform(0.6, 1.4, size=(n, 1, 1, 1)).astype(np.float32)
        noise = rng.normal(0, 0.3, size=(n, s, s, c)).astype(np.float32)
    else:
        noise = rng.normal(0, 0.15, size=(n, s, s, c)).astype(np.float32)
    used = np.unique(render)
    table = np.stack([proto(k) for k in used])
    idx = np.searchsorted(used, render)
    x = np.empty((n, s, s, c), np.uint8)
    for i in range(0, n, 64):  # the same float64 arithmetic, chunk by chunk
        j = slice(i, i + 64)
        p = table[idx[j]]
        if hard:
            p = 0.5 + amp[j] * (p - 0.5)
        x[j] = (np.clip(p + noise[j], 0, 1) * 255).astype(np.uint8)
    return x, y


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found (nothing is downloaded)")
    return path


def _unpickle(path: str) -> dict:
    with open(_existing(path), "rb") as f:
        return pickle.load(f, encoding="bytes")


def _nhwc(data) -> np.ndarray:
    """CIFAR's [N, 3072] rows (channel planes) as uint8 [N, 32, 32, 3]."""
    x = np.asarray(data, np.uint8).reshape(-1, 3, 32, 32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _load_cifar10(data_dir: str, train: bool):
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        tgz = os.path.join(data_dir, "cifar-10-python.tar.gz")
        if not os.path.exists(tgz):
            raise FileNotFoundError(f"neither {base} nor {tgz} exists "
                                    "(nothing is downloaded)")
        with tarfile.open(tgz) as tf:
            tf.extractall(data_dir, filter="data")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    batches = [_unpickle(os.path.join(base, fn)) for fn in files]
    x = _nhwc(np.concatenate([b[b"data"] for b in batches]))
    y = np.asarray([v for b in batches for v in b[b"labels"]], np.int32)
    return x, y


def _load_cifar100(data_dir: str, train: bool):
    d = _unpickle(os.path.join(data_dir, "cifar-100-python",
                               "train" if train else "test"))
    return _nhwc(d[b"data"]), np.asarray(d[b"fine_labels"], np.int32)


def _load_mnist(data_dir: str, train: bool):
    prefix = "train" if train else "t10k"

    def read(stem: str) -> bytes:
        path = os.path.join(data_dir, stem)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
        with gzip.open(_existing(path + ".gz"), "rb") as f:
            return f.read()

    img = read(f"{prefix}-images-idx3-ubyte")
    lab = read(f"{prefix}-labels-idx1-ubyte")
    _, n, h, w = struct.unpack(">IIII", img[:16])
    x = np.frombuffer(img, np.uint8, offset=16).reshape(n, h, w, 1)
    y = np.frombuffer(lab, np.uint8, offset=8).astype(np.int32)
    return x.copy(), y


_READERS = {"cifar10": _load_cifar10, "cifar100": _load_cifar100,
            "mnist": _load_mnist}


def load_dataset(name: str, train: bool, synthetic_size: Optional[int] = None,
                 data_dir: Optional[str] = None):
    """Returns (images uint8 [N, H, W, C], labels int32 [N], DatasetInfo)
    for a 'synthetic-<name>' or 'synthetic-hard-<name>' dataset, or for
    'cifar10', 'cifar100' or 'mnist' read from `data_dir`."""
    base, mode = _split_synthetic(name)
    info = dataset_info(base)
    if mode is not None:
        x, y = _synthetic(info, train, synthetic_size, hard=(mode == "hard"))
        return x, y, info
    if base not in _READERS:
        raise ValueError(f"{name!r}: no file reader; the readers are "
                         f"{sorted(_READERS)} and the synthetic-* sets")
    if data_dir is None:
        raise ValueError(f"{name!r} is read from files: give data_dir "
                         "(--data-dir)")
    x, y = _READERS[base](data_dir, train)
    return x, y, info
