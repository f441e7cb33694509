"""Dataset geometry and the deterministic synthetic datasets
(counterpart of the JAX package's `data/datasets.py`; its CIFAR and
MNIST file readers wait for a later slice).

The synthetic generator is the JAX package's numpy arithmetic, so both
packages see the same bytes for the same name and size. It renders only
the prototypes the labels use and fills the images in chunks: at
ImageNet geometry the JAX code stacks all 1000 float64 prototypes
(1.2 GB) and a float64 copy of the whole set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
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


def load_dataset(name: str, train: bool, synthetic_size: Optional[int] = None):
    """Returns (images uint8 [N, H, W, C], labels int32 [N], DatasetInfo)
    for a 'synthetic-<name>' or 'synthetic-hard-<name>' dataset."""
    base, mode = _split_synthetic(name)
    if mode is None:
        raise ValueError(f"{name!r}: only synthetic-* datasets are ported "
                         "so far (the file readers wait)")
    info = dataset_info(base)
    x, y = _synthetic(info, train, synthetic_size, hard=(mode == "hard"))
    return x, y, info
