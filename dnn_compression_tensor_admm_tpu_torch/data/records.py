"""The DCTA record-shard format (the JAX package's `data/records.py`, byte
for byte): a 20-byte little-endian header (magic 0x44435441, count,
height, width, channels) and `count` records of an int32 label followed
by the uint8 image [H, W, C]. `native/dataloader.cc` streams these files;
`write_shards` makes them from any uint8 NHWC set."""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np

MAGIC = 0x44435441
HEADER = struct.Struct("<5I")


def _record(h: int, w: int, c: int) -> np.dtype:
    return np.dtype([("label", "<i4"), ("image", "u1", (h, w, c))])


def write_shards(images: np.ndarray, labels: np.ndarray, out_dir: str,
                 samples_per_shard: int = 10_000,
                 prefix: str = "data") -> List[str]:
    """`images` uint8 [N, H, W, C] and `labels` [N] into
    `out_dir/{prefix}-{k:05d}.dcta`, `samples_per_shard` records each."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be uint8 [N, H, W, C], not "
                         f"{images.dtype} {images.shape}")
    n, h, w, c = images.shape
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s0 in range(0, n, samples_per_shard):
        s1 = min(n, s0 + samples_per_shard)
        rec = np.empty(s1 - s0, _record(h, w, c))
        rec["label"] = labels[s0:s1]
        rec["image"] = images[s0:s1]
        path = os.path.join(out_dir,
                            f"{prefix}-{s0 // samples_per_shard:05d}.dcta")
        with open(path, "wb") as f:
            f.write(HEADER.pack(MAGIC, s1 - s0, h, w, c))
            f.write(rec.tobytes())
        paths.append(path)
    return paths


def _header(f, path: str):
    magic, count, h, w, c = HEADER.unpack(f.read(HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"bad magic in {path}")
    return count, h, w, c


def shard_sample_count(path: str) -> int:
    """The record count from the shard's header (no data read)."""
    with open(path, "rb") as f:
        return _header(f, path)[0]


def shard_shape(path: str) -> Tuple[int, int, int]:
    """The shard's image shape (H, W, C), from its header."""
    with open(path, "rb") as f:
        return _header(f, path)[1:]


def read_shard(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A whole shard -> (images uint8 [N, H, W, C], labels int32 [N])."""
    with open(path, "rb") as f:
        count, h, w, c = _header(f, path)
        rec = np.fromfile(f, _record(h, w, c), count)
    if len(rec) != count:
        raise ValueError(f"{path} holds {len(rec)} of its {count} records")
    return (np.ascontiguousarray(rec["image"]),
            rec["label"].astype(np.int32))
