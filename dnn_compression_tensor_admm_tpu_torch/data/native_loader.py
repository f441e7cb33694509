"""ctypes binding of the C++ record-shard loader, `native/dataloader.cc`
(the JAX package's `data/native_loader.py` over the same C API).

The port builds the loader itself, at first use, with `g++ -O3
-std=c++17 -fPIC -pthread -shared` into `build/native_loader/` at the
root of the checkout (gitignored), named after a hash of the source and
the flags; it never loads or rebuilds the library in `native/`. A failed
build raises: there is no pure-Python reader in its place.

Usage:
    loader = NativeLoader(shard_paths, batch_size=256, workers=4)
    for images, labels, n_valid in loader:   # numpy uint8 / int32 batches
        ...
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataloader.cc"
BUILD_DIR = _ROOT / "build" / "native_loader"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
PREFETCH = 8  # batches the loader's threads keep ready


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdcta_loader_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `native/dataloader.cc` unless its library exists; raises
    with the compiler's output where g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the shard loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the shard loader failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.dcta_loader_create.restype = ctypes.c_void_p
    lib.dcta_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.dcta_loader_create_strided.restype = ctypes.c_void_p
    lib.dcta_loader_create_strided.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dcta_loader_batch_spec.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dcta_loader_total.restype = ctypes.c_long
    lib.dcta_loader_total.argtypes = [ctypes.c_void_p]
    lib.dcta_loader_next.restype = ctypes.c_int
    lib.dcta_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.dcta_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeLoader:
    """Iterates (images [B, H, W, C] uint8, labels [B] int32, n_valid):
    `workers` threads read, shuffle (from `seed`) and batch the shards,
    `PREFETCH` batches ahead. With `loop` it goes on past the last record;
    with `drop_last` a short last batch is dropped. With `stride` > 1 it
    serves only rows offset::stride of the shards' global sample index
    (`parallel.dist.partition_shard_paths`: disjoint across offsets)."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 workers: int = 4, seed: int = 0,
                 drop_last: bool = False, loop: bool = False,
                 stride: int = 1, offset: int = 0):
        self._lib = get_lib()
        arr = (ctypes.c_char_p * len(shard_paths))(
            *[os.fsencode(p) for p in shard_paths])
        if stride > 1:
            self._ptr = self._lib.dcta_loader_create_strided(
                arr, len(shard_paths), batch_size, workers, PREFETCH, seed,
                int(drop_last), int(loop), stride, offset)
        else:
            self._ptr = self._lib.dcta_loader_create(
                arr, len(shard_paths), batch_size, workers, PREFETCH, seed,
                int(drop_last), int(loop))
        if not self._ptr:
            raise RuntimeError(f"cannot open the shards "
                               f"{list(shard_paths)[:2]}...")
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._lib.dcta_loader_batch_spec(self._ptr, ctypes.byref(h),
                                         ctypes.byref(w), ctypes.byref(c))
        self.batch_size = batch_size
        self.shape = (h.value, w.value, c.value)
        self.total = self._lib.dcta_loader_total(self._ptr)

    def next_into(self, images: np.ndarray, labels: np.ndarray) -> int:
        """Fills contiguous `images` [B, H, W, C] uint8 and `labels` [B]
        int32 with the next batch; its count of valid rows, 0 at the end."""
        if not (images.flags.c_contiguous and labels.flags.c_contiguous
                and images.dtype == np.uint8 and labels.dtype == np.int32
                and images.shape == (self.batch_size, *self.shape)
                and labels.shape == (self.batch_size,)):
            raise ValueError("next_into needs contiguous uint8 "
                             f"{(self.batch_size, *self.shape)} images and "
                             f"int32 [{self.batch_size}] labels")
        return self._lib.dcta_loader_next(self._ptr, images.ctypes.data,
                                          labels.ctypes.data)

    def __iter__(self):
        while True:
            images = np.empty((self.batch_size, *self.shape), np.uint8)
            labels = np.empty((self.batch_size,), np.int32)
            n = self.next_into(images, labels)
            if n == 0:
                return
            yield images, labels, n

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.dcta_loader_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
