"""Build and load the port's CUDA C++ kernels.

Each source under the package's `csrc/` is compiled by `nvcc` into a
shared library with a plain C interface and loaded with `ctypes`. The
library is named after a hash of its source, every shared header
(`csrc/*.cuh`) and the flags, so a stale build is never loaded; it
lives under `build/torch_kernels/` at the root of the checkout. Nothing
is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless its library exists.

    Returns {'path', 'seconds', 'compiler_output'}; `seconds` is 0 and
    `compiler_output` empty when the library was already built."""
    so = library_path(name)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "compiler_output": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(so), "seconds": seconds,
            "compiler_output": (proc.stdout + proc.stderr).strip()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load `lib<name>` once per process."""
    return ctypes.CDLL(build(name)["path"])
