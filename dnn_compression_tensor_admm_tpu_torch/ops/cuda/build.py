"""Build and load the port's CUDA C++ kernels.

Each source under the package's `csrc/` is compiled by `nvcc` into a
shared library with a plain C interface and loaded with `ctypes`. The
library is named after a hash of its source, every shared header
(`csrc/*.cuh`) and the flags, so a stale build is never loaded; it
lives under `build/torch_kernels/` at the root of the checkout. Nothing
is built at import: the first launch builds. `src_dir` and `defines`
build another checkout's sources, or this one's with its tuning macros
set (`tools/torch_kernel_ab.py`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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


def _flags(defines) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, src_dir: Path = SRC_DIR, defines=()) -> Path:
    digest = hashlib.sha256()
    for src in [src_dir / f"{name}.cu", *sorted(src_dir.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, src_dir: Path = SRC_DIR, defines=()) -> dict:
    """Compile `<src_dir>/<name>.cu`, with `-D` for each of `defines`,
    unless its library exists.

    Returns {'path', 'seconds', 'compiler_output'}; `seconds` is 0 and
    `compiler_output` empty when the library was already built."""
    so = library_path(name, src_dir, defines)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "compiler_output": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
           str(src_dir / f"{name}.cu")]
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
def load(name: str, src_dir: Path = SRC_DIR, defines=()) -> ctypes.CDLL:
    """Build if needed, then load the library once per process
    (`defines` a tuple)."""
    return ctypes.CDLL(build(name, src_dir, defines)["path"])
