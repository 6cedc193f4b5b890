"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source
and flags, so a changed source rebuilds at its first use. Nothing is built
when a module is imported: the CPU tests import every module, and there is
no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """The loaded libraries for csrc/<name>.cu, each built on first use;
    the missing ones build together, one nvcc process each."""
    started = []
    for name in dict.fromkeys(names):
        if name in _libs:
            continue
        so = _so_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, name + ".cu")
        started.append((name, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in started:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_so_path(name))
    return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else load_all([name])[0]
