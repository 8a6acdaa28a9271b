"""Host build of the native MatrixMarket parser (csrc/mmparse.cpp).

A CPython/numpy extension with no CUDA, compiled at first use with the
host C++ compiler (g++) against the running interpreter's and numpy's
headers, into ``build/bmsparse_tpu_torch/`` beside the package, named by
a hash of the source, the flags and the interpreter's ABI, and loaded
with importlib. Kept apart from ops/cuda/build.py, which needs nvcc, so
that a machine without a card builds it too. A missing compiler or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "mmparse.cpp"
BUILD_DIR = _PKG.parent / "build" / "bmsparse_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_module = None


def _includes() -> list[str]:
    import numpy

    return [sysconfig.get_paths()["include"], numpy.get_include()]


def library_path() -> Path:
    import numpy

    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(f"{suffix} {numpy.__version__}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"_mmparse_{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the parser unless a build of this source exists."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native MatrixMarket "
                           "parser of bmsparse_tpu_torch cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *(f"-I{d}" for d in _includes()), str(SOURCE),
           "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load_mmparse():
    """The `_mmparse` extension module, built on first use."""
    global _module
    if _module is None:
        spec = importlib.util.spec_from_file_location("_mmparse", build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    return _module
