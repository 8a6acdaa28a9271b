"""Build and load the port's CUDA kernels.

The sources in ``bmsparse_tpu_torch/csrc/`` are compiled with nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, and loaded with ctypes. The library lands in
``build/bmsparse_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. A missing nvcc or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bmsparse_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # time of this process's build, if any


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbmsp_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the "
            "CUDA kernels of bmsparse_tpu_torch cannot be built")
    return path


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"{so.stem}.{os.getpid()}.objs"
    objs.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in sources() if s.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    failed = []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(o) for o in sorted(objs.glob("*.o")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}): "
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, so)
    return so


def build_log() -> str:
    """The compiler's output (ptxas register and shared-memory report)
    of the current library's build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.bmsp_dia_spmv.argtypes = [p, i32, p, p, i32, i64, i64, i64, p, p]
    lib.bmsp_dia_spmv.restype = i32
    lib.bmsp_sell_window.argtypes = [p, i32, p, p, p, p, p, i64, i64, i64,
                                     p, p]
    lib.bmsp_sell_window.restype = i32
    lib.bmsp_sell_gather.argtypes = [p, i32, p, p, i64, p, p, i64, p, i64,
                                     i64, p, p, i64, p]
    lib.bmsp_sell_gather.restype = i32
    for fn in (lib.bmsp_numeric_sell, lib.bmsp_numeric_window):
        fn.argtypes = [p, p, i32, i64, i64, p, p, p, i64, i64, p, p]
        fn.restype = i32
    lib.bmsp_window_product.argtypes = [p, p, p, p, i64, i64, i64, i64, p, p]
    lib.bmsp_window_product.restype = i32
    lib.bmsp_rowwise_gather.argtypes = [p, p, i64, i64, i64, p, p]
    lib.bmsp_rowwise_gather.restype = i32
    lib.bmsp_segment_compress.argtypes = [p, p, i64, i64, p, p]
    lib.bmsp_segment_compress.restype = i32
    lib.bmsp_bitmap_compress.argtypes = [p, p, p, p, i64, i64, i64, p, p]
    lib.bmsp_bitmap_compress.restype = i32
    lib.bmsp_error_string.argtypes = [i32]
    lib.bmsp_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = load().bmsp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
