"""Global configuration for the PyTorch/CUDA port of bmSparse.

Counterpart of ``bmsparse_tpu/config.py``: the format geometry as module
constants, runtime tunables in `Config` (environment overrides), and the
shape-bucketing helpers, copied exactly so that sizes computed from them
agree with the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

# Format geometry (ref: include/bmSpMatrix.h:15-17). Part of the on-array
# format definition; must not change.
BLOCK_WIDTH = 8
BLOCK_HEIGHT = 8
BLOCK_SIZE = BLOCK_WIDTH * BLOCK_HEIGHT  # 64 — bits in one occupancy bitmap


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


@dataclasses.dataclass
class Config:
    """Runtime tunables. They select how a result is computed, never what
    it is."""

    # Shape bucketing for dynamic sizes (see bucket_size).
    bucket_shapes: bool = _env_bool("BMSP_BUCKET_SHAPES", True)
    # Default SpMV implementation: "auto" (the CUDA kernels for float32 and
    # bfloat16 on a CUDA device, the plain torch versions on the CPU and
    # for float64), "cuda" (the kernels; raises on CPU tensors and for
    # float64) or "plain" (plain torch everywhere).
    spmv_impl: str = os.environ.get("BMSP_TORCH_SPMV_IMPL", "auto")
    # Default SpGEMM implementation: the three values of spmv_impl, or
    # "xla", the JAX package's chunked segment-sum numeric (plain torch on
    # every device; ops/spgemm.py).
    spgemm_impl: str = os.environ.get("BMSP_SPGEMM_IMPL", "auto")
    # Tile-window plans for the SpGEMM K-groups (csrc/spgemm_window.cu):
    # "auto" = on for CUDA operands, "on" = always (tests, so that the
    # plan equals the JAX package's under "on"), "off" = never. Read at
    # plan time, so a cached plan stays self-consistent.
    spgemm_winkernel: str = os.environ.get("BMSP_SPGEMM_WINKERNEL", "auto")
    # SpGEMM compress stage, read at plan time (the JAX package's names):
    # "auto" and "scatter" = the row scatter-add; "fold" = the gather-fold
    # where the plan's contributor runs allow it, else the scatter; "mxu" =
    # the segment compress (csrc/segment_compress.cu on CUDA tensors; the
    # name is the JAX package's, whose kernel uses the TPU's MXU).
    spgemm_compress: str = os.environ.get("BMSP_SPGEMM_COMPRESS", "auto")
    # Per-phase timing of spgemm() (the reference's VERBOSE flag).
    verbose: bool = _env_bool("BMSP_VERBOSE", False)


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, minimum: int = 16) -> int:
    """Round a dynamic size up to a shape bucket to bound recompilation.

    Buckets are {m, 1.25m, 1.5m, 1.75m} for each power of two m — at most
    4 buckets per octave, ≤ 25% padding overhead.
    """
    if n <= minimum:
        return minimum
    if not _config.bucket_shapes:
        return n
    m = 1 << (n - 1).bit_length() - 1  # largest pow2 <= n-1... floor pow2
    while m < n:
        step = max(m // 4, 1)
        for k in range(1, 5):
            if m + k * step >= n:
                return m + k * step
        m *= 2
    return m
