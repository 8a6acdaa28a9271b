"""MatrixMarket ingestion — counterpart of
``bmsparse_tpu/io/matrix_market.py`` (the reference's `bmSpMatrix(path,
transposed)` parse loop, ref: src/bmSpMatrix.cu:112-161, and CUSP's
`cusp::io::read_matrix_market_file`).

Two parsers with the same semantics (1-based -> 0-based indices;
`symmetric` and `skew-symmetric` files expanded to both triangles, ref:
src/bmSpMatrix.cu:133-149):
  1. scipy.io.mmread (the default; scipy >= 1.12 vendors a multithreaded
     C++ parser),
  2. the native extension `_mmparse` (csrc/mmparse.cpp, built with g++ at
     first use by io/_native.py), selected with native=True or when scipy
     is missing.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def read_matrix_market(
    path: str, dtype=np.float32, native: bool | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """Read a MatrixMarket coordinate file into COO triplets.

    Returns (rows, cols, values, (num_rows, num_cols)) with int32 indices.
    native=True parses natively or raises (with the compiler's output if
    the build fails); it never falls back to scipy.
    """
    if not os.path.exists(path) and os.path.exists(path + ".mtx"):
        # The reference CLI appends ".mtx" to names (src/bmSparse_SPGEMM.cu:1261).
        path = path + ".mtx"
    if native is None:
        try:
            import scipy.io  # noqa: F401

            native = False
        except ImportError:
            native = True
    if native:
        from ._native import load_mmparse

        rows, cols, vals, nr, nc, sym = load_mmparse().parse(path)
        vals = vals.astype(dtype, copy=False)
        if sym:
            off = rows != cols
            mirrored = -vals[off] if sym == 2 else vals[off]  # 2 = skew
            rows, cols = (np.concatenate([rows, cols[off]]),
                          np.concatenate([cols, rows[off]]))
            vals = np.concatenate([vals, mirrored])
        return rows, cols, vals, (nr, nc)

    import scipy.io

    m = scipy.io.mmread(path).tocoo()
    return (
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        np.asarray(m.data, dtype=dtype),
        (m.shape[0], m.shape[1]),
    )


def write_matrix_market(path: str, rows, cols, vals, shape) -> None:
    import scipy.io
    import scipy.sparse as sp

    scipy.io.mmwrite(path, sp.coo_matrix((vals, (rows, cols)), shape=shape))


def mmread_bmsparse(
    path: str,
    transposed: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    **convert_kw,
):
    """File -> BmSparse on `device` (the card unless the caller asks for
    the CPU) in one call (the reference ctor's full pipeline). Values are
    read as float64 when `dtype` is float64 and as float32 otherwise, then
    cast to `dtype`. convert_kw passes through to coo_to_bmsparse
    (backend=, compact=, nb_pad=); the host converter is the default, and
    ignores compact."""
    from ..format.convert import coo_to_bmsparse

    if convert_kw.get("backend", "host") == "host":
        convert_kw.pop("compact", None)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    rows, cols, vals, shape = read_matrix_market(path, dtype=np_dtype)
    m = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed,
                        device=device, **convert_kw)
    return m if m.dtype == dtype else m.astype(dtype)
