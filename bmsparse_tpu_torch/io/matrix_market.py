"""MatrixMarket ingestion — counterpart of
``bmsparse_tpu/io/matrix_market.py`` (the reference's `bmSpMatrix(path,
transposed)` parse loop, ref: src/bmSpMatrix.cu:112-161), parsed by
scipy.io.mmread: 1-based -> 0-based indices, and `symmetric` files
expanded to both triangles (ref: src/bmSpMatrix.cu:133-149).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def read_matrix_market(
    path: str, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """Read a MatrixMarket coordinate file into COO triplets.

    Returns (rows, cols, values, (num_rows, num_cols)) with int32 indices.
    """
    if not os.path.exists(path) and os.path.exists(path + ".mtx"):
        # The reference CLI appends ".mtx" to names (src/bmSparse_SPGEMM.cu:1261).
        path = path + ".mtx"
    import scipy.io

    m = scipy.io.mmread(path).tocoo()
    return (
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        np.asarray(m.data, dtype=dtype),
        (m.shape[0], m.shape[1]),
    )


def mmread_bmsparse(
    path: str,
    transposed: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """File -> BmSparse on `device` (the card unless the caller asks for
    the CPU) in one call (the reference ctor's full pipeline). Values are
    read as float64 when `dtype` is float64 and as float32 otherwise, then
    cast to `dtype`."""
    from ..format.convert import coo_to_bmsparse

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    rows, cols, vals, shape = read_matrix_market(path, dtype=np_dtype)
    m = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed,
                        device=device)
    return m if m.dtype == dtype else m.astype(dtype)
