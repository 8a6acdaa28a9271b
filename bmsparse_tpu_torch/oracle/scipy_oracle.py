"""scipy.sparse baselines — counterpart of
``bmsparse_tpu/oracle/scipy_oracle.py``, in the role of the reference's
cuSPARSE SpMV baseline (`cusparse_spmv`, ref:
src/cuSparse_spmv.cu:38-165) and of its cuSPARSE SpGEMM baseline
(`cusparse_multiply`, ref: src/cuSparse_mult.cu:35-136), with the same
phase labels and optional CSV sink.
"""

from __future__ import annotations

import time
from typing import IO

import numpy as np
import scipy.sparse as sp


def _as_scipy(m):
    from ..format.bmsparse import BmSparse

    if isinstance(m, BmSparse):
        return m.to_scipy().tocsr()
    return m.tocsr() if sp.issparse(m) else sp.csr_matrix(np.asarray(m))


def oracle_spgemm(a, b, csv_out: IO | None = None, verbose: bool = False):
    """C = A @ B via scipy CSR — the cusparseScsrgemm2 stand-in."""
    t0 = time.perf_counter()
    a = _as_scipy(a)
    b = _as_scipy(b)
    t1 = time.perf_counter()
    c = (a @ b).tocsr()
    c.sum_duplicates()
    t2 = time.perf_counter()
    if verbose:
        print(f"Preprocesamiento cusp: {(t1 - t0) * 1e6:.0f}")
        print(f"Cusparse multiplication: {(t2 - t1) * 1e6:.0f}")
    if csv_out is not None:
        csv_out.write(f"{(t1 - t0) * 1e6:.0f},{(t2 - t1) * 1e6:.0f},{c.nnz}\n")
    return c


def oracle_spmv(a, v, csv_out: IO | None = None, verbose: bool = False):
    """u = A @ v via scipy CSR — the cusparseSpMV (CSR_ALG1) stand-in."""
    t0 = time.perf_counter()
    a = _as_scipy(a)
    v = np.asarray(v)
    t1 = time.perf_counter()
    u = a @ v
    t2 = time.perf_counter()
    if verbose:
        print(f"Preprocesamiento cusp: {(t1 - t0) * 1e6:.0f}")
        print(f"Cusparse SpMV execution: {(t2 - t1) * 1e6:.0f}")
    if csv_out is not None:
        csv_out.write(f"{(t1 - t0) * 1e6:.0f},{(t2 - t1) * 1e6:.0f}\n")
    return u


def dense_oracle_spgemm(a, b) -> np.ndarray:
    """C = A @ B as a dense float64 array (small matrices only)."""
    return _as_scipy(a).toarray() @ _as_scipy(b).toarray()
