"""Iterated sparse products with the structure-cached SpGEMM path —
counterpart of the JAX package's ``examples/matrix_powers.py``.

Markov-chain mixing / graph multi-hop counting style workload: compute
u = A^4 v from cached products and SpMV. The structure of A @ A is
planned ONCE (`prepare_product`); re-multiplies after value updates run
the device-only numeric path with no host sync — which the reference
lacks (it re-runs its full pipeline per multiply, ref:
src/bmSparse_SPGEMM.cu:827).

    python -m bmsparse_tpu_torch.examples.matrix_powers [n] [band]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# A^4 v against scipy in float64: max|u - ref| / max|ref|
ERR_BOUND = 1e-4


def run(n: int = 65536, band: int = 8, device="cuda") -> dict:
    """Plan A @ A once, multiply once as a warm-up and then time the
    cached, numeric-only multiply (the median of 5; CUDA events on the
    card), then u = A^2 (A^2 v) through two SpMVs on prepare(A^2).
    Returns the sizes, the times in seconds and the error against
    scipy."""
    import scipy.sparse as sp

    from .. import coo_to_bmsparse, prepare_product
    from ..ops.plan import prepare
    from ..ops.spmv import spmv
    from ..utils.timing import sync, time_op

    rng = np.random.default_rng(0)
    offs = np.arange(-band // 2, band // 2 + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.random(rows.shape[0]).astype(np.float32) + 0.1
    a = coo_to_bmsparse(rows, cols, vals, (n, n), device=device)
    # the same matrix in the transposed intra-block layout of SpGEMM's B
    # operand (ref: src/bmSparse_SPGEMM.cu:1262)
    bt = coo_to_bmsparse(rows, cols, vals, (n, n), transposed=True,
                         device=device)

    t0 = time.perf_counter()
    pp = prepare_product(a, bt)        # symbolic + numeric plan, once
    sync(a)
    t_plan = time.perf_counter() - t0
    t_mul, a2 = time_op(pp, warmup=1, iters=5, device=device)

    p2 = prepare(a2)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    u = spmv(p2, spmv(p2, v.to(device)))

    s = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    ref = (s @ s) @ ((s @ s) @ v.numpy().astype(np.float64))
    err = float(np.abs(u.cpu().double().numpy() - ref).max()
                / np.abs(ref).max())
    return {"n": n, "nnz": a.nnz, "nnz_a2": a2.nnz, "plan_s": t_plan,
            "multiply_s": t_mul, "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bmsparse-matrix-powers-torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=65536)
    ap.add_argument("band", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(use --device cpu)")
    r = run(args.n, args.band, args.device)
    print(f"n={r['n']} nnz={r['nnz']}  A^2 nnz={r['nnz_a2']}")
    print(f"plan (once): {r['plan_s'] * 1e3:.1f} ms;  cached multiply: "
          f"{r['multiply_s'] * 1e3:.1f} ms")
    print(f"A^4 v rel err vs scipy: {r['err']:.2e}")
    return 0 if r["err"] < ERR_BOUND else 1


if __name__ == "__main__":
    sys.exit(main())
