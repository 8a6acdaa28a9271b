"""Smoothed-aggregation AMG set-up, then re-set-ups with the structure
reused, through the cached Galerkin product — the counterpart of
matrix_powers.py for A_c = P^T A P.

A time-stepping or Newton code rebuilds its preconditioner every step:
the operator's values change, its pattern does not. The first set-up
picks the aggregates (3x3x3 boxes of the grid) and the smoothed
prolongation P of each level (P = (I - omega D^-1 A) T, omega = 4/3 /
rho(D^-1 A), T the boxes' unit columns; PyAMG's smoothed_aggregation_solver
with its defaults) on the host; `prepare_galerkin` then plans each level
once, and every re-set-up recomputes only the coarse operators A_1, ...,
on the device with no host sync, each level's output the next level's
input as it stands.

    python -m bmsparse_tpu_torch.examples.amg_setup [n] [levels]
        [resetups] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# each coarse operator against scipy in float64: max|A_c - ref| / max|ref|
ERR_BOUND = 1e-5
POWER_ITERATIONS = 20


def stencil27(n: int, rng=None):
    """HPCG's 27-point operator on an n^3 grid (scipy CSR, float64):
    diagonal 26, off-diagonals -1, or drawn in [-1.5, -0.5] from rng."""
    import scipy.sparse as sp

    g = np.arange(n ** 3)
    z, y, x = g // (n * n), (g // n) % n, g % n
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((z + dz >= 0) & (z + dz < n) & (y + dy >= 0)
                      & (y + dy < n) & (x + dx >= 0) & (x + dx < n))
                rows.append(g[ok])
                cols.append(g[ok] + (dz * n + dy) * n + dx)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = (-1.0 if rng is None
            else rng.uniform(-1.5, -0.5, rows.shape[0]))
    vals = np.where(rows == cols, 26.0, vals)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n ** 3, n ** 3))


def smoothed_p(a, grid: tuple):
    """One level's P (scipy CSR, float64) and the coarse grid."""
    import scipy.sparse as sp

    nz, ny, nx = grid
    coarse = tuple(-(-k // 3) for k in grid)
    i = np.arange(nz * ny * nx)
    z, y, x = i // (ny * nx), (i // nx) % ny, i % nx
    agg = ((z // 3) * coarse[1] + y // 3) * coarse[2] + x // 3
    size = np.bincount(agg)
    t = sp.csr_matrix((1.0 / np.sqrt(size[agg]), (i, agg)),
                      shape=(i.size, size.size))
    d_inv = sp.diags(1.0 / a.diagonal())
    v = np.random.default_rng(0).random(a.shape[0]) + 0.5
    rho = 0.0
    for _ in range(POWER_ITERATIONS):
        w = d_inv @ (a @ v)
        rho = np.linalg.norm(w) / np.linalg.norm(v)
        v = w / np.linalg.norm(w)
    omega = 4.0 / 3.0 / rho
    return (t - omega * (d_inv @ (a @ t))).tocsr(), coarse


def run(n: int = 48, levels: int = 4, resetups: int = 3,
        device="cuda") -> dict:
    """The first set-up (aggregates and P of every level on the host,
    then `prepare_galerkin` per level), then `resetups` re-set-ups from
    new values of the fine operator, each timed (CUDA events on the
    card) and held against scipy's P^T A P level by level. Returns the
    sizes, the times in seconds and the largest error."""
    from .. import coo_to_bmsparse, prepare_galerkin
    from ..utils.timing import sync, time_op

    def to_bm(m):
        m = m.tocoo()
        return coo_to_bmsparse(m.row, m.col, m.data.astype(np.float32),
                               m.shape, device=device)

    a0 = stencil27(n)
    grid = (n, n, n)
    ps = []
    a = a0
    for _ in range(levels - 1):
        p, grid = smoothed_p(a, grid)
        ps.append(p)
        a = (p.T @ (a @ p)).tocsr()

    t0 = time.perf_counter()
    gals, a = [], to_bm(a0)
    for p in ps:
        gal = prepare_galerkin(a, to_bm(p))
        a = gal(a)                         # A_{l+1}: the next level's A
        gals.append(gal)
    sync(a)
    t_plan = time.perf_counter() - t0

    def resetup(a):
        out = []
        for gal in gals:
            a = gal(a)
            out.append(a)
        return out

    rng = np.random.default_rng(1)
    err, times = 0.0, []
    for _ in range(resetups):
        fine = stencil27(n, rng)
        t, coarse = time_op(resetup, to_bm(fine), warmup=1, iters=3,
                            device=device)
        times.append(t)
        ref = fine.astype(np.float32).astype(np.float64)
        for p, c in zip(ps, coarse):
            p32 = p.astype(np.float32).astype(np.float64)
            ref = (p32.T @ (ref @ p32)).tocsr()
            got = c.to_scipy().tocsr()
            err = max(err, abs(got - ref).max() / abs(ref).max())
            # the next level from the program's own output, as it ran
            ref = got
    return {"n": a0.shape[0], "nnz": a0.nnz,
            "levels": [gal.shape[0] for gal in gals],
            "nnz_c": [gal.num_c_nnz for gal in gals], "plan_s": t_plan,
            "resetup_s": float(np.median(times)), "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bmsparse-amg-setup-torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=48)
    ap.add_argument("levels", nargs="?", type=int, default=4)
    ap.add_argument("resetups", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(use --device cpu)")
    r = run(args.n, args.levels, args.resetups, args.device)
    print(f"n={r['n']} nnz={r['nnz']}  coarse n={r['levels']} "
          f"nnz={r['nnz_c']}")
    print(f"set-up plan (once): {r['plan_s'] * 1e3:.1f} ms;  re-set-up: "
          f"{r['resetup_s'] * 1e3:.2f} ms")
    print(f"coarse operators rel err vs scipy: {r['err']:.2e}")
    return 0 if r["err"] < ERR_BOUND else 1


if __name__ == "__main__":
    sys.exit(main())
