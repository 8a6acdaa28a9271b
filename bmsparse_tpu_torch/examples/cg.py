"""Conjugate-gradient solve with bmSparse SpMV — counterpart of the JAX
package's ``examples/cg.py``: the canonical iterative-solver workload of
the SpMV path (the plan's tiers stay on the card across iterations, so
each step costs one pass over the nonzero values).

    python -m bmsparse_tpu_torch.examples.cg [n] [iters] [--device cpu]

Builds an SPD 1-D Laplacian-like stencil system A x = b, runs
fixed-iteration CG with every scalar kept on the device (no host sync
inside the loop), and reports the residual and the time per iteration.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# guards the 0/0 once fully converged (fixed iteration count)
TINY = 1e-30


def build_spd_stencil(n: int):
    """Tridiagonal SPD system (2nd-order Laplacian + diagonal shift)."""
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([
        np.full(n, 2.5, np.float32),
        np.full(n - 1, -1.0, np.float32),
        np.full(n - 1, -1.0, np.float32),
    ])
    return rows.astype(np.int32), cols.astype(np.int32), vals


def cg(p, b: torch.Tensor, iters: int):
    """Fixed-iteration CG on a Prepared bmSparse matrix. Returns x and the
    squared residual norm after each iteration, (iters,), both on b's
    device; nothing inside the loop reads a value back to the host.
    Spans: the solve (`cg`) and each iteration's vector ops after its
    spmv (`cg.update`)."""
    from ..ops.spmv import spmv
    from ..utils.timing import span

    with span("cg"):
        x = torch.zeros_like(b)
        r = b.clone()
        pv = b.clone()
        rs = torch.dot(r, r)
        hist = []
        for _ in range(iters):
            ap = spmv(p, pv)
            with span("cg.update"):
                alpha = rs / torch.clamp(torch.dot(pv, ap), min=TINY)
                x = x + alpha * pv
                r = r - alpha * ap
                rs_new = torch.dot(r, r)
                pv = r + (rs_new / torch.clamp(rs, min=TINY)) * pv
                rs = rs_new
                hist.append(rs_new)
        return x, torch.stack(hist)


def setup(n: int, device="cuda"):
    """The stencil system's plan and a right-hand side b (seed 0)."""
    from .. import coo_to_bmsparse
    from ..ops.plan import prepare

    rows, cols, vals = build_spd_stencil(n)
    p = prepare(coo_to_bmsparse(rows, cols, vals, (n, n), device=device))
    b = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(np.float32))
    return p, b.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bmsparse-cg-torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=262144)
    ap.add_argument("iters", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(use --device cpu)")
    from ..utils.timing import sync

    p, b = setup(args.n, args.device)
    sync(cg(p, b, args.iters)[0])          # warm-up (builds the kernels)
    t0 = time.perf_counter()
    x, hist = cg(p, b, args.iters)
    sync(x)
    dt = time.perf_counter() - t0
    res = float(hist[-1]) ** 0.5
    res0 = float(torch.dot(b, b)) ** 0.5
    print(f"n={args.n} iters={args.iters}: |r| = {res:.3e} "
          f"(|b| = {res0:.3e}), wall {dt:.3f}s "
          f"({dt / args.iters * 1e6:.1f} us/iteration on {args.device})")
    return 0 if res < 1e-3 * res0 else 1


if __name__ == "__main__":
    sys.exit(main())
