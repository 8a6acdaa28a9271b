"""Plain reference solvers over any `apply(x) -> A @ x`, in the dtype of
their inputs: fixed-iteration CG and PageRank power iteration.

CG takes the steps of the textbook method in the order the program's
`examples/cg.py` documents (x0 = 0, the recurrence residual, a guard on
0/0), so the two follow one trajectory up to rounding.
"""

from __future__ import annotations

import torch

TINY = 1e-30


def cg(apply, b: torch.Tensor, iters: int):
    """x after `iters` CG steps from 0, and the squared residual norm of
    the recurrence after each step, (iters,)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rs = torch.dot(r, r)
    hist = []
    for _ in range(iters):
        ap = apply(p)
        alpha = rs / torch.clamp(torch.dot(p, ap), min=TINY)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=TINY)) * p
        rs = rs_new
        hist.append(rs_new)
    return x, torch.stack(hist)


def pagerank(apply, x0: torch.Tensor, iters: int, damping: float):
    """`iters` steps of x <- damping * P x + (1 - damping) / n from x0,
    P column-stochastic (LDBC Graphalytics' PageRank on a graph with no
    dangling vertex)."""
    n = x0.shape[0]
    x = x0
    for _ in range(iters):
        x = damping * apply(x) + (1.0 - damping) / n
    return x
