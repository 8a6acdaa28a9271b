"""Plain reference of a smoothed-aggregation AMG set-up on a 3-D grid, in
plain torch (no sparse library, no kernel of the program): every sparse
product is an expansion of the scalar products, a sort of their keys and
a segment sum, in the values' own dtype (float64 for the reference,
bfloat16 for a control).

Smoothed aggregation (Vanek, Mandel and Brezina, 1996; PyAMG's
`smoothed_aggregation_solver` defaults):
  * aggregates: 3x3x3 boxes of the grid (x // 3, y // 3, z // 3), the
    last box of an axis narrower where 3 does not divide it; the coarse
    grid is ceil(n / 3) per axis, points ordered x fastest;
  * tentative T: T[i, agg(i)] = 1 / sqrt(|agg(i)|) (PyAMG's
    fit_candidates for the constant candidate: unit columns);
  * rho(D^-1 A) by POWER_ITERATIONS steps of the power method from a
    vector drawn from a fixed seed on the CPU;
  * P = (I - omega D^-1 A) T with omega = 4/3 / rho;
  * R = P^T and A_c = R A P.

Every pattern is symbolic: an entry exists where some product of
structural entries lands, whatever its value (values can cancel).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# no reduced-precision matrix units anywhere in a float64 reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POWER_ITERATIONS = 20
POWER_SEED = 20260416
OMEGA_NUMERATOR = 4.0 / 3.0
# scalar products per step of a product: bounds its intermediates
CHUNK = 1 << 25


@dataclass
class Sparse:
    """An (n_rows, n_cols) matrix as coordinates and values; vals may
    carry trailing columns (several matrices on one pattern)."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    def keys(self) -> torch.Tensor:
        return self.rows * self.shape[1] + self.cols

    def sorted(self) -> "Sparse":
        order = torch.argsort(self.keys())
        return Sparse(self.rows[order], self.cols[order], self.vals[order],
                      self.shape)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """u = M @ x in the values' dtype (one-column values)."""
        u = torch.zeros(self.shape[0], dtype=self.vals.dtype,
                        device=self.vals.device)
        return u.index_add_(0, self.rows, self.vals * x[self.cols])

    def transpose(self) -> "Sparse":
        return Sparse(self.cols, self.rows, self.vals,
                      (self.shape[1], self.shape[0])).sorted()


def from_keys(keys: torch.Tensor, vals: torch.Tensor, shape) -> Sparse:
    return Sparse(keys // shape[1], keys % shape[1], vals, shape)


def spgemm(x: Sparse, y: Sparse) -> Sparse:
    """X @ Y over the symbolic pattern, rows sorted, in the values' dtype
    (vals multiply elementwise, trailing columns included)."""
    dev = x.vals.device
    n_mid = x.shape[1]
    y = y.sorted()
    y_len = torch.bincount(y.rows, minlength=n_mid)
    y_start = torch.cumsum(y_len, 0) - y_len
    x = x.sorted()
    per = y_len[x.cols]                          # products of each x entry
    ends = torch.cumsum(per, 0)
    x_len = torch.bincount(x.rows, minlength=x.shape[0])
    row_end = torch.cumsum(x_len, 0)             # x entries up to each row
    rows_out, cols_out, vals_out = [], [], []
    s, n_x = 0, x.rows.numel()
    while s < n_x:
        done = int(ends[s - 1]) if s else 0
        t = int(torch.searchsorted(ends, done + CHUNK, right=True))
        # whole rows of x only, and at least one
        r = int(x.rows[max(t, s + 1) - 1])
        t = int(row_end[r]) if t < n_x else n_x
        cnt = per[s:t]
        rep = torch.repeat_interleave(torch.arange(t - s, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        at = (y_start[x.cols[s:t]][rep]
              + torch.arange(rep.numel(), device=dev) - first[rep])
        keys = x.rows[s:t][rep] * y.shape[1] + y.cols[at]
        vals = x.vals[s:t][rep] * y.vals[at]
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        acc = torch.zeros((uniq.numel(),) + vals.shape[1:], dtype=vals.dtype,
                          device=dev).index_add_(0, inv, vals)
        rows_out.append(uniq // y.shape[1])
        cols_out.append(uniq % y.shape[1])
        vals_out.append(acc)
        s = t
    if not rows_out:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return Sparse(empty, empty, x.vals[:0], (x.shape[0], y.shape[1]))
    return Sparse(torch.cat(rows_out), torch.cat(cols_out),
                  torch.cat(vals_out), (x.shape[0], y.shape[1]))


def with_scale(m: Sparse) -> Sparse:
    """m with a second column |m|: products of such matrices carry the
    scale |X| |Y| of each entry beside its value."""
    return Sparse(m.rows, m.cols, torch.stack([m.vals, m.vals.abs()], 1),
                  m.shape)


def galerkin(a: Sparse, p: Sparse) -> Sparse:
    """A_c = P^T (A P) in the values' dtype, with the scale |R| |A| |P|
    of each entry as a second column, over the symbolic pattern of
    |R| |A| |P|, sorted by key."""
    ps = with_scale(p)
    return spgemm(ps.transpose(), spgemm(with_scale(a), ps))


def coarse_grid(grid: tuple) -> tuple:
    return tuple(-(-n // 3) for n in grid)


def tentative(grid: tuple, dtype=torch.float64, device="cpu") -> Sparse:
    """T of the 3x3x3 boxes of a (nz, ny, nx) grid, unit columns."""
    nz, ny, nx = grid
    cz, cy, cx = coarse_grid(grid)
    i = torch.arange(nz * ny * nx, device=device)
    z, y, x = i // (ny * nx), (i // nx) % ny, i % nx
    agg = ((z // 3) * cy + y // 3) * cx + x // 3
    size = torch.bincount(agg, minlength=cz * cy * cx).to(dtype)
    return Sparse(i, agg, size[agg].rsqrt(), (i.numel(), cz * cy * cx))


def diagonal(a: Sparse) -> torch.Tensor:
    d = torch.zeros(a.shape[0], dtype=a.vals.dtype, device=a.vals.device)
    on = a.rows == a.cols
    return d.index_add_(0, a.rows[on], a.vals[on])


def spectral_radius(a: Sparse) -> float:
    """rho(D^-1 A) by the power method, POWER_ITERATIONS steps from a
    fixed vector in [0.5, 1.5) (drawn on the CPU, so every device starts
    from the same one): the norm ratio of the last step."""
    g = torch.Generator().manual_seed(POWER_SEED)
    x = (torch.rand(a.shape[0], generator=g, dtype=torch.float64) + 0.5).to(
        device=a.vals.device, dtype=a.vals.dtype)
    d = diagonal(a)
    rho = 0.0
    for _ in range(POWER_ITERATIONS):
        y = a.apply(x) / d
        rho = float(y.norm() / x.norm())
        x = y / y.norm()
    return rho


def smoothed_p(a: Sparse, grid: tuple) -> tuple:
    """(P, omega) of one level: P = (I - omega D^-1 A) T over the pattern
    of A T (A holds its diagonal), in A's dtype."""
    omega = OMEGA_NUMERATOR / spectral_radius(a)
    d = diagonal(a)
    s = a.vals * (-omega) / d[a.rows]
    s = torch.where(a.rows == a.cols, s + 1.0, s)
    t = tentative(grid, a.vals.dtype, a.vals.device)
    return spgemm(Sparse(a.rows, a.cols, s, a.shape), t), omega


def hierarchy(a0: Sparse, grid: tuple, levels: int) -> dict:
    """The first set-up from A0 (float64 values): per level l < levels - 1
    P_l, omega_l, A_l P_l and A_{l+1} (the values of A_c), with the grids.
    Returns {"p": [...], "omega": [...], "ap": [...], "a": [A0, A1, ...],
    "grids": [...]}."""
    out = {"p": [], "omega": [], "ap": [], "a": [a0], "grids": [grid]}
    a = a0
    for _ in range(levels - 1):
        p, omega = smoothed_p(a, grid)
        ap = spgemm(a, p)
        ac = spgemm(p.transpose(), ap)
        out["p"].append(p)
        out["omega"].append(omega)
        out["ap"].append(ap)
        grid = coarse_grid(grid)
        a = ac
        out["a"].append(a)
        out["grids"].append(grid)
    return out


def products(x: Sparse, y: Sparse) -> int:
    """Scalar products of X @ Y: sum over k of nnz(X[:, k]) nnz(Y[k, :])."""
    cx = torch.bincount(x.cols, minlength=x.shape[1])
    ry = torch.bincount(y.rows, minlength=y.shape[0])
    return int((cx * ry).sum())
