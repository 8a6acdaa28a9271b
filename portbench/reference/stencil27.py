"""Plain reference of a 27-point operator on a 3-D grid, in plain torch.

The operator is held as its coefficients on the grid, as a stencil code
holds it: coef[k, z, y, x] is A[i, i + delta_k] for the grid point
i = (z * ny + y) * nx + x and the neighbour offset k of `OFFSETS`, and is
zero where the neighbour lies outside the grid. Every product is a sum of
shifted whole-grid arrays, in the coefficients' own dtype, so the same
code gives the float64 reference and the bfloat16 control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dz, dy, dx) of the 27 neighbours, x fastest, as HPCG's GenerateProblem
# walks them
OFFSETS = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1))


def _shift(grid: torch.Tensor, d: tuple, reach: int) -> torch.Tensor:
    """grid (..., nz, ny, nx) read at (z + dz, y + dy, x + dx), zero
    outside; |d| <= reach in every axis."""
    nz, ny, nx = grid.shape[-3:]
    pad = F.pad(grid, (reach,) * 6)
    dz, dy, dx = d
    return pad[..., reach + dz:reach + dz + nz, reach + dy:reach + dy + ny,
               reach + dx:reach + dx + nx]


class Stencil:
    """A 27-point operator from its grid coefficients (27, nz, ny, nx)."""

    def __init__(self, coef: torch.Tensor):
        self.coef = coef
        self.grid = tuple(coef.shape[1:])
        self.n = coef[0].numel()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """u = A @ x in the coefficients' dtype, x of length n."""
        xg = x.to(self.coef.dtype).reshape(self.grid)
        u = torch.zeros_like(xg)
        for k, d in enumerate(OFFSETS):
            u += self.coef[k] * _shift(xg, d, 1)
        return u.reshape(-1)

    def abs_apply(self, x: torch.Tensor) -> torch.Tensor:
        """|A| @ |x|: the scale of each row's rounding error."""
        return Stencil(self.coef.abs()).apply(x.abs())

    def square_grid(self) -> torch.Tensor:
        """A @ A as 125 grid arrays: out[e] at point i is C[i, i + e] for
        e in [-2, 2]^3 (z slowest), the sum over d1 + d2 = e of
        A[i, i + d1] * A[i + d1, i + d1 + d2]."""
        nz, ny, nx = self.grid
        out = torch.zeros((5, 5, 5, nz, ny, nx), dtype=self.coef.dtype,
                          device=self.coef.device)
        for k1, d1 in enumerate(OFFSETS):
            shifted = _shift(self.coef, d1, 1)       # A[i + d1, ·] at i
            for k2, d2 in enumerate(OFFSETS):
                ez, ey, ex = (a + b + 2 for a, b in zip(d1, d2))
                out[ez, ey, ex] += self.coef[k1] * shifted[k2]
        return out.reshape(125, self.n)

    def square_coo(self):
        """A @ A as sorted keys (row * n + col), values and the scale
        |A| @ |A| of each entry, over the structural pattern: every pair
        of grid points at most 2 apart in each axis."""
        nz, ny, nx = self.grid
        dev = self.coef.device
        c = self.square_grid()
        s = Stencil(self.coef.abs()).square_grid()
        z, y, x = torch.meshgrid(torch.arange(nz, device=dev),
                                 torch.arange(ny, device=dev),
                                 torch.arange(nx, device=dev), indexing="ij")
        idx = ((z * ny + y) * nx + x).reshape(-1)
        z, y, x = z.reshape(-1), y.reshape(-1), x.reshape(-1)
        keys, vals, scale = [], [], []
        e = 0
        for ez in range(-2, 3):
            for ey in range(-2, 3):
                for ex in range(-2, 3):
                    ok = ((z + ez >= 0) & (z + ez < nz) & (y + ey >= 0)
                          & (y + ey < ny) & (x + ex >= 0) & (x + ex < nx))
                    rows = idx[ok]
                    cols = rows + (ez * ny + ey) * nx + ex
                    keys.append(rows * self.n + cols)
                    vals.append(c[e][ok])
                    scale.append(s[e][ok])
                    e += 1
        del c, s
        keys = torch.cat(keys)
        keys, order = torch.sort(keys)
        return keys, torch.cat(vals)[order], torch.cat(scale)[order]
