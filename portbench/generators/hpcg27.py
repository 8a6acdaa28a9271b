"""HPCG's 27-point operator (HPCG 3.1 reference, GenerateProblem) on an
(nz, ny, nx) grid, made on the device.

Row i = (z * ny + y) * nx + x holds the diagonal `diagonal` and
`off_diagonal` at every neighbour inside the grid: nnz = the sum over the
three axes of (3 n - 2) per axis, (3 nx - 2)^3 on a cube.

Value sets: set 0 is HPCG's own values. Set 1 keeps the diagonal and
draws each off-diagonal from the seed, uniformly in `off_diagonal_range`:
a variable-coefficient operator on the same structure, as when an AMG
set-up is redone after the coefficients change.
"""

from __future__ import annotations

import torch

from portbench.reference.stencil27 import OFFSETS, Stencil
from portbench.seeds import generator


class Problem:
    """The operator's grid coefficients and their coordinates."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        nz, ny, nx = (int(cfg[k]) for k in ("nz", "ny", "nx"))
        self.grid = (nz, ny, nx)
        n = nz * ny * nx
        self.shape = (n, n)
        idx = torch.arange(n, device=self.device)
        z, y, x = idx // (ny * nx), (idx // nx) % ny, idx % nx
        self.mask = torch.stack([
            (z + dz >= 0) & (z + dz < nz) & (y + dy >= 0) & (y + dy < ny)
            & (x + dx >= 0) & (x + dx < nx) for dz, dy, dx in OFFSETS])
        self.delta = torch.tensor([(dz * ny + dy) * nx + dx
                                   for dz, dy, dx in OFFSETS],
                                  device=self.device)
        self.nnz = int(self.mask.sum())
        self._coef = {}

    def coef(self, value_set: int, seed: int) -> torch.Tensor:
        """(27, n) float32 coefficients of value set 0 or 1."""
        key = (value_set, seed if value_set else None)
        if key not in self._coef:
            self._coef = {k: v for k, v in self._coef.items() if k[0] == 0}
            center = OFFSETS.index((0, 0, 0))
            if value_set == 0:
                c = torch.full(self.mask.shape,
                               float(self.cfg["off_diagonal"]),
                               device=self.device)
            else:
                lo, hi = self.cfg["off_diagonal_range"]
                g = generator(seed, "hpcg27.values", self.device)
                c = torch.rand(self.mask.shape, generator=g,
                               device=self.device) * (hi - lo) + lo
            c[center] = float(self.cfg["diagonal"])
            self._coef[key] = torch.where(self.mask, c, 0.0)
        return self._coef[key]

    def coo(self, value_set: int, seed: int):
        """rows, cols (int64) and float32 values of a value set, on the
        device, duplicate-free."""
        rows = torch.arange(self.shape[0], device=self.device).expand(
            len(OFFSETS), -1)[self.mask]
        cols = rows + self.delta[:, None].expand_as(self.mask)[self.mask]
        return rows, cols, self.coef(value_set, seed)[self.mask]

    def reference(self, value_set: int, seed: int, dtype) -> Stencil:
        """The plain reference of a value set, computing in `dtype`, from
        the same float32 values the program gets."""
        c = self.coef(value_set, seed).to(dtype)
        return Stencil(c.reshape(len(OFFSETS), *self.grid))

    def square_nnz(self) -> int:
        """Nonzeros of A @ A: the pairs of grid points at most 2 apart in
        every axis."""
        nnz = 1
        for n in self.grid:
            nnz *= sum(max(n - abs(e), 0) for e in range(-2, 3))
        return nnz

    def row_col_counts(self):
        """nnz per row and per column (int64), for the least FLOPs."""
        rows, cols, _ = self.coo(0, 0)
        n = self.shape[0]
        return (torch.bincount(rows, minlength=n),
                torch.bincount(cols, minlength=n))


def generate(cfg: dict, device) -> Problem:
    return Problem(cfg, device)

