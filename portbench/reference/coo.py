"""Plain reference of a general sparse matrix, in plain torch: its
coordinates and values, each product a gather and an index_add_ in the
values' own dtype (float64 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

import torch


class Coo:
    """A (n_rows, n_cols) matrix from rows, cols (int64) and vals."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, shape: tuple[int, int]):
        self.rows, self.cols, self.vals = rows, cols, vals
        self.shape = shape

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """u = A @ x in the values' dtype."""
        x = x.to(self.vals.dtype)
        u = torch.zeros(self.shape[0], dtype=self.vals.dtype,
                        device=self.vals.device)
        return u.index_add_(0, self.rows, self.vals * x[self.cols])

    def abs_apply(self, x: torch.Tensor) -> torch.Tensor:
        """|A| @ |x|: the scale of each row's rounding error."""
        return Coo(self.rows, self.cols, self.vals.abs(),
                   self.shape).apply(x.abs())
