"""Row gather of the numeric phases — counterpart of
``bmsparse_tpu/ops/gather.py``."""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[t] = table[idx[t]] with out-of-range indices clamped."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]
