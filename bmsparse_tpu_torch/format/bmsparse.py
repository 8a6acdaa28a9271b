"""The BmSparse container — PyTorch counterpart of
``bmsparse_tpu/format/bmsparse.py`` (the reference's `bmSpMatrix<T>`,
include/bmSpMatrix.h:20-40).

Arrays, one entry per 8x8 block unless noted:

  * ``brow, bcol : int32[nb_pad]`` — block coordinates, sorted
    lexicographically by (brow, bcol) (the reference's
    ``key = (block_row << 32) | block_col``, ref: src/bmSpMatrix.cu:76-83).
  * ``bmp_hi, bmp_lo : int64[nb_pad]`` — the 8x8 occupancy bitmap as two
    32-bit words (see format/bitmap.py for the bit convention and why the
    words are held in int64).
  * ``offsets : int32[nb_pad]`` — exclusive prefix sum of per-block nnz
    (ref: src/bmSpMatrix.cu:180-194).
  * ``values : dtype[nnz_pad]`` — nonzeros packed block by block in
    bitmap-bit order (ref: src/bmSpMatrix.cu:163-172).

Padding convention (shared with the JAX package): arrays may be padded
past ``nb`` valid blocks / ``nnz`` values. Padding blocks carry
``bmp == 0`` and clamped offsets; a zero bitmap decompresses to an
all-zero dense block, so padded blocks are identity elements in every
kernel — no masks needed on the compute paths. ``brow``/``bcol`` of
padding blocks are set past the last valid block coordinate so sorted
order is preserved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH
from . import bitmap as bm


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BmSparse:
    """Bitmap-sparse matrix in 8x8-block compressed form."""

    brow: torch.Tensor     # int32[nb_pad]
    bcol: torch.Tensor     # int32[nb_pad]
    bmp_hi: torch.Tensor   # int64[nb_pad], 32-bit patterns
    bmp_lo: torch.Tensor   # int64[nb_pad], 32-bit patterns
    offsets: torch.Tensor  # int32[nb_pad]
    values: torch.Tensor   # dtype[nnz_pad]
    # number of valid (non-padding) blocks: an int, or a 0-d device tensor
    # where the device converter ran with compact=False (no host sync)
    nb: int | torch.Tensor
    num_rows: int = 0
    num_cols: int = 0
    nnz: int = 0
    # True when the intra-block layout is column-major (the B operand of
    # SpGEMM; ref: src/bmSpMatrix.cu:91-95).
    transposed: bool = False

    # ------------------------------------------------------------------
    @property
    def nb_pad(self) -> int:
        return self.brow.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def block_rows(self) -> int:
        """Number of block rows covering the matrix."""
        return cdiv(self.num_rows, BLOCK_HEIGHT)

    @property
    def block_cols(self) -> int:
        return cdiv(self.num_cols, BLOCK_WIDTH)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    def to(self, device) -> "BmSparse":
        """The same matrix with every array on `device` (self if they
        are there already)."""
        if torch.device(device) == self.device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device)
            for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets",
                      "values")
        })

    # ------------------------------------------------------------------
    def block_nnz(self) -> torch.Tensor:
        """Per-block nonzero count (popcount of the bitmap)."""
        return bm.popcount(self.bmp_hi, self.bmp_lo)

    def decompress_blocks_flat(self, dtype=None) -> torch.Tensor:
        """Expand packed values into dense tiles: (nb_pad, 64), row-major
        slots (slot = rel_i*8 + rel_j) regardless of storage layout.
        Zero-bitmap (padding) blocks yield zero tiles."""
        from .blockops import storage_to_rowmajor

        bits = bm.expand_bits(self.bmp_hi, self.bmp_lo)        # (nb, 64)
        slot = bm.prefix_popcount(bits)
        idx = (self.offsets.long()[:, None] + slot).clamp(
            0, max(self.nnz_pad - 1, 0))
        vals = self.values[idx]
        dense = torch.where(bits > 0, vals, torch.zeros((), dtype=vals.dtype,
                                                        device=vals.device))
        dense = storage_to_rowmajor(dense, self.transposed)
        return dense if dtype is None else dense.to(dtype)

    def decompress_blocks(self, dtype=None) -> torch.Tensor:
        """(nb_pad, 8, 8) dense tiles ([rel_i, rel_j]); prefer
        `decompress_blocks_flat` on hot paths."""
        return self.decompress_blocks_flat(dtype).reshape(self.nb_pad, 8, 8)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.nb_pad, dtype=torch.int32,
                            device=self.device) < self.nb

    # ------------------------------------------------------------------
    def pad_to(self, nb_pad: int, nnz_pad: int | None = None) -> "BmSparse":
        """Grow (never shrink) padding. Padding blocks get bmp=0 and block
        coordinates past the matrix so sorted order is kept."""
        if nb_pad < self.nb_pad:
            raise ValueError(f"cannot shrink nb_pad {self.nb_pad} -> {nb_pad}")
        extra = nb_pad - self.nb_pad
        dev = self.device

        def grow(x, fill):
            return torch.cat([x, torch.full((extra,), fill, dtype=x.dtype,
                                            device=dev)])

        values = self.values
        if nnz_pad is not None and nnz_pad > self.nnz_pad:
            values = torch.cat([values, torch.zeros(
                nnz_pad - self.nnz_pad, dtype=values.dtype, device=dev)])
        return dataclasses.replace(
            self,
            brow=grow(self.brow, self.block_rows),
            bcol=grow(self.bcol, 0),
            bmp_hi=grow(self.bmp_hi, 0),
            bmp_lo=grow(self.bmp_lo, 0),
            offsets=grow(self.offsets, max(self.nnz_pad - 1, 0)),
            values=values,
        )

    def astype(self, dtype) -> "BmSparse":
        return dataclasses.replace(self, values=self.values.to(dtype))

    # ------------------------------------------------------------------
    def generate_coo(
        self, order: str = "rowcol"
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decompress to host COO (rows, cols, values) — the verification
        path of the reference (`generate_coo`, ref: src/bmSpMatrix.cu:320-363).

        Returns arrays of length == true nnz; values as float64.
        order: "rowcol" sorts by (row, col) — the reference's contract
        (ref: src/bmSpMatrix.cu:355-356); "any" leaves block-then-bit order
        for consumers that do not care (plan building, scipy interop).
        """
        brow = self.brow.cpu().numpy()
        bcol = self.bcol.cpu().numpy()
        hi = bm.tensor_to_words_np(self.bmp_hi)
        lo = bm.tensor_to_words_np(self.bmp_lo)
        offsets = self.offsets.cpu().numpy()
        values = self.values.cpu()
        if values.dtype == torch.bfloat16:
            values = values.float()
        values = values.numpy()
        bmp = bm.words_to_u64_np(hi, lo)
        addr = np.arange(64, dtype=np.uint64)
        # narrow dtypes: the (nb, 64) intermediates are the dominant host
        # cost at 35M+ nnz
        bits = (
            (bmp[:, None] >> (np.uint64(63) - addr)) & np.uint64(1)
        ).astype(np.uint8)
        slot = (np.cumsum(bits, axis=1, dtype=np.int16) - bits).astype(
            np.int32)
        if self.transposed:
            rel_j, rel_i = np.divmod(np.arange(64, dtype=np.int32), 8)
        else:
            rel_i, rel_j = np.divmod(np.arange(64, dtype=np.int32), 8)
        kk, aa = np.nonzero(bits)
        rows = brow[kk].astype(np.int64) * BLOCK_HEIGHT + rel_i[aa]
        cols = bcol[kk].astype(np.int64) * BLOCK_WIDTH + rel_j[aa]
        vals = values[offsets[kk] + slot[kk, aa]]
        if order == "rowcol":
            o = np.lexsort((cols, rows))
            rows, cols, vals = rows[o], cols[o], vals[o]
        return rows, cols, vals.astype(np.float64)

    def to_scipy(self):
        """Oracle interop: a scipy.sparse.coo_matrix."""
        import scipy.sparse as sp

        r, c, v = self.generate_coo(order="any")
        return sp.coo_matrix((v, (r, c)), shape=self.shape)

    # ------------------------------------------------------------------
    def compare(self, oracle, verbose: bool = False) -> float:
        """Mean relative error against an oracle matrix — the reference's
        `compare` (ref: src/bmSpMatrix.cu:381-432). See oracle/compare.py."""
        from ..oracle.compare import mean_relative_error

        return mean_relative_error(self, oracle, verbose=verbose)

    def __repr__(self) -> str:
        return (
            f"BmSparse(shape={self.shape}, nnz={self.nnz}, blocks={self.nb}"
            f"/{self.nb_pad}, dtype={self.dtype}, device={self.device}, "
            f"transposed={self.transposed})"
        )

    def print_matrix(self, stream=None, max_entries: int = 200) -> None:
        """Human-readable COO dump — the cusp::print analogue (the
        reference pulls in cusp/print.h)."""
        import sys

        out = stream or sys.stdout
        r, c, v = self.generate_coo()
        out.write(
            f"sparse matrix <{self.num_rows}, {self.num_cols}> "
            f"with {len(r)} entries\n"
        )
        for i in range(min(len(r), max_entries)):
            out.write(f"  {int(r[i])} {int(c[i])} {v[i]}\n")
        if len(r) > max_entries:
            out.write(f"  ... ({len(r) - max_entries} more)\n")
