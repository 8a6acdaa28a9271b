"""The SpGEMM's default compress: the CUDA kernel (csrc/bitmap_compress.cu)
and its plain torch version, which the plain route (CPU tensors, float64,
impl="plain") runs. It replaces no TPU kernel: the JAX package computes
the same values as XLA (``bmsparse_tpu/ops/spgemm.py``,
``_compress_rows``), which the tests hold both against.

The dense C tiles c_rows (R, 64), lanes indexed by intra-block address,
go to C's bit-order value array (nnz_pad,):

    out[off[r] + rank_r(a)] = c_rows[r, a]  for each address a set in row r

rank_r(a) being the number of set addresses of row r below a
(format/bitmap.py::prefix_popcount, `__popcll` in the kernel); hi, lo and
off are int64 (R,), the words holding 32-bit patterns (format/bitmap.py).
Positions outside [0, num_c_nnz) drop, and the tail [num_c_nnz, nnz_pad)
reads 0. The caller guarantees that the rows cover [0, num_c_nnz) (a
product plan's C blocks, each position once), so the kernel zero-fills
only the tail. Each position has one writer: no sum, and the same bits on
every run.
"""

from __future__ import annotations

import torch

from ...format import bitmap as bm
from . import build


def _check(c_rows, hi, lo, off, nnz_pad, num_c_nnz) -> None:
    """The kernel's preconditions."""
    if (c_rows.dim() != 2 or c_rows.shape[1] != 64
            or c_rows.dtype != torch.float32):
        raise TypeError(f"c_rows must be a (R, 64) float32 matrix, got "
                        f"{c_rows.dtype} {tuple(c_rows.shape)}")
    for name, t in (("hi", hi), ("lo", lo), ("off", off)):
        if tuple(t.shape) != (c_rows.shape[0],) or t.dtype != torch.int64:
            raise ValueError(f"{name} must be int64 ({c_rows.shape[0]},), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != c_rows.device:
            raise ValueError(f"c_rows on {c_rows.device} but {name} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("bitmap_compress operands must be contiguous")
    if not c_rows.is_contiguous():
        raise ValueError("bitmap_compress operands must be contiguous")
    if not 0 <= num_c_nnz <= nnz_pad:
        raise ValueError(f"need 0 <= num_c_nnz <= nnz_pad, got "
                         f"{num_c_nnz}, {nnz_pad}")


def bitmap_compress_plain(c_rows: torch.Tensor, hi: torch.Tensor,
                          lo: torch.Tensor, off: torch.Tensor, nnz_pad: int,
                          num_c_nnz: int) -> torch.Tensor:
    """Plain torch version of `bitmap_compress`, in c_rows' dtype on any
    device: each set lane's rank by prefix_popcount, then one scatter_ of
    the kept lanes into zeros."""
    bits = bm.expand_bits(hi, lo)
    pos = off.long()[:, None] + bm.prefix_popcount(bits)
    keep = (bits > 0) & (pos >= 0) & (pos < num_c_nnz)
    return c_rows.new_zeros(nnz_pad).scatter_(0, pos[keep], c_rows[keep])


def bitmap_compress(c_rows: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                    off: torch.Tensor, nnz_pad: int,
                    num_c_nnz: int) -> torch.Tensor:
    """The bitmap-rank compress of float32 tiles: launches
    csrc/bitmap_compress.cu for CUDA tensors; tensors on the CPU take
    `bitmap_compress_plain`."""
    _check(c_rows, hi, lo, off, nnz_pad, num_c_nnz)
    if c_rows.device.type == "cpu":
        return bitmap_compress_plain(c_rows, hi, lo, off, nnz_pad, num_c_nnz)
    if c_rows.device.type != "cuda":
        raise ValueError(f"bitmap_compress: unsupported device "
                         f"{c_rows.device}")
    out = torch.empty(nnz_pad, dtype=torch.float32, device=c_rows.device)
    if c_rows.data_ptr() % 8:
        raise ValueError("bitmap_compress: c_rows must be 8-byte aligned")
    lib = build.load()
    with torch.cuda.device(c_rows.device):
        err = lib.bmsp_bitmap_compress(
            c_rows.data_ptr(), hi.data_ptr(), lo.data_ptr(), off.data_ptr(),
            c_rows.shape[0], num_c_nnz, nnz_pad, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "bitmap_compress launch")
    bitmap_compress.launches += 1
    return out


bitmap_compress.launches = 0
