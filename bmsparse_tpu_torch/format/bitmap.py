"""64-bit occupancy-bitmap algebra on pairs of 32-bit words.

Counterpart of ``bmsparse_tpu/format/bitmap.py``. The reference stores one
``uint64`` bitmap per 8x8 block where bit ``63 - a`` encodes intra-block
address ``a`` (``a = rel_i*8 + rel_j`` row-major, or ``rel_j*8 + rel_i``
when the matrix is loaded "transposed"; ref: src/bmSpMatrix.cu:85-101).
As in the JAX package every bitmap is carried as two 32-bit words::

    hi = bits 63..32 of the u64  -> intra-block addresses  0..31 (rows 0-3)
    lo = bits 31..0  of the u64  -> intra-block addresses 32..63 (rows 4-7)

Torch's ``uint32`` supports few operations, so the words live in ``int64``
tensors that hold the unsigned 32-bit pattern (0 <= word < 2**32). The
conversion to and from numpy ``uint32`` is exact (`words_to_tensor`,
`tensor_to_words_np`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BLOCK_SIZE

def _shifts(device) -> torch.Tensor:
    """Shift that brings address a to bit 0: addresses 0..31 live in hi at
    bit (31-a); addresses 32..63 live in lo at bit (63-a). Made on the
    device (a copy from the host would synchronise its stream)."""
    return torch.arange(31, -1, -1, dtype=torch.int64, device=device)


def words_to_tensor(w: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 words -> int64 tensor holding the same bit pattern."""
    return torch.from_numpy(np.asarray(w, np.uint32).astype(np.int64)).to(
        device)


def tensor_to_words_np(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of 32-bit patterns -> numpy uint32."""
    return t.cpu().numpy().astype(np.uint32)


def expand_bits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(…,) word pair -> (…, 64) int32 in {0,1}, indexed by address."""
    sh = _shifts(hi.device)
    hi_bits = (hi.long()[..., None] >> sh) & 1
    lo_bits = (lo.long()[..., None] >> sh) & 1
    return torch.cat([hi_bits, lo_bits], dim=-1).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, 64) {0,1} -> (hi, lo) int64 words. Inverse of `expand_bits`."""
    b = bits.long()
    sh = _shifts(bits.device)
    hi = (b[..., :32] << sh).sum(dim=-1)
    lo = (b[..., 32:] << sh).sum(dim=-1)
    return hi, lo


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.long()
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def popcount(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Number of set bits per block (per-block nnz), int32."""
    return (_popcount32(hi) + _popcount32(lo)).to(torch.int32)


def prefix_popcount(bits: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the address axis: storage slot of each bit.

    ``prefix[..., a]`` = number of set bits at addresses < a — the
    vectorized restatement of ``__popcll(bmp >> (64 - a))``.
    """
    return (torch.cumsum(bits, dim=-1) - bits).to(torch.int32)


def addr_grid(transposed: bool) -> np.ndarray:
    """(8, 8) int32: intra-block address of element (rel_i, rel_j).

    ``transposed`` selects the column-major layout the reference uses for
    the B operand of SpGEMM (ref: src/bmSpMatrix.cu:91-95).
    """
    ri, rj = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    return (rj * 8 + ri if transposed else ri * 8 + rj).astype(np.int32)


def addr_to_words(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-bit (hi, lo) int64 words of intra-block addresses `a`."""
    a = a.long()
    one = torch.ones((), dtype=torch.int64, device=a.device)
    zero = torch.zeros((), dtype=torch.int64, device=a.device)
    in_hi = a < 32
    hi = torch.where(in_hi, one << (31 - a).clamp(0, 31), zero)
    lo = torch.where(in_hi, zero, one << (63 - a).clamp(0, 31))
    return hi, lo


def coords_to_words(
    rel_i: torch.Tensor, rel_j: torch.Tensor, transposed: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-element single-bit bitmap words for (rel_i, rel_j) coordinates.

    Vectorized `coord_to_bmp` (ref: src/bmSpMatrix.cu:85-101): the (hi, lo)
    pair with exactly the one bit of each element set; OR-reducing these
    per block yields the block bitmap.
    """
    a = (rel_j * 8 + rel_i) if transposed else (rel_i * 8 + rel_j)
    return addr_to_words(a)


def bits_to_dense_bool(bits: torch.Tensor, transposed: bool) -> torch.Tensor:
    """(…, 64) bits -> (…, 8, 8) {0,1} dense occupancy, [row, col]: the
    intra-block layout undone, whatever it was."""
    g = bits.reshape(bits.shape[:-1] + (8, 8))
    return g.transpose(-1, -2) if transposed else g


def bitmap_product(
    a_hi: torch.Tensor, a_lo: torch.Tensor,
    b_hi: torch.Tensor, b_lo: torch.Tensor,
    b_transposed: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Structural product of block bitmaps: C(i,k) = OR_j A(i,j) AND B(j,k)
    (the reference's `bmp_calculator`, ref: src/bmSparse_SPGEMM.cu:787-810).
    A is row-major; B is column-major when ``b_transposed``. The C words
    are row-major, int64 holding 32-bit patterns.

    Fast path (b_transposed): A's row i and B's column k are whole bytes
    of the words, so C's row i is the byte sum_k ((row_i & col_k) != 0)
    << (7 - k). The words are non-negative int64, so a right shift never
    brings in a sign bit, and the mask keeps one byte.
    """
    if b_transposed:
        a_hi, a_lo, b_hi, b_lo = (x.long() for x in (a_hi, a_lo, b_hi, b_lo))
        rows = [(a_hi >> (8 * (3 - i))) & 0xFF for i in range(4)] + [
            (a_lo >> (8 * (7 - i))) & 0xFF for i in range(4, 8)]
        cols = torch.stack(
            [(b_hi >> (8 * (3 - k))) & 0xFF for k in range(4)]
            + [(b_lo >> (8 * (7 - k))) & 0xFF for k in range(4, 8)], dim=-1)
        weights = 1 << torch.arange(7, -1, -1, device=a_hi.device)
        c_bytes = [((r[..., None] & cols) != 0).long().mul(weights).sum(-1)
                   for r in rows]
        c_hi = (c_bytes[0] << 24) | (c_bytes[1] << 16) | (c_bytes[2] << 8) \
            | c_bytes[3]
        c_lo = (c_bytes[4] << 24) | (c_bytes[5] << 16) | (c_bytes[6] << 8) \
            | c_bytes[7]
        return c_hi, c_lo

    from .blockops import block_product_bits_flat

    c_bits = block_product_bits_flat(
        expand_bits(a_hi, a_lo), expand_bits(b_hi, b_lo), b_transposed)
    return pack_bits(c_bits)


def bitmap_or(
    a_hi: torch.Tensor, a_lo: torch.Tensor,
    b_hi: torch.Tensor, b_lo: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    return a_hi | b_hi, a_lo | b_lo


def words_to_u64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side: (hi, lo) uint32 -> uint64 (for interop/debug)."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def u64_to_words_np(bmp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (bmp >> np.uint64(32)).astype(np.uint32), (
        bmp & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


assert BLOCK_SIZE == 64, "bitmap algebra is specialized to 8x8 blocks"
