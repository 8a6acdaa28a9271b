"""COO <-> BmSparse conversion — counterpart of
``bmsparse_tpu/format/convert.py``: the reference's host-side converter
(`mmread_bmSparse`, ref: src/reader.cu:49-110) done with vectorized
numpy. The result's arrays are moved to `device` once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BLOCK_WIDTH
from . import bitmap as bm
from .bmsparse import BmSparse, cdiv


def _coo_to_bmsparse_host(rows, cols, vals, shape, transposed, device):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    nbc = cdiv(shape[1], BLOCK_WIDTH)
    dtype = vals.dtype if np.issubdtype(vals.dtype, np.floating) \
        else np.dtype(np.float32)
    if len(rows) == 0:
        # empty-input convention: one padding block with a zero bitmap,
        # nb == 0
        nbr = cdiv(shape[0], 8)
        return BmSparse(
            brow=torch.full((1,), nbr, dtype=torch.int32, device=device),
            bcol=torch.zeros(1, dtype=torch.int32, device=device),
            bmp_hi=torch.zeros(1, dtype=torch.int64, device=device),
            bmp_lo=torch.zeros(1, dtype=torch.int64, device=device),
            offsets=torch.zeros(1, dtype=torch.int32, device=device),
            values=torch.from_numpy(np.zeros(1, dtype)).to(device),
            nb=0, num_rows=shape[0], num_cols=shape[1], nnz=0,
            transposed=transposed,
        )
    intra = (
        (cols % 8) * 8 + (rows % 8) if transposed
        else (rows % 8) * 8 + (cols % 8)
    )
    bid = (rows >> 3) * nbc + (cols >> 3)
    # one combined int64 sort key (block id is < 2^58 for any plausible
    # shape); element order within a (bid, intra) tie is irrelevant (ties
    # are duplicates, summed below)
    key = bid * np.int64(64) + intra
    order = np.argsort(key)
    key, vals = key[order], vals[order]
    dup = key[1:] == key[:-1]
    if dup.any():
        # duplicate (row, col) entries would corrupt the format (bitmap
        # popcount < stored value count); sum them like scipy/cusp COO
        # assembly does
        key_new = np.concatenate([[True], ~dup])
        grp = np.cumsum(key_new) - 1
        vsum = np.zeros(grp[-1] + 1, vals.dtype)
        np.add.at(vsum, grp, vals)
        keep = np.nonzero(key_new)[0]
        key, vals = key[keep], vsum
    bid, intra = np.divmod(key, np.int64(64))
    # block boundaries straight off the sorted stream
    first = np.concatenate([[True], bid[1:] != bid[:-1]])
    start = np.nonzero(first)[0]
    ublk = bid[start]
    # bitmaps: segment-reduce of disjoint one-hot words (add == OR)
    words = np.uint64(1) << (np.uint64(63) - intra.astype(np.uint64))
    hi, lo = bm.u64_to_words_np(np.add.reduceat(words, start))
    return BmSparse(
        brow=torch.from_numpy((ublk // nbc).astype(np.int32)).to(device),
        bcol=torch.from_numpy((ublk % nbc).astype(np.int32)).to(device),
        bmp_hi=bm.words_to_tensor(hi, device),
        bmp_lo=bm.words_to_tensor(lo, device),
        offsets=torch.from_numpy(start.astype(np.int32)).to(device),
        values=torch.from_numpy(
            np.ascontiguousarray(vals.astype(dtype))).to(device),
        nb=len(start), num_rows=shape[0], num_cols=shape[1], nnz=len(vals),
        transposed=transposed,
    )


def coo_to_bmsparse(
    rows,
    cols,
    vals,
    shape: tuple[int, int],
    transposed: bool = False,
    backend: str = "host",
    device="cuda",
) -> BmSparse:
    """Convert COO triplets (numpy arrays, 0-based) to BmSparse.

    Duplicate coordinates are summed (scipy/cusp COO assembly semantics).
    Float values keep their dtype; other values become float32.

    device: where the container's tensors live; the card by default, and
    the CPU only when asked for (device="cpu").

    backend: "host" (vectorized numpy) is the only converter of the port
    so far; the JAX package's on-device converter is a ROADMAP item.
    """
    if backend != "host":
        raise NotImplementedError(
            f"backend={backend!r}: the device converter is not ported yet "
            "(ROADMAP queue 1, item 2)")
    return _coo_to_bmsparse_host(rows, cols, vals, shape, transposed,
                                 device)


def bmsparse_to_coo(m: BmSparse):
    """Host-side decompression (rows, cols, values) — see
    BmSparse.generate_coo."""
    return m.generate_coo()
