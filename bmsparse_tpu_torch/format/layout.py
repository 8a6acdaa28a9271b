"""Structure operations on the device that move a BmSparse's values
without changing them: the transpose, the switch between the two
intra-block layouts, and the map from packed values to dense tiles.

Each returns the value permutation it applied (`out.values ==
m.values[perm]`), so that a plan whose structure is fixed can build the
permutation once and apply it to new values with one gather. Nothing here
leaves the device or reads a value back to the host.

Layouts (format/bitmap.py): address a = rel_i*8 + rel_j in a row-major
block, rel_j*8 + rel_i in a transposed one. The transpose of a block
stored row-major is the same bitmap and the same values read as a
transposed block, so a transpose that also flips the layout only swaps
the block keys and re-sorts the blocks; one that keeps the layout adds a
layout switch.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bitmap as bm
from .bmsparse import BmSparse


def _swap_addr(device) -> torch.Tensor:
    """(64,): the other layout's address of the entry at each storage
    address (an involution: the block's rows and columns swap)."""
    a = torch.arange(64, device=device)
    return (a % 8) * 8 + a // 8


def _value_addrs(m: BmSparse) -> torch.Tensor:
    """(nnz,) int64: block * 64 + storage address of each of m's values,
    in value order (the inverse of decompress's value index)."""
    bits = bm.expand_bits(m.bmp_hi, m.bmp_lo)                # (nb_pad, 64)
    pos = m.offsets.long()[:, None] + bm.prefix_popcount(bits)
    pos = torch.where(bits > 0, pos, m.nnz).reshape(-1)
    out = torch.empty(m.nnz + 1, dtype=torch.int64, device=m.device)
    out.scatter_(0, pos, torch.arange(pos.numel(), device=m.device))
    return out[:m.nnz]


def _full_perm(perm: torch.Tensor, m: BmSparse) -> torch.Tensor:
    """perm over the nnz values, the padding values past them in place."""
    if m.nnz_pad == m.nnz:
        return perm
    return torch.cat([perm, torch.arange(m.nnz, m.nnz_pad,
                                         device=perm.device)])


def value_slots(m: BmSparse) -> torch.Tensor:
    """(nnz,) int64: where each of m's values lies in the (nb_pad, 64)
    row-major tiles of `m.decompress_blocks_flat()`, flattened (block * 64
    + rel_i * 8 + rel_j), whatever m's layout."""
    at = _value_addrs(m)
    if not m.transposed:
        return at
    return at - at % 64 + _swap_addr(m.device)[at % 64]


def tiles_from_values(values: torch.Tensor, slots: torch.Tensor,
                      nb_pad: int) -> torch.Tensor:
    """(nb_pad, 64) dense row-major tiles from packed values through
    `value_slots` of their structure: decompress_blocks_flat's result,
    in one scatter (every slot is written at most once)."""
    out = values.new_zeros(nb_pad * 64)
    out.scatter_(0, slots, values[:slots.numel()])
    return out.reshape(nb_pad, 64)


def relayout(m: BmSparse, transposed: bool) -> tuple[BmSparse, torch.Tensor]:
    """The same matrix with the intra-block layout `transposed`, and the
    value permutation (out.values == m.values[perm]). Blocks, their
    order and their offsets stay; each bitmap is transposed and each
    block's values re-packed in the new bit order."""
    dev = m.device
    if m.transposed == transposed:
        return m, torch.arange(m.nnz_pad, device=dev)
    swap = _swap_addr(dev)
    bits = bm.expand_bits(m.bmp_hi, m.bmp_lo)
    new_bits = bits.index_select(1, swap)
    hi, lo = bm.pack_bits(new_bits)
    at = _value_addrs(m)                        # old block*64 + address
    blk, new_a = at // 64, swap[at % 64]
    new_pos = (m.offsets.long()[blk]
               + bm.prefix_popcount(new_bits)[blk, new_a])
    perm = torch.empty(m.nnz, dtype=torch.int64, device=dev)
    perm.scatter_(0, new_pos, torch.arange(m.nnz, device=dev))
    perm = _full_perm(perm, m)
    return dataclasses.replace(m, bmp_hi=hi, bmp_lo=lo, values=m.values[perm],
                               transposed=transposed), perm


def transpose(m: BmSparse, transposed: bool | None = None
              ) -> tuple[BmSparse, torch.Tensor]:
    """m.T on m's device, and the value permutation (out.values ==
    m.values[perm]): block keys swapped and sorted again, each 8x8 bitmap
    transposed, values permuted. transposed: the result's intra-block
    layout (default m's). Padding blocks stay last, with the result's
    padding keys and their offsets."""
    dev = m.device
    flip = not m.transposed
    if transposed is None:
        transposed = m.transposed
    valid = (m.bmp_hi | m.bmp_lo) != 0
    n_rows, n_cols = m.num_cols, m.num_rows
    out = BmSparse(brow=m.bcol, bcol=m.brow, bmp_hi=m.bmp_hi, bmp_lo=m.bmp_lo,
                   offsets=m.offsets, values=m.values, nb=m.nb,
                   num_rows=n_rows, num_cols=n_cols, nnz=m.nnz,
                   transposed=flip)
    big = (out.block_rows + 1) * (out.block_cols + 1)
    key = torch.where(valid, m.bcol.long() * (out.block_cols + 1)
                      + m.brow.long(), big)
    order = torch.sort(key, stable=True).indices
    cnt = torch.where(valid, m.block_nnz().long(), 0)[order]
    new_off = torch.cumsum(cnt, 0) - cnt
    ok = valid[order]
    blk = torch.repeat_interleave(torch.arange(m.nb_pad, device=dev), cnt,
                                  output_size=m.nnz)
    perm = (m.offsets.long()[order][blk]
            + torch.arange(m.nnz, device=dev) - new_off[blk])
    perm = _full_perm(perm, m)
    out = dataclasses.replace(
        out,
        brow=torch.where(ok, m.bcol[order], out.block_rows).int(),
        bcol=torch.where(ok, m.brow[order], 0).int(),
        bmp_hi=m.bmp_hi[order], bmp_lo=m.bmp_lo[order],
        offsets=torch.where(ok, new_off, m.offsets.long()[order]).int(),
        values=m.values[perm])
    if flip == transposed:
        return out, perm
    out, perm2 = relayout(out, transposed)
    return out, perm[perm2]
