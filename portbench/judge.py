"""The numbers that decide `correct`: gaps between an output and the plain
reference, each scaled by the size of the rounding it may carry, and the
decoding of the program's bmSparse output into coordinates.

Every gap is the widest one over the entries compared, so one wrong entry
shows. A gap of a sum is scaled by the sum of the magnitudes of its terms
(|A| |v| for a product), the standard bound of a sum's rounding error:
the gap of an exact result is 0 and that of a result rounded to p bits
at most about 2^-p times the number of terms.
"""

from __future__ import annotations

import torch

# Blocks decoded per step: bounds the (chunk, 64) intermediates to some
# hundreds of MB whatever the size of C.
DECODE_CHUNK = 1 << 20


def scaled_gap(got: torch.Tensor, ref: torch.Tensor,
               scale: torch.Tensor) -> float:
    """max |got - ref| / scale over the entries, in float64; an entry of
    zero scale must be exact."""
    d = (got.double() - ref.double()).abs()
    s = scale.double()
    gap = torch.where(s > 0, d / torch.where(s > 0, s, 1.0),
                      torch.where(d > 0, float("inf"), 0.0))
    return float(gap.max()) if gap.numel() else 0.0


def relative_gap(got: torch.Tensor, ref: torch.Tensor,
                 norm=None) -> float:
    """max |got - ref| / norm, norm max |ref| by default: the norm-wise
    gap of a vector."""
    if norm is None:
        norm = ref.double().abs().max()
    return float((got.double() - ref.double()).abs().max()
                 / torch.as_tensor(norm, dtype=torch.float64).clamp_min(
                     1e-300))


def entrywise_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / |ref| over entries of a vector with no zero."""
    return scaled_gap(got, ref, ref.double().abs())


def decode(c) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The program's bmSparse matrix c as keys (row * n_cols + col) and
    values, in c's block order, with the count of entries that lie outside
    the matrix. The format (the reference bmSparse's): per 8x8 block,
    bit (31 - a) of bmp_hi marks address a < 32 and bit (63 - a) of bmp_lo
    address a >= 32; address a = 8 * i + j for entry (i, j) of the block,
    8 * j + i when c is transposed; the value of the k-th set address lies
    at values[offsets + k]."""
    nb = int(c.nb)
    dev = c.values.device
    sh = torch.arange(31, -1, -1, device=dev)
    keys, vals, outside = [], [], 0
    for s in range(0, nb, DECODE_CHUNK):
        e = min(s + DECODE_CHUNK, nb)
        bits = torch.cat([(c.bmp_hi[s:e].long()[:, None] >> sh) & 1,
                          (c.bmp_lo[s:e].long()[:, None] >> sh) & 1], 1)
        slot = torch.cumsum(bits, 1) - bits
        blk, addr = bits.nonzero(as_tuple=True)
        hi, lo = addr // 8, addr % 8
        ri, rj = (lo, hi) if c.transposed else (hi, lo)
        rows = c.brow[s:e].long()[blk] * 8 + ri
        cols = c.bcol[s:e].long()[blk] * 8 + rj
        at = c.offsets[s:e].long()[blk] + slot[blk, addr]
        bad = ((rows < 0) | (rows >= c.num_rows) | (cols < 0)
               | (cols >= c.num_cols) | (at < 0) | (at >= c.values.numel()))
        outside += int(bad.sum())
        keys.append(rows * c.num_cols + cols)
        vals.append(c.values[at.clamp(0, c.values.numel() - 1)])
    if not keys:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, c.values[:0], 0
    return torch.cat(keys), torch.cat(vals), outside


def sparse_gap(keys: torch.Tensor, vals: torch.Tensor, outside: int,
               ref_keys: torch.Tensor, ref_vals: torch.Tensor,
               ref_scale: torch.Tensor) -> tuple[int, float]:
    """(structure mismatches, value gap) of a matrix given as keys and
    values against the reference's sorted keys, values and scale.
    Mismatches count entries outside the matrix, repeated keys, keys the
    reference lacks and reference keys missing; the value gap is taken
    over the keys both hold."""
    keys, order = torch.sort(keys)
    vals = vals[order]
    if keys.numel() == ref_keys.numel() and torch.equal(keys, ref_keys):
        return outside, scaled_gap(vals, ref_vals, ref_scale)
    uk = torch.unique_consecutive(keys)
    repeated = keys.numel() - uk.numel()
    at = torch.searchsorted(ref_keys, keys).clamp(max=ref_keys.numel() - 1)
    hit = ref_keys[at] == keys
    extra = int((~hit).sum())
    missing = int((~torch.isin(ref_keys, uk)).sum())
    gap = scaled_gap(vals[hit], ref_vals[at[hit]], ref_scale[at[hit]])
    return outside + repeated + extra + missing, gap
