"""Flat 8x8-block arithmetic in (n, 64) slot layout.

Counterpart of ``bmsparse_tpu/format/blockops.py``: slot = rel_i*8 + rel_j
(row-major). The layout is kept so that the container's decompressed
tiles compare slot for slot with the JAX package's.

An 8x8 block product in flat layout is eight multiply-adds over 64 slots:

    C[t, i*8+k] = sum_j repeat8(A[:, j::8]) * tile8(B[:, j*8:j*8+8])

repeat8 places A(:, i, j) at every slot i*8+k, tile8 places B(:, j, k) at
every slot i*8+k.
"""

from __future__ import annotations

import torch


def repeat8(x8: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> (n, 64) with x[:, i] at every slot i*8+k."""
    return x8.repeat_interleave(8, dim=-1)


def tile8(x8: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> (n, 64) with x[:, k] at every slot i*8+k."""
    return x8.repeat((1,) * (x8.dim() - 1) + (8,))


def block_matmul_flat(a_flat: torch.Tensor, b_flat: torch.Tensor,
                      b_transposed: bool,
                      acc_dtype=torch.float32) -> torch.Tensor:
    """Per-task 8x8 block products: (n, 64) row-major A slots times (n, 64)
    B slots in their storage layout (column-major when b_transposed) ->
    (n, 64) row-major C, summed over j in order in acc_dtype."""
    acc = torch.zeros(a_flat.shape, dtype=acc_dtype, device=a_flat.device)
    for j in range(8):
        a_j = a_flat[..., j::8]                      # A(:, i, j)
        b_j = (b_flat[..., j::8] if b_transposed     # stored k*8+j
               else b_flat[..., j * 8:j * 8 + 8])    # stored j*8+k
        acc += repeat8(a_j.to(acc_dtype)) * tile8(b_j.to(acc_dtype))
    return acc


def block_matvec_flat(
    a_flat: torch.Tensor, v8: torch.Tensor, acc_dtype=torch.float32
) -> torch.Tensor:
    """(n, 64) row-major blocks x (n, 8) vector segments -> (n, 8) row sums.

    u[t, i] = sum_j A[t, i*8+j] * v[t, j].
    """
    a = a_flat.to(acc_dtype).reshape(a_flat.shape[:-1] + (8, 8))
    return (a * v8.to(acc_dtype)[..., None, :]).sum(dim=-1)


def block_product_bits_flat(
    a_bits: torch.Tensor, b_bits: torch.Tensor, b_transposed: bool
) -> torch.Tensor:
    """Structural product of occupancy bits: C(i,k) = OR_j A(i,j) & B(j,k)
    (the reference's bmp_calculator, ref: src/bmSparse_SPGEMM.cu:787-810).
    Inputs/outputs are (n, 64) int32 in {0,1}; b_bits in storage layout."""
    a = a_bits.reshape(a_bits.shape[:-1] + (8, 8))        # [i, j]
    b = b_bits.reshape(b_bits.shape[:-1] + (8, 8))
    if b_transposed:
        b = b.transpose(-1, -2)                           # stored [k, j]
    c = (a[..., :, :, None] & b[..., None, :, :]).amax(dim=-2)   # [i, k]
    return c.reshape(a_bits.shape).to(torch.int32)


def storage_to_rowmajor(flat: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Reorder (n, 64) slots from storage layout to row-major."""
    if not transposed:
        return flat
    # the permutation taking transposed-storage slots (rel_j*8+rel_i) to
    # row-major slots (rel_i*8+rel_j), an involution; made on the device,
    # since a copy from the host would synchronise its stream
    slot = torch.arange(64, device=flat.device)
    return flat.index_select(-1, (slot % 8) * 8 + slot // 8)
