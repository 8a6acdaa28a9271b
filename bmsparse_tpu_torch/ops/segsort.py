"""Stable multi-key sorts — counterpart of ``bmsparse_tpu/ops/segsort.py``
(the bb_segsort replacement: a segmented sort is a lexicographic sort
with the segment id as leading key; ref: src/bmSparse_SPGEMM.cu:53,
963-1016).

`jax.lax.sort` is stable and lexicographic over its `num_keys` leading
operands; these functions give the same order. Two integer keys that fit
int32 are folded into one int64 key, so the pair costs one sort; other
key sets are sorted least significant first, one stable sort per key.
The carried operands are then gathered with the permutation.
"""

from __future__ import annotations

import torch

_I32 = (torch.int8, torch.int16, torch.int32, torch.uint8)


def sort_perm(*keys: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Permutation that sorts `keys` lexicographically (first key most
    significant), stably, along `dim`."""
    if len(keys) == 2 and all(k.dtype in _I32 for k in keys):
        # k0 * 2**32 + (k1 + 2**31) orders like (k0, k1) for int32 values
        key = keys[0].long() * (1 << 32) + (keys[1].long() + (1 << 31))
        return torch.sort(key, dim=dim, stable=True).indices
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k.gather(dim, perm)
        p = torch.sort(kk, dim=dim, stable=True).indices
        perm = p if perm is None else perm.gather(dim, p)
    return perm


def sort_by_key(*operands: torch.Tensor, num_keys: int = 1):
    """Plain multi-key sort of 1-D operands (thrust::sort analogue): the
    first `num_keys` are the keys, the rest are carried."""
    perm = sort_perm(*operands[:num_keys])
    return tuple(x[perm] for x in operands)


def segmented_sort(seg_ids: torch.Tensor, *keys_and_vals: torch.Tensor,
                   num_keys: int = 1):
    """Sort values within segments: a sort keyed on (seg_ids, the first
    `num_keys` of keys_and_vals). Returns (seg_ids_sorted,
    *keys_and_vals_sorted)."""
    return sort_by_key(seg_ids, *keys_and_vals, num_keys=1 + num_keys)
