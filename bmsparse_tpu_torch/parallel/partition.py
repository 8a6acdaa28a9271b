"""Block-row partitioning of the key space across ranks — counterpart of
``bmsparse_tpu/parallel/partition.py``.

Shard s owns every block with s * bpr <= brow < (s + 1) * bpr. Keys are
sorted row-major, so each shard owns a contiguous slice of every format
array. `ShardedBmSparse` stacks the per-shard arrays on a leading shard
axis, padded to uniform sizes with zero-bitmap identity padding, so that
every shard has the same shapes; rank r of a mesh works on slice [r].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BLOCK_HEIGHT, round_up
from ..format import bitmap as bm
from ..format.bmsparse import BmSparse, cdiv

_FIELDS = ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets", "values", "nb")


@dataclasses.dataclass(frozen=True)
class ShardedBmSparse:
    """BmSparse partitioned by block-row range into D uniform shards."""

    brow: torch.Tensor      # int32[D, nb_max]  (global block rows)
    bcol: torch.Tensor      # int32[D, nb_max]
    bmp_hi: torch.Tensor    # int64[D, nb_max], 32-bit patterns
    bmp_lo: torch.Tensor    # int64[D, nb_max], 32-bit patterns
    offsets: torch.Tensor   # int32[D, nb_max]  (shard-local value offsets)
    values: torch.Tensor    # dtype[D, nnz_max]
    nb: torch.Tensor        # int32[D] — valid blocks per shard
    num_rows: int = 0
    num_cols: int = 0
    # true global nnz; -1 = unknown (padded results such as the sharded
    # SpGEMM's; to_bmsparse() recounts from the bitmaps)
    nnz: int = 0
    transposed: bool = False
    rows_per_shard: int = 0     # block rows owned per shard

    @property
    def num_shards(self) -> int:
        return self.brow.shape[0]

    @property
    def nb_max(self) -> int:
        return self.brow.shape[1]

    @property
    def nnz_max(self) -> int:
        return self.values.shape[1]

    @property
    def block_rows(self) -> int:
        return cdiv(self.num_rows, BLOCK_HEIGHT)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "ShardedBmSparse":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _FIELDS})

    def shard_local(self, s: int) -> BmSparse:
        """Shard s as a standalone padded BmSparse (global rows and
        columns; nb a 0-d tensor)."""
        return BmSparse(
            brow=self.brow[s], bcol=self.bcol[s],
            bmp_hi=self.bmp_hi[s], bmp_lo=self.bmp_lo[s],
            offsets=self.offsets[s], values=self.values[s], nb=self.nb[s],
            num_rows=self.num_rows, num_cols=self.num_cols,
            nnz=self.nnz_max, transposed=self.transposed)

    def to_bmsparse(self) -> BmSparse:
        """The global matrix, reassembled on the host and returned on this
        container's device (the inverse of `partition`)."""
        h = self.to("cpu")
        nbs = [int(x) for x in h.nb]
        parts: dict = {f: [] for f in _FIELDS[:6]}
        base = 0
        for s, nb in enumerate(nbs):
            if nb == 0:
                continue
            for f in ("brow", "bcol", "bmp_hi", "bmp_lo"):
                parts[f].append(getattr(h, f)[s, :nb])
            parts["offsets"].append(h.offsets[s, :nb] + base)
            # the shard's value count: the last block's offset + popcount
            last = int(bm.popcount(h.bmp_hi[s, nb - 1:nb],
                                   h.bmp_lo[s, nb - 1:nb])[0])
            vcount = int(h.offsets[s, nb - 1]) + last
            parts["values"].append(h.values[s, :vcount])
            base += vcount
        if not parts["brow"]:
            z = torch.zeros(0, dtype=torch.int32)
            arrays = dict(brow=z, bcol=z, bmp_hi=z.long(), bmp_lo=z.long(),
                          offsets=z, values=h.values.new_zeros(0))
        else:
            arrays = {f: torch.cat(v) for f, v in parts.items()}
        out = BmSparse(
            **arrays, nb=int(arrays["brow"].shape[0]),
            num_rows=self.num_rows, num_cols=self.num_cols,
            nnz=int(arrays["values"].shape[0]), transposed=self.transposed)
        return out.to(self.device)


def partition(m: BmSparse, num_shards: int, align: int = 1
              ) -> ShardedBmSparse:
    """Split a BmSparse into `num_shards` uniform block-row ranges.

    Host-side preprocessing, once per matrix; the stacked arrays equal the
    JAX package's and land on m's device. align: round rows_per_shard up
    to this multiple (the tiered sharded plan needs align=16, so that each
    shard's scalar-row base is a multiple of 128; see parallel/plan.py).
    """
    nb = int(m.nb)
    brow = m.brow[:nb].cpu().numpy()
    bcol = m.bcol[:nb].cpu().numpy()
    hi = m.bmp_hi[:nb].cpu().numpy()
    lo = m.bmp_lo[:nb].cpu().numpy()
    offsets = m.offsets[:nb].cpu().numpy()
    values = m.values.cpu()
    counts = m.block_nnz()[:nb].cpu().numpy()

    bpr = round_up(cdiv(m.block_rows, num_shards), align)
    # contiguous slice bounds per shard (blocks sorted by brow)
    starts = np.searchsorted(brow, np.arange(num_shards) * bpr, side="left")
    ends = np.searchsorted(brow, (np.arange(num_shards) + 1) * bpr,
                           side="left")
    nb_per = ends - starts
    nnz_per = np.array(
        [int(counts[s:e].sum()) for s, e in zip(starts, ends)], np.int64)
    nb_max = max(int(nb_per.max(initial=0)), 1)
    nnz_max = max(int(nnz_per.max(initial=0)), 1)

    browS = np.full((num_shards, nb_max), m.block_rows, np.int32)
    bcolS = np.zeros((num_shards, nb_max), np.int32)
    hiS = np.zeros((num_shards, nb_max), np.int64)
    loS = np.zeros((num_shards, nb_max), np.int64)
    offS = np.zeros((num_shards, nb_max), np.int32)
    valS = values.new_zeros((num_shards, nnz_max))
    for s in range(num_shards):
        a, e = int(starts[s]), int(ends[s])
        k = e - a
        if k == 0:
            continue
        browS[s, :k] = brow[a:e]
        bcolS[s, :k] = bcol[a:e]
        hiS[s, :k] = hi[a:e]
        loS[s, :k] = lo[a:e]
        vbase = int(offsets[a])
        offS[s, :k] = offsets[a:e] - vbase
        offS[s, k:] = max(int(nnz_per[s]) - 1, 0)
        valS[s, :int(nnz_per[s])] = values[vbase:vbase + int(nnz_per[s])]

    def dev(x):
        return torch.from_numpy(x).to(m.device)

    return ShardedBmSparse(
        brow=dev(browS), bcol=dev(bcolS), bmp_hi=dev(hiS), bmp_lo=dev(loS),
        offsets=dev(offS), values=valS.to(m.device),
        nb=dev(nb_per.astype(np.int32)),
        num_rows=m.num_rows, num_cols=m.num_cols, nnz=m.nnz,
        transposed=m.transposed, rows_per_shard=bpr)
