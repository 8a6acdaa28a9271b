"""Multi-device SpGEMM: C = A @ B with A and C block-row-partitioned —
counterpart of ``bmsparse_tpu/parallel/spgemm.py``.

A rank owning A's block rows needs B's block row k wherever its A blocks
have block column k. For unknown structure that may be any row, so this
module all-gathers B (each rank's value offsets rebased by rank * nnz_max
first, so that the gathered value array stays addressable; the task
planner's positional segment min tolerates the padding blocks between the
ranks' slices) and runs the static-bound padded SpGEMM per rank
(ops/spgemm.py::spgemm_padded, plain torch). This is the structure-
oblivious path; parallel/product.py is the fast one (task-SELL numeric on
csrc/spgemm_sell.cu with a selective exchange of the needed B tiles).

C inherits A's partition: every rank computes its own C rows, keys stay
globally sorted, and reassembly is a concatenation.
"""

from __future__ import annotations

import numpy as np

from ..config import bucket_size
from ..format.bmsparse import BmSparse
from ..ops.spgemm import spgemm_padded
from .mesh import Mesh
from .partition import ShardedBmSparse


def sharded_spgemm(sa: ShardedBmSparse, sb: ShardedBmSparse, mesh: Mesh,
                   max_tasks: int, max_c_blocks: int | None = None,
                   max_c_nnz: int | None = None) -> ShardedBmSparse:
    """C = A @ B over the mesh; returns C sharded like A, every shard's
    slice on every rank.

    max_tasks / max_c_blocks / max_c_nnz are per-shard static upper bounds
    (estimate_bounds gives safe ones).
    """
    d = mesh.size
    if sa.num_shards != d or sb.num_shards != d:
        raise ValueError("operand shard count must match mesh size")
    if sa.num_cols != sb.num_rows:
        raise ValueError(f"inner dims mismatch: {sa.num_cols} vs "
                         f"{sb.num_rows}")
    s = mesh.rank
    # --- B exchange: every rank's slice, all-gathered -------------------
    nnzb_max = sb.nnz_max
    gb_val = mesh.all_gather(sb.values[s])
    b_full = BmSparse(
        brow=mesh.all_gather(sb.brow[s]), bcol=mesh.all_gather(sb.bcol[s]),
        bmp_hi=mesh.all_gather(sb.bmp_hi[s]),
        bmp_lo=mesh.all_gather(sb.bmp_lo[s]),
        offsets=mesh.all_gather(sb.offsets[s] + s * nnzb_max).clamp(
            0, gb_val.shape[0] - 1),
        values=gb_val, nb=mesh.all_reduce(sb.nb[s]),
        num_rows=sb.num_rows, num_cols=sb.num_cols, nnz=gb_val.shape[0],
        transposed=sb.transposed)
    a_local = BmSparse(
        brow=sa.brow[s], bcol=sa.bcol[s], bmp_hi=sa.bmp_hi[s],
        bmp_lo=sa.bmp_lo[s], offsets=sa.offsets[s], values=sa.values[s],
        nb=sa.nb[s], num_rows=sa.num_rows, num_cols=sa.num_cols,
        nnz=sa.nnz_max, transposed=False)
    c = spgemm_padded(a_local, b_full, max_tasks=max_tasks,
                      max_c_blocks=max_c_blocks, max_c_nnz=max_c_nnz)

    def gather(x):
        return mesh.all_gather(x[None])

    return ShardedBmSparse(
        brow=gather(c.brow), bcol=gather(c.bcol), bmp_hi=gather(c.bmp_hi),
        bmp_lo=gather(c.bmp_lo), offsets=gather(c.offsets),
        values=gather(c.values), nb=gather(c.nb.int()),
        num_rows=sa.num_rows, num_cols=sb.num_cols,
        # C's true nnz is data-dependent; -1 marks it unknown (to_bmsparse
        # recounts from the bitmaps)
        nnz=-1, transposed=False, rows_per_shard=sa.rows_per_shard)


def estimate_bounds(sa: ShardedBmSparse, sb: ShardedBmSparse) -> dict:
    """Host-side safe static bounds for sharded_spgemm: the exact
    per-shard task counts (the symbolic T1/T2 arithmetic in numpy), their
    maximum over shards, bucketed up."""
    b_brow = sb.brow.cpu().numpy()
    b_valid = ((sb.bmp_hi | sb.bmp_lo) != 0).cpu().numpy()
    nbr = sb.block_rows
    row_count = np.zeros((nbr + 1,), np.int64)
    np.add.at(row_count, np.clip(b_brow[b_valid], 0, nbr), 1)

    a_bcol = sa.bcol.cpu().numpy()
    a_valid = ((sa.bmp_hi | sa.bmp_lo) != 0).cpu().numpy()
    max_tasks = 1
    for s in range(sa.num_shards):
        cols = np.clip(a_bcol[s][a_valid[s]], 0, nbr - 1)
        max_tasks = max(max_tasks, int(row_count[cols].sum()))
    max_tasks = bucket_size(max_tasks)
    return dict(max_tasks=max_tasks, max_c_blocks=max_tasks,
                # hard upper bound: 64 slots per C block
                max_c_nnz=max_tasks * 64)
