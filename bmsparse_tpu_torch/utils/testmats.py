"""Sparse-structure generators — counterpart of
``bmsparse_tpu/utils/testmats.py`` (copied as numpy, so both packages see
the same matrices from the same seed), plus the generators of ``bench.py``
(`make_stencil`, `make_banded`, `make_blockdense`).

  * fem2d       — P1 finite-element stiffness pattern on a structured
                  triangulated grid: 7-point 2-D stencil (offsets 0, ±1,
                  ±g, ±(g+1)); DIA-tier friendly, with far diagonals.
  * roadnet     — planar-ish road network: low bounded degree, strong
                  locality with occasional longer links (highways). Runs
                  the DIA tier, the windowed and gathered SELL groups and
                  the overflow mini-SELL.
  * make_stencil — dense band, every diagonal fully populated (the PDE
                  stencil family); DIA tier only.
  * make_banded  — random band of `band` entries per row (bench.py's
                  band256k / band2M SpGEMM cases).
  * make_blockdense — fully dense 8x8 blocks scattered uniformly
                  (bench.py's blockdense64k).
  * webgraph    — power-law link graph with scattered hub columns (bench.py's
                  web256k); the stream tier's structure.
  * make_random — uniform random pattern (bench.py's rand64k).

All return int32/int32/float32 COO, sorted row-major, no duplicates.
"""

from __future__ import annotations

import numpy as np


def _dedup(rows, cols, n):
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def fem2d(grid: int, seed: int = 0):
    """P1 stiffness pattern on a grid x grid triangulated mesh
    (n = grid**2 rows)."""
    n = grid * grid
    rng = np.random.default_rng(seed)
    node = np.arange(n, dtype=np.int64)
    x = node % grid
    nbr_offs = [0, 1, -1, grid, -grid, grid + 1, -(grid + 1)]
    rows_l, cols_l = [], []
    for o in nbr_offs:
        c = node + o
        ok = (c >= 0) & (c < n)
        # forbid wrap-around across grid rows for the ±1 / ±(g+1) stencils
        if o in (1, grid + 1):
            ok &= x < grid - 1
        if o in (-1, -(grid + 1)):
            ok &= x > 0
        rows_l.append(node[ok])
        cols_l.append(c[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rows, cols = _dedup(rows, cols, n)
    # stiffness-like values: negative off-diagonal, dominant diagonal
    vals = np.where(
        rows == cols, 6.0 + rng.random(rows.shape[0]),
        -(0.5 + rng.random(rows.shape[0])),
    ).astype(np.float32)
    return rows, cols, vals, (n, n)


def roadnet(n: int, seed: int = 0):
    """Planar-ish road network: each node links to 2-4 nearby nodes plus
    ~0.5% longer-range 'highway' links; symmetrized."""
    rng = np.random.default_rng(seed)
    node = np.arange(n, dtype=np.int64)
    deg = rng.integers(2, 5, n)
    src = np.repeat(node, deg)
    # local links: offsets geometric-ish within a +-64 window
    off = (rng.geometric(0.08, src.shape[0]) * rng.choice(
        [-1, 1], src.shape[0]))
    dst = np.clip(src + off, 0, n - 1)
    # highways
    nh = max(n // 200, 1)
    hs = rng.integers(0, n, nh)
    hd = np.clip(hs + rng.integers(-n // 8, n // 8, nh), 0, n - 1)
    rows = np.concatenate([src, dst, hs, hd])
    cols = np.concatenate([dst, src, hd, hs])
    keep = rows != cols
    rows, cols = _dedup(rows[keep], cols[keep], n)
    vals = rng.random(rows.shape[0]).astype(np.float32) + 0.1
    return rows, cols, vals.astype(np.float32), (n, n)


def webgraph(n: int, avg_deg: int = 8, seed: int = 0):
    """Power-law link graph: out-edges from every page, targets drawn
    Zipf-like so a few hub columns are extremely dense."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    src = rng.integers(0, n, m)
    # Zipf-ish targets via the inverse CDF of a truncated power law
    u = rng.random(m)
    dst = np.minimum((u ** 3.0) * n, n - 1).astype(np.int64)
    # permute hub ids so that the dense columns are scattered
    perm = rng.permutation(n)
    dst = perm[dst]
    keep = src != dst
    rows, cols = _dedup(src[keep], dst[keep], n)
    vals = rng.random(rows.shape[0]).astype(np.float32) + 0.01
    return rows, cols, vals.astype(np.float32), (n, n)


def make_random(n: int, density: float, seed: int = 0):
    """Uniform random pattern of n * n * density entries, as bench.py
    makes it. Returns (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    flat = rng.choice(n * n, size=nnz, replace=False)
    rows, cols = np.divmod(flat, n)
    vals = rng.standard_normal(nnz).astype(np.float32)
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order])


def make_stencil(n: int, half_width: int, seed: int = 0):
    """Dense band (every diagonal fully populated) — the classic
    PDE-stencil family, as bench.py makes it. Returns (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-half_width, half_width + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals


def make_banded(n: int, band: int, seed: int = 0):
    """Random band: `band` draws per row at offsets in [-band/2, band/2],
    duplicates merged — bench.py's generator. Returns (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals


def make_blockdense(n: int, num_blocks: int, seed: int = 0):
    """Fully dense 8x8 blocks scattered uniformly — the format's ideal
    case, as bench.py makes it. Returns (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    nb_side = n // 8
    flat = rng.choice(nb_side * nb_side, size=num_blocks, replace=False)
    br, bc = np.divmod(flat, nb_side)
    ri, rj = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    rows = (br[:, None] * 8 + ri.reshape(-1)[None, :]).reshape(-1)
    cols = (bc[:, None] * 8 + rj.reshape(-1)[None, :]).reshape(-1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order])
