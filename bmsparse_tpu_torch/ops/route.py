"""Stream tier: SpMV for scattered structures (web graphs, uniform random
matrices) — counterpart of ``bmsparse_tpu/ops/route.py``.

The plan (host numpy, once per matrix) and the per-call operation are the
JAX package's, so that both packages build the same tables:

  1. PRODUCTS in column order. Scalar nonzeros are sorted by column, so the
     sources of every TILE_R-row tile of the source grid sit in one
     W_STREAM-scalar window of v (window starts aligned to W_STREAM). The
     slot order inside a window puts each element on its destination lane.
     Kernel: window_product (csrc/window_product.cu).
  2. A STATIC ROUTING NETWORK delivers every product to its destination
     cell (k, row) of a natural-row-order grid: two row-wise gathers
     (rowwise_gather, csrc/rowwise_gather.cu) bridged by transposes.
     Elements that find no slot (and the rows' ranks past the depth cap k)
     form a small residue, gathered and added with index_add_.
  3. u = dense sum over the K axis of the grid.

The network is the TPU's answer to missing gather hardware; a GPU gathers
directly, so the whole three-stage routing is a candidate for a Hopper
redesign (ROADMAP). The tables here stay the JAX package's for parity.

The cost model's constants (BW, TILE_STEP, STEP, QSEL, RES_NS here, G_NS
in ops/plan.py) are the H100's, measured by chip_smoke.py (PERF.md names
the run). They are read at call time, so a test can set them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

W_STREAM = 1024        # v window width in scalars (aligned starts)
S2 = 4                 # stage-2 slack slots per (sub-row, destination lane)
# Stage-3 slack: with nq padded to a multiple of 128 the destination
# a = krank * (nq/128) + (row//128)//128 decomposes uniquely into (krank,
# row digit), so stage 3 is collision-free and one slot suffices.
S3 = 1
TILE_R = 32            # rows of the source grid per v window (one tile)
EXTRA_ROWS = 4         # per-window-group row quota beyond ceil(m/128)
K_CAP = 64             # rows with more slots go to the block-SELL tier

# ---- cost model ------------------------------------------------------------
# The JAX package's formula (stream_cost_estimate) with the H100's constants,
# each measured by chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at a
# 700 W limit (PERF.md records the run). They are read at call time, so
# that a test can set them.
BW = 2.86e12           # bytes/s of a 1 GiB device-to-device copy
# The three per-step terms model TPU grid steps and quarter-select chains.
# Fitted on the card (device time beyond the bytes at BW, per tile, per
# 32-row step, per stage-3 unit of a 4x wider x) each came out below 0:
# the kernels' times here do not grow with them.
TILE_STEP = 0.0        # s per TILE_R-row tile of window_product
STEP = 0.0             # s per 32-row step of rowwise_gather
QSEL = 0.0             # s per stage-3 (8-row block, output row, 128-column)
#                        unit
RES_NS = 2.4e-11       # s per residue element: gather, multiply and
#                        index_add_ over 2**20 elements


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static routing plan for one matrix's scattered slots (CPU tensors
    as built; `to` moves them)."""

    vals_grid: torch.Tensor     # (R1, 128) coefficients, source order
    rel_grid: torch.Tensor      # (R1, 128) int32 window-relative columns
    ws: torch.Tensor            # (R1 // TILE_R,) int32 window starts
    pp: torch.Tensor            # (R1 // TILE_R,) int32 panel id per tile
    nxt: torch.Tensor           # (R1 // TILE_R,) int32 first tile of the
    #                             next panel (the TPU kernel's prefetch)
    idx2: torch.Tensor          # (R2, S2, 128) int32 stage-2 tables
    idx3: torch.Tensor          # (16384, G3, 128) int32 stage-3 tables
    res_rows: torch.Tensor      # (nres,) int32 residue rows (sorted)
    res_cols: torch.Tensor      # (nres,) int32
    res_vals: torch.Tensor      # (nres,)
    w: int = W_STREAM
    k: int = 0
    nq: int = 0
    nsub: int = 0
    w3: int = 0
    nahi: int = 0
    vtab_len: int = 0
    n_rows: int = 0

    TENSORS = ("vals_grid", "rel_grid", "ws", "pp", "nxt", "idx2", "idx3",
               "res_rows", "res_cols", "res_vals")
    STATICS = ("w", "k", "nq", "nsub", "w3", "nahi", "vtab_len", "n_rows")

    def to(self, device) -> "StreamPlan":
        """The same plan with every tensor on `device`."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.TENSORS})


def stream_cost_estimate(
    nnz: int, k: int, n_rows: int, s2: int = S2, s3: int = S3,
) -> float:
    """Estimated seconds of one stream-tier SpMV: the tables' and
    intermediates' bytes at BW, the kernels' per-tile and per-step costs
    beyond their bytes (TILE_STEP, STEP) and the stage-3 select term
    (QSEL). The JAX package's formula; its constants here are the H100's.
    ops/plan.prepare routes between the block SELL tiers and this tier
    with it."""
    nq = -(-(-(-n_rows // 128)) // 128) * 128  # padded (see the S3 note)
    r1 = 1.45 * max(nnz, 1) / 128 + TILE_R     # quota slack + padding
    nsub = max(r1 / 128, 1)
    nahi = max(-(-(-(-(k * nq) // 128)) // 128), 1)
    g3 = nahi * s3
    w3 = -(-nsub * s2 // 128) * 128
    grids = r1 * 128 * 8                       # vals + rel
    idx2 = r1 * 128 * s2 * 4
    idx3 = 16384 * g3 * 128 * 4
    transients = 6 * r1 * 128 * 4              # t1/a2/x3/a3 reads+writes
    t_bytes = (grids + idx2 + idx3 + transients) / BW
    t_steps = (r1 / TILE_R * TILE_STEP         # window_product tiles
               + r1 / 32 * STEP                # stage-2 gather steps
               + 16384 / 32 * STEP)            # stage-3 gather steps
    t_qsel = (16384 / 8) * g3 * (w3 / 128) * QSEL
    return t_bytes + t_steps + t_qsel


def _rank_in_run(key: np.ndarray) -> np.ndarray:
    """Rank of each element among the earlier elements with its key
    (stable: equal keys keep their input order)."""
    o = np.argsort(key, kind="stable")
    ranks = np.empty((len(key),), np.int64)
    ko = key[o]
    ranks[o] = np.arange(len(key)) - np.searchsorted(ko, ko)
    return ranks


def build_stream_plan(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    n_rows: int, n_cols: int, np_dtype=np.float32,
    s2: int = S2, s3: int = S3,
) -> StreamPlan:
    """Plan-time construction (host numpy, once per matrix).

    rows/cols are scalar coordinates; every row must have at most K_CAP
    entries (the caller routes heavier rows to the block-SELL tier).
    s2/s3 override the slack factors (the caller escalates s2 where a
    clustered structure leaves a large residue).

    The JAX package's per-window-group loop and per-panel loop are written
    here as whole-array numpy; the tables are the same.
    """
    nnz = len(rows)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    vals = vals.astype(np_dtype)

    # ---- destination cells: (k, row) of a (K, nq*128) grid ------------
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]
    krank = np.arange(nnz) - np.searchsorted(rows, rows)
    kmax = int(krank.max()) + 1 if nnz else 1
    if kmax > K_CAP:
        raise ValueError(
            f"a row has {kmax} entries, more than K_CAP={K_CAP}: heavier "
            "rows belong to the block-SELL tier")
    # Depth cap: the grid's K axis is billed on every row, so the cap k
    # is chosen by the cost model: table cost at depth k plus the residue
    # cost of the ranks past it.
    k = kmax
    if nnz:
        depth = np.bincount(rows)
        depth = depth[depth > 0]
        best, best_cost = kmax, None
        for kc in range(max(int(np.percentile(depth, 90)), 1), kmax + 1):
            ovf = int(np.maximum(depth - kc, 0).sum())
            cost = stream_cost_estimate(
                nnz - ovf, kc, n_rows, s2, s3) + ovf * RES_NS
            if best_cost is None or cost < best_cost:
                best, best_cost = kc, cost
        k = best
    deep = krank >= k
    deep_rows = rows[deep].astype(np.int32)
    deep_cols = cols[deep].astype(np.int32)
    deep_vals = vals[deep]
    if deep.any():
        rows, cols, vals = rows[~deep], cols[~deep], vals[~deep]
        krank = krank[~deep]
        nnz = len(rows)
    # nq padded to a multiple of 128: b = dr % 128 then depends on the
    # row alone and a = dr // 128 decomposes uniquely (the S3 note)
    nq = -(-(-(-n_rows // 128)) // 128) * 128
    dr = krank * np.int64(nq) + rows // 128      # dest row in (k*nq, 128)
    dl = (rows % 128).astype(np.int64)           # dest lane
    a = dr // 128
    b = dr % 128
    a_count = -(-(k * nq) // 128)      # distinct a values
    nahi = max(-(-a_count // 128), 1)
    ahi = (a // 128).astype(np.int64)
    amod = (a % 128).astype(np.int64)

    # ---- source packing: column windows, lane = dest lane -------------
    co = np.argsort(cols, kind="stable")
    sorted_cols = cols[co]
    # window groups: runs of equal col // W_STREAM (the JAX greedy cut
    # with W-aligned starts gives exactly these runs)
    wid = sorted_cols // W_STREAM
    starts = np.concatenate(
        [[0], np.nonzero(np.diff(wid))[0] + 1]).astype(np.int64) \
        if nnz else np.zeros((0,), np.int64)
    ngroups = len(starts)
    ws_of_group = wid[starts] * W_STREAM
    gsize = np.diff(np.concatenate([starts, [nnz]]))
    gid = np.repeat(np.arange(ngroups), gsize)

    lane_of = dl[co]
    # Row quota per group from its worst lane, capped so that one hot
    # lane cannot pad the whole group; rounded to whole TILE_R tiles (all
    # of a tile's rows share one window)
    if ngroups:
        maxlane = np.bincount(gid * 128 + lane_of,
                              minlength=ngroups * 128).reshape(
                                  ngroups, 128).max(axis=1)
    else:
        maxlane = np.zeros((0,), np.int64)
    quota = np.minimum(maxlane, 2 * (-(-gsize // 128)) + 4 * EXTRA_ROWS)
    quota = np.maximum(-(-quota // TILE_R) * TILE_R, TILE_R)
    row_base = np.concatenate([[0], np.cumsum(quota)])
    # j-th slot of each lane -> row j (within the group)
    ranks = _rank_in_run(gid * 128 + lane_of)
    ok = ranks < quota[gid]
    r1_of = np.where(ok, row_base[gid] + ranks, -1)
    res_mask = ~ok
    tile_ws = np.repeat(ws_of_group, quota // TILE_R)
    tile_pp = np.repeat(np.arange(ngroups), quota // TILE_R)
    r1_count = int(row_base[-1])
    # nsub rounded so nsub*s2 is a multiple of 128: stage-3's x3 width
    # then equals w3 exactly (a few all-zero pad rows)
    nsub_mult = 128 // np.gcd(s2, 128)
    nsub = -(-max(-(-r1_count // 128), 1) // nsub_mult) * nsub_mult
    r1_pad = nsub * 128
    # padding tiles form one final panel with an all-zero window at 0
    npanel = ngroups
    pad_tiles = r1_pad // TILE_R - len(tile_ws)
    tile_ws = np.concatenate([tile_ws, np.zeros((pad_tiles,), np.int64)])
    tpp = np.concatenate([tile_pp, np.full((pad_tiles,), npanel, np.int64)])
    # first tile of the next panel per tile (the tile's own index in the
    # last panel): the TPU kernel's one-fetch-per-panel prefetch, kept for
    # parity
    ntiles = len(tpp)
    first = np.concatenate([[True], np.diff(tpp) != 0])
    pidx = np.cumsum(first) - 1
    starts_of_panel = np.nonzero(first)[0]
    next_start = np.concatenate([starts_of_panel[1:], [ntiles - 1]])
    nxt = np.minimum(next_start[pidx], ntiles - 1)
    last = tpp == tpp[-1]
    nxt[last] = np.arange(ntiles)[last]

    # scatter coefficients / relative columns into the source grid
    vals_grid = np.zeros((r1_pad, 128), np_dtype)
    rel_grid = np.zeros((r1_pad, 128), np.int32)
    okm = r1_of >= 0
    src_r = r1_of[okm]
    src_l = lane_of[okm]
    gws = ws_of_group[gid]
    vals_grid[src_r, src_l] = vals[co][okm]
    rel_grid[src_r, src_l] = (sorted_cols[okm] - gws[okm]).astype(np.int32)

    # ---- stage 2: (l, sub) rows -> lane b, slack s2 --------------------
    # element position after T1: row (l, r1 // 128), lane r1 % 128
    e_l = src_l
    e_sub = src_r // 128
    e_srclane = src_r % 128
    orig = co[okm]                                # original element index
    e_b = b[orig]
    e_ahi = ahi[orig]
    e_amod = amod[orig]

    r2 = 128 * nsub
    key2 = (e_l * nsub + e_sub) * 128 + e_b
    rank2 = _rank_in_run(key2)
    fit2 = rank2 < s2
    idx2 = np.full((r2, s2, 128), 128, np.int32)
    idx2[(e_l * nsub + e_sub)[fit2], rank2[fit2], e_b[fit2]] = \
        e_srclane[fit2]

    # ---- stage 3: (l, b) slabs -> (ahi, amod), slack s3 ----------------
    # element position after the T2 swap: slab l*128 + b,
    # column sub * s2 + rank2
    g3 = nahi * s3
    w3 = -(-(nsub * s2) // 128) * 128
    slab = e_l * 128 + e_b
    c3 = e_sub * s2 + rank2
    key3 = (slab * nahi + e_ahi) * 128 + e_amod
    key3m = np.where(fit2, key3, np.int64(-1))
    rank3 = _rank_in_run(key3m)
    fit3 = fit2 & (rank3 < s3)
    if nnz and (fit2 & (rank3 > 0)).any():
        raise RuntimeError("stage-3 collision: the padded-nq decomposition "
                           "must make stage 3 collision-free")
    idx3 = np.full((16384, g3, 128), w3, np.int32)
    idx3[slab[fit3], (e_ahi * s3 + rank3)[fit3], e_amod[fit3]] = \
        c3[fit3].astype(np.int32)

    # ---- residue: depth-cap overflow + anything that missed a slot ----
    res_mask[np.nonzero(okm)[0][~fit3]] = True
    res_ids = co[res_mask]                        # original order ids
    rr = np.concatenate([rows[res_ids].astype(np.int32), deep_rows])
    rc = np.concatenate([cols[res_ids].astype(np.int32), deep_cols])
    rv = np.concatenate([vals[res_ids], deep_vals])
    rorder = np.argsort(rr, kind="stable")

    vtab_len = max(int(ws_of_group.max(initial=0)) + W_STREAM, W_STREAM)
    vtab_len = -(-vtab_len // 1024) * 1024

    return StreamPlan(
        vals_grid=torch.from_numpy(vals_grid),
        rel_grid=torch.from_numpy(rel_grid),
        ws=torch.from_numpy(tile_ws.astype(np.int32)),
        pp=torch.from_numpy(tpp.astype(np.int32)),
        nxt=torch.from_numpy(nxt.astype(np.int32)),
        idx2=torch.from_numpy(idx2),
        idx3=torch.from_numpy(idx3),
        res_rows=torch.from_numpy(rr[rorder]),
        res_cols=torch.from_numpy(rc[rorder]),
        res_vals=torch.from_numpy(np.ascontiguousarray(rv[rorder])),
        w=W_STREAM, k=int(k), nq=int(nq), nsub=int(nsub), w3=int(w3),
        nahi=int(nahi), vtab_len=int(vtab_len), n_rows=int(n_rows),
    )


def stream_apply(p: StreamPlan, vpad: torch.Tensor,
                 kernels: bool = False) -> torch.Tensor:
    """u_stream (n_rows,) float32 = the planned slots' contribution to
    A @ v. vpad: the zero-padded dense vector. kernels: the CUDA kernels
    (tensors on a CUDA device) or their plain torch versions."""
    from .cuda import shuffle_kernel as shk

    dev = vpad.device
    vtab = torch.zeros(p.vtab_len, dtype=torch.float32, device=dev)
    nfill = min(p.vtab_len, vpad.shape[0])
    vtab[:nfill] = vpad[:nfill]

    wprod = shk.window_product if kernels else shk.window_product_plain
    rgather = shk.rowwise_gather if kernels else shk.rowwise_gather_plain
    s2 = p.idx2.shape[1]
    s3 = p.idx3.shape[1] // p.nahi
    a1 = wprod(p.vals_grid, p.rel_grid, p.ws, vtab, p.w)     # (R1, 128)
    t1 = a1.T.reshape(128 * p.nsub, 128)                      # (l, sub) rows
    a2 = rgather(t1, p.idx2, s2)                              # (R2, s2, 128)
    a2v = a2.reshape(128, p.nsub, s2, 128)
    x3 = a2v.permute(0, 3, 1, 2).reshape(16384, p.nsub * s2)
    if x3.shape[1] < p.w3:
        x3 = torch.cat([x3, x3.new_zeros((16384, p.w3 - x3.shape[1]))],
                       dim=1)
    a3 = rgather(x3, p.idx3, p.nahi * s3)                     # (16384, G3, 128)
    f = a3.reshape(128, 128, p.nahi, s3, 128).sum(dim=3)
    grid = f.permute(2, 3, 1, 0).reshape(-1, 128)[: p.k * p.nq]
    u = grid.reshape(p.k, p.nq, 128).sum(dim=0).reshape(-1)

    if p.res_rows.shape[0]:
        contrib = p.res_vals.float() * vtab[p.res_cols.long()]
        u.index_add_(0, p.res_rows.long(), contrib)
    return u[: p.n_rows]
