"""Multi-device SpMV: u = A @ v with A block-row-partitioned over the ranks
of a mesh — counterpart of ``bmsparse_tpu/parallel/spmv.py``.

Each rank owns a contiguous block-row range of A and the matching slice of
u; v is split the same way. A rank needs v at every block column it
touches: for general sparsity that is the whole vector, one all-gather;
for a plan whose column windows reach only the neighbouring ranks' slices
(parallel/plan.py proves it), the two halo slices move instead. Each rank
returns the whole u (the ranks' slices all-gathered), as the JAX
package's sharded output reads.

Per rank: sharded_spmv runs the raw-container SpMV (ops/spmv.py::
_spmv_xla); sharded_spmv_prepared runs the tiered plan, with the DIA tier
on csrc/dia_spmv.cu at the rank's column shift and the SELL tier on
csrc/sell_gather.cu over the rank's pack at its column offset (the
sharded plans have no windowed group, as in the JAX package).
"""

from __future__ import annotations

import torch

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH, get_config, round_up
from ..format.bmsparse import BmSparse
from ..ops import spmv as _spmv
from .mesh import Mesh
from .partition import ShardedBmSparse

EXCHANGES = ("auto", "halo", "allgather")


def _check_mesh(sm, mesh: Mesh) -> None:
    if sm.num_shards != mesh.size:
        raise ValueError(f"matrix has {sm.num_shards} shards, mesh has "
                         f"{mesh.size}")


def _split_v(v: torch.Tensor, d: int, multiple: int) -> torch.Tensor:
    """v zero-padded to whole blocks, then to a multiple of `multiple * d`,
    and split into d equal slices: (d, chunk)."""
    v_pad = round_up(round_up(v.shape[0], BLOCK_WIDTH), multiple * d)
    vg = v.new_zeros(v_pad)
    vg[:v.shape[0]] = v
    return vg.reshape(d, v_pad // d)


def sharded_spmv(sm: ShardedBmSparse, v: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """u = A @ v over the mesh (v all-gathered); returns the whole u
    (length num_rows) on every rank. `sm` may also be a ShardedPrepared."""
    if sm.transposed:
        raise ValueError("SpMV expects an untransposed matrix")
    _check_mesh(sm, mesh)
    s, bpr = mesh.rank, sm.rows_per_shard
    v_len = round_up(sm.num_cols, BLOCK_WIDTH)
    vg = _split_v(v, mesh.size, 1)
    v_full = mesh.all_gather(vg[s])[:v_len]
    local = BmSparse(
        brow=sm.brow[s] - s * bpr,      # localized rows
        bcol=sm.bcol[s], bmp_hi=sm.bmp_hi[s], bmp_lo=sm.bmp_lo[s],
        offsets=sm.offsets[s], values=sm.values[s], nb=sm.nb[s],
        num_rows=bpr * BLOCK_HEIGHT, num_cols=sm.num_cols,
        nnz=sm.nnz_max, transposed=False)
    u_local = _spmv._spmv_xla(local, v_full)
    return mesh.all_gather(u_local)[:sm.num_rows]


def _resolve_exchange(sp, exchange: str) -> str:
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got "
                         f"{exchange!r}")
    if exchange == "auto":
        return "halo" if sp.halo is not None else "allgather"
    if exchange == "halo" and sp.halo is None:
        raise ValueError("plan has no feasible halo (multi-neighbour "
                         "window); use exchange='allgather'")
    return exchange


def shard_geometry(sp, s: int, n: int, exchange: str) -> tuple:
    """Where shard s's window of n entries sits in v: (dia_shift,
    col_off) for dia_apply and sell_apply, col_off the column of v at
    which the window starts (0 for the whole v)."""
    npad_loc = sp.sm.rows_per_shard * BLOCK_HEIGHT
    if exchange == "halo":
        hl, hr = sp.halo
        chunk = n - hl - hr
        return s * (npad_loc - chunk) + hl, s * chunk - hl
    # tall matrices: late shards' shifts pass the end of v (read zero)
    return s * npad_loc, 0


def local_spmv_prepared(sp, s: int, vpad: torch.Tensor, exchange: str,
                        kernels: bool) -> torch.Tensor:
    """Shard s's rows of u (npad_loc = rows_per_shard * 8 of them, in the
    compute dtype) from the v window its exchange delivered: the halo
    window [left halo ; own slice ; right halo], or the whole padded v.
    The DIA tier reads vpad at the shard's column shift, the SELL tier
    reads the shard's pack at the window's column offset."""
    npad_loc = sp.sm.rows_per_shard * BLOCK_HEIGHT
    dia_shift, col_off = shard_geometry(sp, s, vpad.shape[0], exchange)
    u = torch.zeros(npad_loc, dtype=vpad.dtype, device=vpad.device)
    if sp.dia_offsets:
        u += _spmv.dia_apply(sp.dia[s], sp.dia_offsets, vpad, kernel=kernels,
                             col_shift=dia_shift).reshape(-1)[:npad_loc]
    if sp.sell_ks:
        u += _spmv.sell_apply(
            sp.sell_chunks, sp.out_gather[s], vpad,
            gpack=sp.sell_gpack[s], kernel=kernels,
            col_off=col_off).reshape(npad_loc)
    return u


def _compute_dtype(sp) -> torch.dtype:
    vals = sp.dia if sp.dia is not None else sp.sm.values
    return torch.promote_types(vals.dtype, torch.float32)


def sharded_spmv_prepared(sp, v: torch.Tensor, mesh: Mesh,
                          impl: str | None = None,
                          exchange: str = "auto") -> torch.Tensor:
    """u = A @ v over the mesh with the tiered per-shard plans of
    parallel/plan.py::prepare_sharded (the multi-device fast path);
    returns the whole u on every rank.

    impl: "auto" | "cuda" | "plain" | None (config spmv_impl), as in
    ops.spmv.spmv. exchange: "halo" (the two neighbour slices the plan
    proved enough), "allgather" (the whole v) or "auto" (halo wherever
    the plan proved it).
    """
    sm = sp.sm
    _check_mesh(sm, mesh)
    exchange = _resolve_exchange(sp, exchange)
    impl = impl or get_config().spmv_impl
    if impl not in _spmv.IMPLS:
        raise ValueError(f"unknown SpMV impl {impl!r}")
    cdt = _compute_dtype(sp)
    kernels = _spmv._use_kernels(impl, v.device, cdt)
    # 128-aligned slices keep every halo and DIA shift a multiple of 128
    own = _split_v(v.to(cdt), mesh.size, 128)[mesh.rank]
    if exchange == "halo":
        hl, hr = sp.halo
        left, right = mesh.halo(own[own.shape[0] - hl:] if hl else None,
                                own[:hr] if hr else None)
        vpad = torch.cat([x for x in (left, own, right) if x is not None])
    else:
        vpad = mesh.all_gather(own)[:round_up(sm.num_cols, BLOCK_WIDTH)]
    u = local_spmv_prepared(sp, mesh.rank, vpad, exchange, kernels)
    return mesh.all_gather(u)[:sm.num_rows].to(v.dtype)


def shard_window(sp, v: torch.Tensor, s: int,
                 exchange: str = "auto") -> torch.Tensor:
    """The v window that rank s's exchange delivers, cut on one process
    from the whole v (the halo slices zero past the chain's ends). With
    local_spmv_prepared it runs one shard's body without ranks."""
    exchange = _resolve_exchange(sp, exchange)
    sm = sp.sm
    vg = _split_v(v.to(_compute_dtype(sp)), sm.num_shards, 128)
    if exchange == "allgather":
        return vg.reshape(-1)[:round_up(sm.num_cols, BLOCK_WIDTH)]
    hl, hr = sp.halo
    chunk = vg.shape[1]
    flat = vg.reshape(-1)
    lo = s * chunk - hl
    vpad = flat.new_zeros(chunk + hl + hr)
    a, b = max(lo, 0), min(lo + vpad.shape[0], flat.shape[0])
    vpad[a - lo:b - lo] = flat[a:b]
    return vpad
