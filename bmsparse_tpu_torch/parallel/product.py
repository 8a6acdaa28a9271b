"""Sharded cached SpGEMM products — the multi-device fast path; counterpart
of ``bmsparse_tpu/parallel/product.py``.

`sharded_spgemm` (parallel/spgemm.py) all-gathers the whole of B to every
rank and runs the static-bound numeric. This module plans instead:

  * The dependency set is exact: shard s needs B block gb iff one of its
    tasks multiplies by gb (the reference task creator's pos[col]).
  * The exchange is selective: at plan time each shard's needed set is
    grouped by owner; each multiply sends exactly those dense tiles with
    one all_to_all_single (every pair padded to the largest off-diagonal
    pair, so the splits are equal). Where padding makes that move more
    than an all-gather of the owned slabs (hub rows needing most of B),
    the plan falls back to the all-gather.
  * The numeric is the task-SELL path: per-shard slot layouts, compress
    columns and C's container fields are planned on the host once per
    structure (ops/spgemm.py::_plan_product per shard) and stacked with
    unified statics (the union of K-groups, each at the largest chunk
    count). Each rank then launches csrc/spgemm_sell.cu (numeric_sell)
    once over all its K-groups, on b_needed = [exchanged tiles ; own slab
    ; zero sentinel], and compresses by bitmap rank (plain torch).

Values may change between calls while the structure stays (replace
a_flat / b_flat with new tiles), as for ops.product.PreparedProduct.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from ..config import bucket_size, get_config
from ..ops import spgemm as sg
from ..ops.cuda import bitmap_compress_kernel as _bk
from ..ops.cuda import spgemm_kernel as _sk
from ..utils.timing import PhaseTimer
from .mesh import Mesh
from .partition import ShardedBmSparse

IMPLS = ("auto", "cuda", "plain")


@dataclasses.dataclass(frozen=True)
class ShardedProduct:
    """Structure-frozen sharded C = A @ B with a device-only numeric."""

    # stacked per-shard operand tiles (float32)
    a_flat: torch.Tensor        # (d, nb_a_max, 64)
    b_flat: torch.Tensor        # (d, nb_b_max, 64): each shard's OWN blocks
    # selective exchange plan
    send_idx: torch.Tensor      # (d, d, max_send) int32 [src, dst]
    # task-SELL slot tables, one pair per unified K-group: (d, cap, K, 128)
    # int32 views into slots_a / slots_b, into a_flat and b_needed
    tas: tuple = ()
    tbs: tuple = ()
    # compress columns, row-aligned with the stacked group rows (d, R)
    sig_hi: torch.Tensor | None = None      # int64, 32-bit patterns
    sig_lo: torch.Tensor | None = None
    sig_off: torch.Tensor | None = None     # int32
    # C container (values filled per multiply)
    cbrow: torch.Tensor | None = None       # (d, nbc_pad) int32
    cbcol: torch.Tensor | None = None
    c_hi: torch.Tensor | None = None        # int64, 32-bit patterns
    c_lo: torch.Tensor | None = None
    c_offsets: torch.Tensor | None = None   # int32
    c_nb: torch.Tensor | None = None        # (d,) int32
    # the numeric_sell launch: the groups' slot tables concatenated
    # (d, rows, 128) and the work table over their chunks (one row per
    # chunk; the same for every shard, since the statics are unified)
    slots_a: torch.Tensor | None = None
    slots_b: torch.Tensor | None = None
    work: torch.Tensor | None = None        # (chunks, 5) int32

    ks: tuple = ()
    caps: tuple = ()
    impl: str = "auto"
    # "selective" (all_to_all of the needed tiles) or "allgather" (the
    # skew fallback)
    exchange: str = "selective"
    nnz_pad: int = 1
    nbc_pad: int = 1
    max_send: int = 1
    num_rows: int = 0
    num_cols: int = 0
    rows_per_shard: int = 0
    # plan-time exchange bytes per multiply. comm_bytes_selective is the
    # wire volume (every off-diagonal pair padded to max_send), useful
    # counts only real tiles, allgather the all-gather of the slabs.
    comm_bytes_selective: int = 0
    comm_bytes_useful: int = 0
    comm_bytes_allgather: int = 0
    plan_seconds: float = 0.0     # host wall time of the whole prepare

    @property
    def num_shards(self) -> int:
        return self.a_flat.shape[0]

    @property
    def rows(self) -> int:
        """Rows of one shard's dense C tiles (c_rows)."""
        return sum(cap * 128 for cap in self.caps)


def prepare_sharded_product(sa: ShardedBmSparse, sb: ShardedBmSparse,
                            impl: str | None = None) -> ShardedProduct:
    """Plan C = A @ B once per structure.

    Runs the single-device product planner per shard (A_s x B, global
    structure, no tile windows), remaps each shard's B slot indices onto
    its needed set, unifies the static layout across shards and builds the
    selective exchange plan. impl ("auto" | "cuda" | "plain" | None for
    config spgemm_impl) selects the numeric of sharded_multiply.
    """
    t_plan0 = time.monotonic()
    d = sa.num_shards
    if sb.num_shards != d:
        raise ValueError("operand shard counts differ")
    if sa.num_cols != sb.num_rows:
        raise ValueError(f"inner dims mismatch: {sa.num_cols} vs "
                         f"{sb.num_rows}")
    impl = impl or get_config().spgemm_impl
    if impl not in IMPLS:
        raise ValueError(f"sharded products support impl {IMPLS}, got "
                         f"{impl!r}")
    dev = sa.device

    b_full = sb.to_bmsparse()
    nb_b = int(b_full.nb)
    # owner boundaries: to_bmsparse concatenates the shard slices in order
    nb_per = [int(x) for x in sb.nb.cpu()]
    owner_starts = np.concatenate([[0], np.cumsum(nb_per)]).astype(np.int64)
    owner_of = np.zeros((nb_b + 1,), np.int64)
    for s in range(d):
        owner_of[owner_starts[s]:owner_starts[s + 1]] = s
    owner_of[nb_b] = d  # sentinel

    # B decompressed once, shared by the d per-shard plans; no tile
    # windows: the sharded numeric re-derives absolute slot tables
    b_prep = types.SimpleNamespace(dense_flat=b_full.decompress_blocks_flat())
    timer = PhaseTimer(enabled=False)
    plans = [sg._plan_product(sa.shard_local(s), b_full, None, b_prep, timer,
                              False, winkernel="off") for s in range(d)]

    # ---- unified static layout ------------------------------------------
    ks_all = sorted({kg for p in plans for kg, _, _ in p.groups},
                    reverse=True)
    caps = [max([1] + [bucket_size(c1 - c0, minimum=1) for p in plans
                       for k2, c0, c1 in p.groups if k2 == kg])
            for kg in ks_all]
    nnz_pad = max(p.nnz_pad for p in plans)
    nbc_pad = max(p.nb_pad_c for p in plans)
    nb_a_max = max(p.a_flat.shape[0] for p in plans)

    # ---- per-shard slot tables + needed sets + compress columns ---------
    tas = [np.full((d, cap, kg, 128), nb_a_max, np.int32)
           for kg, cap in zip(ks_all, caps)]
    tbs_global = [np.full((d, cap, kg, 128), nb_b, np.int32)
                  for kg, cap in zip(ks_all, caps)]
    r_rows = sum(cap * 128 for cap in caps)
    sig = [np.zeros((d, r_rows), np.int64) for _ in range(3)]
    cbrow = np.full((d, nbc_pad), sa.block_rows, np.int32)
    cbcol = np.zeros((d, nbc_pad), np.int32)
    c_hi = np.zeros((d, nbc_pad), np.int64)
    c_lo = np.zeros((d, nbc_pad), np.int64)
    c_off = np.zeros((d, nbc_pad), np.int32)
    c_nb = np.zeros((d,), np.int32)
    a_flat = torch.zeros((d, nb_a_max, 64), dtype=torch.float32, device=dev)
    needed = []          # per shard: sorted global ids of needed B blocks

    for s, p in enumerate(plans):
        a_flat[s, :p.a_flat.shape[0]] = p.a_flat.float()
        sent_a, sent_b = p.a_flat.shape[0], p.b_flat.shape[0]
        sig_s = [x.cpu().numpy() for x in p.sig_sigma]
        row0 = 0
        for gi, kg in enumerate(ks_all):
            cap = caps[gi]
            # this shard's group of depth kg, if any (the plan's slot
            # tables carry the sentinels sent_a / sent_b)
            for g, (k2, c0, c1) in enumerate(p.groups):
                if k2 != kg:
                    continue
                ch = c1 - c0
                n_real = min(bucket_size(ch, minimum=1), cap)
                ta_h = p.tas[g].cpu().numpy()[:n_real]
                tb_h = p.tbs[g].cpu().numpy()[:n_real]
                tas[gi][s, :n_real] = np.where(ta_h >= sent_a, nb_a_max,
                                               ta_h)
                tbs_global[gi][s, :n_real] = np.where(tb_h >= sent_b, nb_b,
                                                      tb_h)
                # sigma-ordered compress columns are plan data
                nrows = min(ch, cap) * 128
                lo_r = c0 * 128
                for col, src in zip(sig, sig_s):
                    col[s, row0:row0 + nrows] = src[lo_r:lo_r + nrows]
            row0 += cap * 128
        if ks_all:
            gids = np.unique(np.concatenate(
                [t[s][t[s] < nb_b].reshape(-1) for t in tbs_global]
            )).astype(np.int64)
        else:
            gids = np.zeros((0,), np.int64)
        needed.append(gids)

        npd = min(p.nb_pad_c, nbc_pad)
        for dst, src in ((cbrow, p.cbrow), (cbcol, p.cbcol), (c_hi, p.c_hi),
                         (c_lo, p.c_lo), (c_off, p.c_off)):
            dst[s, :npd] = src[:npd].cpu().numpy()   # already masked
        c_nb[s] = p.num_c_blocks

    # ---- selective exchange plan + B-index remap ------------------------
    # A shard's own tiles never ride the exchange: the numeric reads them
    # from the local slab (b_needed = [exchanged ; own slab ; sentinel]),
    # so max_send is the largest off-diagonal pair
    max_send = 1
    send_counts = np.zeros((d, d), np.int64)   # [src, dst]
    for s in range(d):
        for src in range(d):
            cnt = int(((needed[s] >= owner_starts[src])
                       & (needed[s] < owner_starts[src + 1])).sum())
            send_counts[src, s] = cnt
            if src != s:
                max_send = max(max_send, cnt)

    nb_b_max = max(max(nb_per), 1)
    b_flat_own = torch.zeros((d, nb_b_max, 64), dtype=torch.float32,
                             device=dev)
    bf_full = b_prep.dense_flat.float()
    for s in range(d):
        b_flat_own[s, :nb_per[s]] = bf_full[owner_starts[s]:
                                            owner_starts[s + 1]]

    # wire bytes per multiply: the exchange pads every off-diagonal pair
    # to max_send and that padding is sent; self slabs never leave
    off_diag = send_counts.sum() - np.trace(send_counts)
    useful_bytes = int(off_diag * 64 * 4)
    sel_bytes = int(d * (d - 1) * max_send * 64 * 4)
    allg_bytes = int(d * (d - 1) * nb_b_max * 64 * 4)
    # skew fallback: once the padded selective exchange moves more than
    # an all-gather of the owned slabs, the all-gather is better
    exchange = "selective" if sel_bytes < allg_bytes else "allgather"

    send_idx = np.full((d, d, max_send), nb_b_max, np.int32)  # [src, dst]
    if exchange == "selective":
        # global id -> slot of the receiver's b_needed: exchanged tiles at
        # owner * max_send + rank within the pair, own tiles at
        # d * max_send + local, the sentinel last. gids are sorted, so
        # owner regions are contiguous and searchsorted remaps in bulk.
        sent_slot = d * max_send + nb_b_max
        tbs = [np.full_like(t, sent_slot) for t in tbs_global]
        for s in range(d):
            gids = needed[s]
            owners = owner_of[gids]
            local = gids - owner_starts[owners]
            slot_arr = np.zeros((len(gids),), np.int64)
            for src in range(d):
                m = owners == src
                cnt = int(m.sum())
                if src == s:
                    slot_arr[m] = d * max_send + local[m]
                else:
                    send_idx[src, s, :cnt] = local[m]
                    slot_arr[m] = src * max_send + np.arange(cnt)
            for gi in range(len(ks_all)):
                tg = tbs_global[gi][s]
                real = tg < nb_b
                if real.any():
                    tbs[gi][s][real] = slot_arr[
                        np.searchsorted(gids, tg[real])]
    else:
        # all-gather layout: global id g lives at owner * nb_b_max + local
        tbs = []
        for gi in range(len(ks_all)):
            tg = np.minimum(tbs_global[gi], nb_b)
            owners = owner_of[tg]
            local = tg - owner_starts[np.minimum(owners, d - 1)]
            tbs.append(np.where(tg < nb_b, owners * nb_b_max + local,
                                d * nb_b_max).astype(np.int32))

    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    slots_a, tas_t = _concat_slots(tas, d, to_dev)
    slots_b, tbs_t = _concat_slots(tbs, d, to_dev)
    return ShardedProduct(
        a_flat=a_flat, b_flat=b_flat_own, send_idx=to_dev(send_idx),
        tas=tas_t, tbs=tbs_t,
        sig_hi=to_dev(sig[0]), sig_lo=to_dev(sig[1]),
        sig_off=to_dev(sig[2].astype(np.int32)),
        cbrow=to_dev(cbrow), cbcol=to_dev(cbcol), c_hi=to_dev(c_hi),
        c_lo=to_dev(c_lo), c_offsets=to_dev(c_off), c_nb=to_dev(c_nb),
        slots_a=slots_a, slots_b=slots_b,
        work=to_dev(_work_table(ks_all, caps)),
        ks=tuple(ks_all), caps=tuple(caps), impl=impl, exchange=exchange,
        nnz_pad=nnz_pad, nbc_pad=nbc_pad, max_send=max_send,
        num_rows=sa.num_rows, num_cols=sb.num_cols,
        rows_per_shard=sa.rows_per_shard,
        comm_bytes_selective=sel_bytes, comm_bytes_useful=useful_bytes,
        comm_bytes_allgather=allg_bytes,
        plan_seconds=float(time.monotonic() - t_plan0))


def _concat_slots(tables: list, d: int, to_dev):
    """The groups' (d, cap, K, 128) slot tables as one (d, rows, 128)
    tensor and per-group views into it."""
    if not tables:
        return to_dev(np.zeros((d, 0, 128), np.int32)), ()
    flat = to_dev(np.concatenate([t.reshape(d, -1, 128) for t in tables],
                                 axis=1))
    views = []
    base = 0
    for t in tables:
        n = t.shape[1] * t.shape[2]
        views.append(flat[:, base:base + n].view(t.shape))
        base += n
    return flat, tuple(views)


def _work_table(ks, caps) -> np.ndarray:
    """numeric_sell's work table over the unified groups (one row per
    chunk, groups in order): [K, first slot row, 0, 0, output chunk]."""
    rows = []
    slot0 = out0 = 0
    for kg, cap in zip(ks, caps):
        j = np.arange(cap)
        rows.append(np.stack([np.full(cap, kg), slot0 + j * kg,
                              np.zeros(cap, np.int64), np.zeros(cap, np.int64),
                              out0 + j], axis=1))
        slot0 += cap * kg
        out0 += cap
    if not rows:
        return np.zeros((0, _sk.WORK_COLS), np.int32)
    return np.concatenate(rows).astype(np.int32)


def shard_b_needed(spp: ShardedProduct, s: int) -> torch.Tensor:
    """The B tiles shard s holds after its exchange, computed on one
    process from every shard's slab: [exchanged ; own slab ; zero row]
    (selective) or [every slab ; zero row] (all-gather)."""
    zero = spp.b_flat.new_zeros((1, 64))
    if spp.exchange == "selective":
        nb_b_max = spp.b_flat.shape[1]
        parts = [torch.cat([spp.b_flat[r], zero])[
            spp.send_idx[r, s].long().clamp(0, nb_b_max)]
            for r in range(spp.num_shards)]
        return torch.cat(parts + [spp.b_flat[s], zero])
    return torch.cat([spp.b_flat.reshape(-1, 64), zero])


def local_multiply(spp: ShardedProduct, s: int, b_needed: torch.Tensor,
                   kernels: bool) -> torch.Tensor:
    """Shard s's C values (nnz_pad,) from its exchanged B tiles: one
    numeric_sell launch over all unified K-groups (its plain twin when not
    `kernels`), then the bitmap-rank compress's plain twin."""
    af = spp.a_flat[s]
    c_rows = torch.zeros((spp.rows, 64), dtype=torch.float32,
                         device=af.device)
    if spp.ks:
        parts, row0 = [], 0
        for ta, tb, cap in zip(spp.tas, spp.tbs, spp.caps):
            parts.append((row0, cap * 128, (ta[s], tb[s])))
            row0 += cap * 128
        launch = _sk.GroupLaunch(spp.work, spp.slots_a[s], spp.slots_b[s],
                                 max(spp.ks), tuple(parts))
        run = (_sk.numeric_sell_groups if kernels
               else _sk.numeric_sell_groups_plain)
        run(af, b_needed, launch, c_rows)
    return _bk.bitmap_compress_plain(c_rows, spp.sig_hi[s], spp.sig_lo[s],
                                     spp.sig_off[s], spp.nnz_pad, spp.nnz_pad)


def sharded_multiply(spp: ShardedProduct, mesh: Mesh) -> ShardedBmSparse:
    """Run the planned product over the mesh; returns C sharded like A,
    every shard's values on every rank."""
    if spp.num_shards != mesh.size:
        raise ValueError(f"plan has {spp.num_shards} shards, mesh has "
                         f"{mesh.size}")
    s = mesh.rank
    bf = spp.b_flat[s]
    zero = bf.new_zeros((1, 64))
    if spp.exchange == "selective":
        # the tiles each destination needs from us (the self row and the
        # padding read the zero row); slice r of the result came from
        # rank r
        send = torch.cat([bf, zero])[
            spp.send_idx[s].long().clamp(0, bf.shape[0])]
        b_needed = torch.cat([mesh.all_to_all(send).reshape(-1, 64), bf,
                              zero])
    else:
        b_needed = torch.cat([mesh.all_gather(bf), zero])
    kernels = sg._use_kernels(spp.impl, bf.device, spp.a_flat.dtype)
    values = local_multiply(spp, s, b_needed, kernels)
    return ShardedBmSparse(
        brow=spp.cbrow, bcol=spp.cbcol, bmp_hi=spp.c_hi, bmp_lo=spp.c_lo,
        offsets=spp.c_offsets, values=mesh.all_gather(values[None]),
        nb=spp.c_nb, num_rows=spp.num_rows, num_cols=spp.num_cols,
        nnz=-1, transposed=False, rows_per_shard=spp.rows_per_shard)
