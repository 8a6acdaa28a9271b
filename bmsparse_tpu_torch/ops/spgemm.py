"""Sparse matrix - sparse matrix multiply C = A @ B on BmSparse.

Counterpart of ``bmsparse_tpu/ops/spgemm.py``, which restates the
reference SpGEMM (`bmSparse_mult`, ref: src/bmSparse_SPGEMM.cu:827-1223).
The symbolic phase and the plan are ported step for step, so that every
plan array equals the JAX package's at every position, padding included:

  T1  B blocks per block-row              -> segment sum over B.brow
  T2  per-A-block task counts             -> gather through A.bcol
  T3  task-list expansion                 -> repeat_interleave
  T4  bitmap-product pruning              -> byte-AND structural product
  T5  sort tasks by C key                 -> one stable sort (ops/segsort.py)
  T6  C structure (keys, bitmaps, offsets) -> two-level segmented scan
  plan: SELL-sigma order of C blocks, K-groups of 128-block chunks, slot
        operand tables, tile windows        (_plan_sell_device, _plan_stage2)

  numeric: two hand-written Hopper kernels, each launched once per
      product over a work table of 128-block chunks that the plan orders
      by the chunk's first A block (_product_launches), both writing one
      c_rows:
      csrc/spgemm_window.cu  (numeric_window) for the groups with a
                             tile-window plan (the JAX package's
                             numeric_window_pallas),
      csrc/spgemm_sell.cu    (numeric_sell) for every other group (its
                             numeric_sell_pallas, gather fused in).
  compress: the dense C tiles into C's bit-order value array, one of
      three ways chosen at plan time by config spgemm_compress (the JAX
      package's names):
        "auto"/"scatter" csrc/bitmap_compress.cu (bitmap_compress) on
                         the kernels, its plain twin elsewhere: each set
                         lane written once at its block's offset + the
                         popcount of the bits below it, no sort and no
                         sum (the JAX package's _compress_rows sorts,
                         rotates and scatter-adds rows to the same
                         values);
        "fold"           _pack_rows, then a gather of each output row's
                         contributors through a plan table
                         (_compress_fold), plain torch, where the plan's
                         run lengths allow it;
        "mxu"            _pack_rows, then the segment compress per sigma
                         class (_compress_mxu) on
                         csrc/segment_compress.cu, the counterpart of the
                         JAX package's MXU kernel.

The JAX package's XLA slab-window gather (`_numeric_group_windowed`) is a
TPU gather-rate workaround; its groups' slot tables hold absolute block
indices, so numeric_sell computes the same values for them. `_plan_windows`
is ported so that the plan arrays stay equal.

impl:
  "auto"  — the CUDA kernels for float32 and bfloat16 operands on a CUDA
            device, their plain torch versions for tensors on the CPU and
            for float64 operands (the kernels take float32 and bfloat16;
            the JAX package likewise keeps float64 off its Pallas kernels);
  "cuda"  — the CUDA kernels; raises for tensors on the CPU and for
            float64 operands;
  "plain" — the plain torch versions everywhere (tests, chip_smoke.py);
  "xla"   — the JAX package's chunked segment-sum numeric
            (_numeric_and_compress: a chunked gather, block_matmul_flat and
            index_add_), plain torch on every device, as it is XLA outside
            any Pallas kernel there.

`spgemm_padded(A, B, max_tasks, ...)` runs the whole product with static
bounds and no host sync: its result is padded (C.nb is the true block
count as a 0-d tensor; blocks past it have zero bitmaps). The
multi-device structure-oblivious path (parallel/spgemm.py) runs it per
shard.

Exactly two host syncs per plan: the task total and the plan packet (the
reference's two D->H copies, ref :1095,1106). C's structure is the
structural product: numerically cancelled entries stay explicit zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import bucket_size, get_config, round_up
from ..format import bitmap as bm
from ..format.bmsparse import BmSparse
from ..utils.timing import PhaseTimer, span
from .cuda import bitmap_compress_kernel as _bk
from .cuda import compress_kernel as _ck
from .cuda import spgemm_kernel as _sk
from .cuda import spgemm_window_kernel as _wk
from .segsort import sort_by_key
from .spmv import _use_kernels as _spmv_use_kernels

IMPLS = ("auto", "cuda", "plain", "xla")
COMPRESS_MODES = ("auto", "scatter", "fold", "mxu")
_I32_MAX = 2**31 - 1
_NUMERIC_CHUNK = 1 << 16    # tasks per step of the chunked numeric


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. To a CUDA device through pinned memory,
    asynchronously: a copy from pageable memory would synchronise the
    stream, a host sync the plan does not otherwise make."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _check_operands(a: BmSparse, b: BmSparse) -> None:
    if a.num_cols != b.num_rows:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.transposed:
        raise ValueError("A must be stored untransposed (row-major blocks)")
    if a.device != b.device:
        raise ValueError(f"A on {a.device} but B on {b.device}")


def _segment_reduce(vals, seg, n: int, reduce: str, identity: int):
    """JAX's segment_sum / segment_min: segment ids outside [0, n) drop
    out, empty segments hold the identity."""
    seg = seg.long()
    idx = torch.where((seg >= 0) & (seg < n), seg, n)
    out = torch.full((n + 1,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, reduce=reduce,
                               include_self=True)[:n]


# ---------------------------------------------------------------------------
# T1 + T2: task counting
# ---------------------------------------------------------------------------
def _task_counts(a: BmSparse, b: BmSparse, num_b_block_rows: int):
    """Per-A-block task counts, exclusive offsets, B's per-row first block
    (a positional segment min, so B may hold padding between row groups)
    and the task total (a device scalar)."""
    b_valid = ((b.bmp_hi | b.bmp_lo) != 0).long()
    b_row_count = _segment_reduce(b_valid, b.brow, num_b_block_rows,
                                  "sum", 0)                     # T1
    pos = torch.arange(b.nb_pad, device=b.device)
    b_row_start = _segment_reduce(
        torch.where(b_valid > 0, pos, _I32_MAX), b.brow, num_b_block_rows,
        "amin", _I32_MAX)
    a_valid = (a.bmp_hi | a.bmp_lo) != 0
    bcol = a.bcol.long().clamp(0, num_b_block_rows - 1)
    cnt = torch.where(a_valid, b_row_count[bcol], 0)            # T2
    offs = torch.cumsum(cnt, 0) - cnt
    total = offs[-1] + cnt[-1]
    return cnt, offs, b_row_start, total


# ---------------------------------------------------------------------------
# T3 + T4 + T5: task list construction, pruning, sort by C key
# ---------------------------------------------------------------------------
def _build_tasks(a: BmSparse, b: BmSparse, task_offs, b_row_start,
                 total, num_tasks: int, c_row_sentinel: int):
    """The (padded) task list sorted by C key, pruned tasks and padding at
    the tail. Returns (a_idx, b_idx, ck_row, ck_col, ph, pl, nz_total):
    task t multiplies A block a_idx[t] by B block b_idx[t] into C block
    (ck_row, ck_col)[t] with structural product bitmap (ph, pl)[t]; dead
    tasks carry ck_row == sentinel. `total` is the task count, a 0-d
    tensor on the operands' device; tasks past num_tasks are cut, as in
    the JAX package."""
    dev = a.device
    t = torch.arange(num_tasks, device=dev)
    valid = t < total
    nbr_b = b_row_start.shape[0]
    start_per_blk = b_row_start[a.bcol.long().clamp(0, nbr_b - 1)]
    # T3: task t belongs to the first A block whose task span ends past t;
    # positions past the total take the LAST block, as the fill of JAX's
    # jnp.repeat(..., total_repeat_length=num_tasks) does
    ends = torch.cat([task_offs[1:], total.reshape(1)])
    src = torch.searchsorted(ends, t, right=True).clamp(max=a.nb_pad - 1)
    a_idx = src
    within = t - task_offs[src]
    b_idx = (start_per_blk[src] + within).clamp(0, b.nb_pad - 1)
    a_hi, a_lo, a_row = a.bmp_hi[src], a.bmp_lo[src], a.brow[src]
    b_hi, b_lo, b_col = b.bmp_hi[b_idx], b.bmp_lo[b_idx], b.bcol[b_idx]

    # T4: structural block product; a zero product prunes the task
    ph, pl = bm.bitmap_product(a_hi, a_lo, b_hi, b_lo,
                               b_transposed=b.transposed)
    alive = valid & ((ph | pl) != 0)
    ph = torch.where(alive, ph, 0)
    pl = torch.where(alive, pl, 0)
    ck_row = torch.where(alive, a_row, c_row_sentinel).int()
    ck_col = torch.where(alive, b_col, 0).int()
    # dead/padding tasks point at the top block index
    a_idx = torch.where(alive, a_idx, a.nb_pad - 1).int()
    b_idx = torch.where(alive, b_idx, b.nb_pad - 1).int()

    # T5: one stable lexicographic sort carrying the product bitmaps
    ck_row, ck_col, a_idx, b_idx, ph, pl = sort_by_key(
        ck_row, ck_col, a_idx, b_idx, ph, pl, num_keys=2)
    return a_idx, b_idx, ck_row, ck_col, ph, pl, alive.sum()


# ---------------------------------------------------------------------------
# T6: C symbolic structure from the sorted task list
# ---------------------------------------------------------------------------
_SCAN_W = 128


def _scan_combine(op: str, a, b, m):
    """Fold rolled-in values b into a where mask m (else identity)."""
    if op == "or":
        return a | torch.where(m, b, 0)
    if op == "min":
        return torch.minimum(a, torch.where(m, b, _I32_MAX))
    return torch.maximum(a, torch.where(m, b, -(2**31)))


def _seg_scan_2level(seg, vals: list) -> list:
    """Inclusive segmented scan of several int64 arrays in two levels,
    step for step as the JAX package runs it (its partial values at
    positions that end no segment reach the plan's padding rows).

    vals: list of (array, op), op in {"or", "min", "max"}; seg are
    non-decreasing segment ids; lengths a multiple of 128. Level 1 runs 7
    Hillis-Steele steps inside (nt/128, 128) rows; level 2 resolves the
    cross-row carries with a segmented scan over the row summaries.
    """
    nt = seg.shape[0]
    W = _SCAN_W
    R = nt // W
    seg2 = seg.reshape(R, W)
    arrs = [v.reshape(R, W) for v, _ in vals]
    ops = [op for _, op in vals]
    lane = torch.arange(W, device=seg.device)[None, :]
    sh = 1
    while sh < W:
        m = (lane >= sh) & (torch.roll(seg2, sh, dims=1) == seg2)
        arrs = [_scan_combine(op, a, torch.roll(a, sh, dims=1), m)
                for a, op in zip(arrs, ops)]
        sh *= 2
    seg_first = seg2[:, 0]
    seg_last = seg2[:, -1]
    prev_last = torch.roll(seg_last, 1)
    riota = torch.arange(R, device=seg.device)
    link = (riota > 0) & (seg_first == seg_last) & (seg_first == prev_last)
    carry_seg = torch.cumsum(1 - link.long(), 0)
    lasts = [a[:, -1] for a in arrs]
    sh = 1
    while sh < R:
        m = (riota >= sh) & (torch.roll(carry_seg, sh) == carry_seg)
        lasts = [_scan_combine(op, c, torch.roll(c, sh), m)
                 for c, op in zip(lasts, ops)]
        sh *= 2
    applies = (riota[:, None] > 0) & (seg2 == prev_last[:, None])
    return [
        _scan_combine(op, a, torch.roll(c, 1)[:, None].expand_as(a),
                      applies).reshape(nt)
        for a, c, op in zip(arrs, lasts, ops)
    ]


def _c_symbolic_scan(ph, pl, ck_row, ck_col, c_row_sentinel: int,
                     a_idx, b_idx):
    """Task-space C structure: the OR of each C block's product bitmaps,
    its value offset and its operand index span sit at the block's LAST
    task position. Returns (c_seg, keys_tbl, nbc, nnzc) with keys_tbl the
    (nt, 11) int64 table [ck_row, ck_col, hi, lo, off, cnt, a_idx, b_idx,
    amin, bmin, bmax] (hi/lo as 32-bit patterns; the JAX package keeps
    the same bits in int32)."""
    nt = ph.shape[0]
    pad = (-nt) % _SCAN_W
    dev = ph.device
    if pad:
        # tiny inputs: pad into a private trailing segment
        z = torch.zeros(pad, dtype=torch.int64, device=dev)
        ph, pl = torch.cat([ph, z]), torch.cat([pl, z])
        ck_row = torch.cat([ck_row, torch.full(
            (pad,), c_row_sentinel, dtype=ck_row.dtype, device=dev)])
        ck_col = torch.cat([ck_col, z.to(ck_col.dtype)])
        a_idx = torch.cat([a_idx, z.to(a_idx.dtype)])
        b_idx = torch.cat([b_idx, z.to(b_idx.dtype)])
    alive = ck_row != c_row_sentinel
    same = (ck_row[1:] == ck_row[:-1]) & (ck_col[1:] == ck_col[:-1])
    new = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                     (~same).long()])
    c_seg = torch.cumsum(new, 0) - 1
    nbc = torch.where(alive, c_seg + 1, 0).max()
    a_l, b_l = a_idx.long(), b_idx.long()
    hi, lo, amin, bmin, bmax = _seg_scan_2level(
        c_seg, [(ph, "or"), (pl, "or"), (a_l, "min"), (b_l, "min"),
                (b_l, "max")])
    is_end = torch.cat([c_seg[1:] != c_seg[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)]) & alive
    cnt = torch.where(is_end, bm.popcount(hi, lo).long(), 0)
    csum = torch.cumsum(cnt, 0)
    keys_tbl = torch.stack(
        [ck_row.long(), ck_col.long(), hi, lo, csum - cnt, cnt, a_l, b_l,
         amin, bmin, bmax], dim=1)
    if pad:
        c_seg, keys_tbl = c_seg[:nt], keys_tbl[:nt]
    return c_seg, keys_tbl, nbc, csum[-1]


def _c_symbolic(ph, pl, ck_row, ck_col, c_row_sentinel: int):
    """C block keys, bitmaps and offsets from the sorted tasks, in task
    space (the static-bound path; the plan's _c_symbolic_scan is the host-
    orchestrated one). Returns (c_seg, cbrow, cbcol, c_hi, c_lo,
    c_offsets, nbc, nnzc): arrays of the task count's length (an upper
    bound on C's blocks), padding past nbc with row c_row_sentinel, zero
    bitmaps and offset max(nnzc - 1, 0); nbc and nnzc 0-d tensors."""
    nt = ck_row.shape[0]
    dev = ck_row.device
    alive = ck_row != c_row_sentinel
    same = (ck_row[1:] == ck_row[:-1]) & (ck_col[1:] == ck_col[:-1])
    new = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                     (~same).long()])
    # dead and padding tasks share the sentinel key and collapse into one
    # trailing segment, which the block count leaves out
    c_seg = torch.cumsum(new, 0) - 1
    nbc = torch.where(alive, c_seg + 1, 0).amax() if nt else c_seg.sum()
    keys = torch.stack([ck_row, ck_col], dim=1).int()
    ckeys = keys.new_zeros((nt, 2))
    ckeys[:, 0] = c_row_sentinel
    # every task of a segment writes the same key
    ckeys[c_seg] = keys
    # C bitmap = OR of the segment's product bitmaps (dead tasks carry zero
    # bitmaps): a segment sum of the bit planes, then > 0
    c_bits = torch.zeros((nt, 64), dtype=torch.int32, device=dev).index_add_(
        0, c_seg, bm.expand_bits(ph, pl)) > 0
    c_hi, c_lo = bm.pack_bits(c_bits)
    cnt = c_bits.sum(1)
    c_off = torch.cumsum(cnt, 0) - cnt
    nnzc = c_off[-1] + cnt[-1] if nt else cnt.sum()
    c_off = torch.where(torch.arange(nt, device=dev) < nbc, c_off,
                        (nnzc - 1).clamp(min=0)).int()
    return c_seg, ckeys[:, 0], ckeys[:, 1], c_hi, c_lo, c_off, nbc, nnzc


# ---------------------------------------------------------------------------
# Numeric plan — task-SELL layout
# ---------------------------------------------------------------------------
# C blocks are sigma-sorted by task count, grouped into chunks of 128 and
# each chunk padded to its bucketed max task count K; a K-group is a run
# of chunks with one K. See the JAX module for the TPU reasons of the
# layout; the two CUDA kernels take it as it is.
_K_BUCKETS = tuple(
    sorted({1, 2, 3} | {m for b in range(2, 21)
                        for m in ((1 << b), 3 << (b - 1))})
)


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if b >= k:
            return b
    return k


def _bucket_ceil(c, buckets):
    """Smallest bucket >= c, elementwise; c itself past the last bucket."""
    i = torch.searchsorted(buckets, c)
    nbk = buckets.shape[0]
    return torch.where(i < nbk, buckets[i.clamp(max=nbk - 1)], c)


def _plan_sell_device(c_seg, num_alive, nbc, nbc_pad: int, keys_tbl):
    """Device-side numeric plan, from two stable sorts:

      1. each C block's last task ("end") is pulled to the front by a sort
         keyed on the end-flagged segment id, carrying the scan columns —
         the sorted prefix is the natural-order block table;
      2. per-block counts/starts are differences of ends;
      3. a second sort keyed (bucketed count desc, natural id) gives the
         SELL-sigma order, with the planner's padding blocks routed to
         the end of each count class so no chunk straddles two classes.

    Returns (starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk, stats,
    nat_cols, sig_cols): stats = per-chunk (amin, amax, bmin, bmax);
    nat_cols = natural-order (ck_row, ck_col, hi, lo, off); sig_cols =
    sigma-order (hi, lo, off)."""
    nt = c_seg.shape[0]
    dev = c_seg.device
    t = torch.arange(nt, device=dev)
    alive = t < num_alive
    is_end = alive & torch.cat([c_seg[1:] != c_seg[:-1],
                                torch.ones(1, dtype=torch.bool, device=dev)])
    big = 2**30
    key = torch.where(is_end, c_seg, big)
    ends_all = torch.sort(key, stable=True).indices
    # columns (0-4, 6, 8-10) by slices: a list index would be copied from
    # the host, a stream sync
    rows = keys_tbl[ends_all]
    nat_all = torch.cat([rows[:, 0:5], rows[:, 6:7], rows[:, 8:11]], dim=1)

    def fit(x):
        if nt >= nbc_pad:
            return x[:nbc_pad]
        return torch.cat([x, x.new_zeros((nbc_pad - nt,) + x.shape[1:])])

    ends = fit(ends_all)
    (nat_ckr, nat_ckc, nat_hi, nat_lo, nat_off,
     nat_amax, nat_amin, nat_bmin, nat_bmax) = fit(nat_all).unbind(1)
    b_iota = torch.arange(nbc_pad, device=dev)
    validb = b_iota < nbc
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    counts = torch.where(validb, ends - starts + 1, 0)

    buckets = _to_device(np.array(_K_BUCKETS, np.int64), dev)
    nbk = len(_K_BUCKETS)
    live = counts > 0
    kb_blk = torch.where(live, _bucket_ceil(counts, buckets), 0)
    amin_key = torch.where(live, nat_amin, big)
    amax_m = torch.where(live, nat_amax, -1)
    bmin_m = torch.where(live, nat_bmin, big)
    bmax_m = torch.where(live, nat_bmax, -1)

    # class-aligned sigma padding: every count class occupies a
    # 128-multiple of slots (see the JAX module for why)
    buckets_desc = buckets.flip(0)
    bi = torch.searchsorted(buckets, kb_blk)
    hit = (bi < nbk) & (buckets[bi.clamp(max=nbk - 1)] == kb_blk)
    sizes = torch.zeros(nbk + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(hit, bi, nbk), torch.ones_like(bi))[:nbk].flip(0)
    pc = torch.where(sizes > 0, (-sizes) % 128, 0)
    cumi = torch.cumsum(pc, 0)
    jpad = b_iota - nbc                                  # < 0 for real
    cls_idx = torch.searchsorted(cumi, jpad, right=True)
    kb_pad = torch.where(cls_idx < nbk,
                         buckets_desc[cls_idx.clamp(max=nbk - 1)], 0)
    key_kb = torch.where(live, kb_blk, torch.where(jpad >= 0, kb_pad, 0))

    # keys (-key_kb, b_iota): b_iota ascends, so a stable sort on the
    # first key gives the lexicographic order
    nat_of_sig = torch.sort(-key_kb, stable=True).indices
    amin_s, starts_sig, ends_sig, cnt_sig = (
        x[nat_of_sig] for x in (amin_key, starts, ends, counts))
    sig_hi, sig_lo, sig_off, amax_s, bmin_s, bmax_s = (
        x[nat_of_sig] for x in (nat_hi, nat_lo, nat_off, amax_m, bmin_m,
                                bmax_m))
    # zero-count (padding) blocks carried garbage columns through the sort
    okb = cnt_sig > 0
    sig_hi = torch.where(okb, sig_hi, 0)
    sig_lo = torch.where(okb, sig_lo, 0)
    sig_off = torch.where(okb, sig_off, 0)
    nchunk = nbc_pad // 128
    k_raw = cnt_sig.reshape(nchunk, 128).amax(1)
    k_chunk = torch.where(k_raw > 0, _bucket_ceil(k_raw, buckets), 0)
    stats = (amin_s.reshape(nchunk, 128).amin(1),
             amax_s.reshape(nchunk, 128).amax(1),
             bmin_s.reshape(nchunk, 128).amin(1),
             bmax_s.reshape(nchunk, 128).amax(1))
    return (starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk, stats,
            (nat_ckr, nat_ckc, nat_hi, nat_lo, nat_off),
            (sig_hi, sig_lo, sig_off))


def _gather_group_slots(slot_tbl, starts_sig, cnt_sig, c0: int,
                        ch_pad: int, k: int):
    """Slot operand indices of one K-group: (ta, tb), each (ch_pad, k, 128)
    int32; slot (c, k, lane) holds the A/B block of sigma block
    (c0 + c)*128 + lane's k-th task, the sentinels past its count.
    slot_tbl is keys_tbl's (a_idx, b_idx) columns with the sentinel row
    (sent_a, sent_b) appended."""
    nt = slot_tbl.shape[0] - 1
    npad = ch_pad * 128
    ssz = starts_sig.shape[0]
    pad = starts_sig.new_zeros(npad)
    base = min(max(c0 * 128, 0), ssz)
    st = torch.cat([starts_sig, pad])[base:base + npad].reshape(ch_pad, 1, 128)
    cn = torch.cat([cnt_sig, pad])[base:base + npad].reshape(ch_pad, 1, 128)
    k_iota = torch.arange(k, device=st.device)[None, :, None]
    idx = torch.where(k_iota < cn, st + k_iota, nt)
    rows = slot_tbl[idx.reshape(-1).clamp(0, nt)].int()
    return (rows[:, 0].reshape(ch_pad, k, 128).contiguous(),
            rows[:, 1].reshape(ch_pad, k, 128).contiguous())


def _contiguous_k_groups(kc) -> list:
    """(K, c0, c1) triples over the non-increasing per-chunk depth array
    (0-depth chunks are empty and dropped)."""
    groups = []
    c0 = 0
    n = len(kc)
    while c0 < n and kc[c0] > 0:
        c1 = c0
        while c1 < n and kc[c1] == kc[c0]:
            c1 += 1
        groups.append((int(kc[c0]), c0, c1))
        c0 = c1
    return groups


# ---------------------------------------------------------------------------
# Numeric phase and compress
# ---------------------------------------------------------------------------
def _use_kernels(impl: str, device: torch.device, dtype) -> bool:
    """Whether the task-SELL numeric launches the CUDA kernels for
    operands of `dtype` on `device`: the SpMV rule (ops/spmv.py), for
    the SpGEMM impls."""
    if impl not in IMPLS:
        raise ValueError(f"unknown SpGEMM impl {impl!r}")
    return _spmv_use_kernels(impl, device, dtype)


def _numeric_xla(a_flat, b_flat, a_idx, b_idx, c_seg, num_c_blocks: int):
    """Chunked 8x8 block products summed per C block (the JAX package's
    _numeric_xla): per chunk of _NUMERIC_CHUNK tasks, gather the dense
    tiles, multiply them (block_matmul_flat) and index_add_ into C block
    c_seg. Segments outside [0, num_c_blocks) drop out. Returns
    (num_c_blocks, 64) row-major tiles in promote(a dtype, float32)."""
    from ..format.blockops import block_matmul_flat
    from .gather import gather_rows

    acc_dt = torch.promote_types(a_flat.dtype, torch.float32)
    acc = torch.zeros((num_c_blocks + 1, 64), dtype=acc_dt,
                      device=a_flat.device)
    for s in range(0, a_idx.shape[0], _NUMERIC_CHUNK):
        sl = slice(s, s + _NUMERIC_CHUNK)
        contrib = block_matmul_flat(
            gather_rows(a_flat, a_idx[sl]), gather_rows(b_flat, b_idx[sl]),
            b_transposed=False, acc_dtype=acc_dt)
        seg = c_seg[sl].long()
        acc.index_add_(0, torch.where((seg >= 0) & (seg < num_c_blocks), seg,
                                      num_c_blocks), contrib)
    return acc[:num_c_blocks]


def _numeric_and_compress(a_flat, b_flat, a_idx, b_idx, c_seg, c_hi, c_lo,
                          c_offsets, num_c_blocks: int, num_c_nnz: int):
    """The chunked numeric, then the compress through C's bitmaps: value
    slot offsets + prefix popcount of each set bit (the inverse of
    decompress_blocks); positions at or past num_c_nnz drop out."""
    c_dense = _numeric_xla(a_flat, b_flat, a_idx, b_idx, c_seg, num_c_blocks)
    return _bk.bitmap_compress_plain(
        c_dense, c_hi[:num_c_blocks], c_lo[:num_c_blocks],
        c_offsets[:num_c_blocks], num_c_nnz, num_c_nnz)


def _numeric_products(a_flat, b_flat, launches: tuple, rows: int,
                      kernels: bool):
    """Products of all K-groups from the plan's launches (window, sell):
    one numeric_window launch over the groups with a tile-window plan and
    one numeric_sell launch over the others (their plain twins when not
    `kernels`), into one c_rows: the (rows, 64) dense C tiles stacked in
    sigma group order."""
    if a_flat.dtype != b_flat.dtype:
        dt = torch.promote_types(a_flat.dtype, b_flat.dtype)
        a_flat, b_flat = a_flat.to(dt), b_flat.to(dt)
    out = torch.empty((rows, 64),
                      dtype=torch.promote_types(a_flat.dtype, torch.float32),
                      device=a_flat.device)
    win, sell = launches
    if win is not None:
        run = (_wk.numeric_window_groups if kernels
               else _wk.numeric_window_groups_plain)
        run(a_flat, b_flat, win, out)
    if sell is not None:
        run = _sk.numeric_sell_groups if kernels \
            else _sk.numeric_sell_groups_plain
        run(a_flat, b_flat, sell, out)
    return out


def _pack_rows(c_rows, hi, lo, off):
    """Per-block bit-order packing: (w, b_row) where w (R, 128) holds each
    block's packed values rotated to their output lanes (lanes [0, 64)
    belong to output row b_row, lanes [64, 128) to row b_row + 1).

    A stable 64-lane sort keyed on the unset flag packs the set-bit
    values to the front in slot order; a rotation right by off % 64 then
    holds both parts."""
    bits = bm.expand_bits(hi, lo)                       # (R, 64)
    r = (off % 64)[:, None].long()
    set_ = bits > 0
    lane = torch.arange(64, device=c_rows.device)[None, :]
    order = torch.sort((~set_).int(), dim=1, stable=True).indices
    packed = c_rows.gather(1, order)
    cnt = set_.sum(1, keepdim=True)
    packed = torch.where(lane < cnt, packed, 0.0)
    packed = packed.gather(1, (lane - r) % 64)
    v0 = torch.where((lane >= r) & (lane < r + cnt), packed, 0.0)
    v1 = torch.where(lane < cnt + r - 64, packed, 0.0)
    return torch.cat([v0, v1], dim=1), (off // 64).long()


def _fold_out(out128, t_rows: int, num_c_nnz: int):
    """Split 128-wide packed rows back into 64-lane output rows: row q's
    lanes [64, 128) belong to output row q + 1."""
    if t_rows > 1:
        carry = torch.cat([out128.new_zeros((1, 64)),
                           out128[: t_rows - 1, 64:]])
    else:
        carry = out128.new_zeros((t_rows, 64))
    out = out128[:t_rows, :64] + carry
    return out.reshape(-1)[:num_c_nnz]


def _compress_fold(c_rows, hi, lo, off, g_tbl, num_c_nnz: int):
    """Gather-fold compress (the JAX package's _compress_fold): g_tbl
    (t_rows, J) lists, per output row, the packed rows whose values start
    in it (sentinels past the table read the appended zero row); each
    output row is the sum of its contributors, then the 128 -> 64 lane
    fold."""
    w, _ = _pack_rows(c_rows, hi, lo, off)
    w_ext = torch.cat([w, w.new_zeros((1, 128))])
    t_rows = -(-num_c_nnz // 64) if num_c_nnz else 1
    j_n = g_tbl.shape[1]
    idx = g_tbl.long().clamp(0, w.shape[0]).reshape(-1)
    out128 = w_ext[idx].reshape(-1, j_n, 128).sum(dim=1)
    return _fold_out(out128, t_rows, num_c_nnz)


def _mxu_class_inputs(c_rows, hi, lo, off, groups):
    """Per sigma class (K-group), the segment compress's operands: the
    packed rows (w_g, (R_g, 128)) and their output rows (b_g, (R_g,)
    int32, non-decreasing: within a class the sigma order keeps the
    natural block order). The stacked layout pads each group to its
    bucketed chunk count; padding rows have empty bitmaps and get b_row
    2**30, which drops out."""
    w, _ = _pack_rows(c_rows, hi, lo, off)
    b_row = torch.where((hi | lo) != 0, off // 64, 2**30).int()
    base = 0
    for _, c0, c1 in groups:
        rows_g = bucket_size(c1 - c0, minimum=1) * 128
        yield w[base:base + rows_g], b_row[base:base + rows_g]
        base += rows_g


def _compress_mxu(c_rows, hi, lo, off, groups, num_c_nnz: int,
                  kernels: bool):
    """Segment compress (the JAX package's _compress_mxu): one
    segment_compress_class per sigma class, the classes' outputs summed
    (their positions are disjoint), then the 128 -> 64 lane fold."""
    seg = (_ck.segment_compress_class if kernels
           else _ck.segment_compress_class_plain)
    t_rows = -(-num_c_nnz // 64) if num_c_nnz else 1
    out128 = None
    for w_g, b_g in _mxu_class_inputs(c_rows, hi, lo, off, groups):
        part = seg(w_g, b_g, t_rows)
        out128 = part if out128 is None else out128.add_(part)
    if out128 is None:
        out128 = c_rows.new_zeros((t_rows, 128))
    return _fold_out(out128, t_rows, num_c_nnz)


def _compress_fold_plan(nat_off, nat_of_sig, chunk_base, nbc: int,
                        j_max: int, t_rows_pad: int):
    """The (t_rows_pad, j_max) contributor table of _compress_fold (the
    JAX package's _compress_fold_plan, its sorts as stable torch sorts).
    In natural block order the offsets are a prefix sum, so the blocks
    whose values start in output row q form one run; g[q, j] is the
    stacked numeric row of the run's j-th block (natural -> sigma by
    inverting nat_of_sig, sigma -> stacked row through chunk_base).
    Absent contributors hold 2**30."""
    nbc_pad = nat_off.shape[0]
    dev = nat_off.device
    big = 2**30
    n_iota = torch.arange(nbc_pad, device=dev)
    validb = n_iota < nbc
    sig_of = torch.sort(nat_of_sig, stable=True).indices
    srow = chunk_base[(sig_of // 128).clamp(0, chunk_base.shape[0] - 1)] \
        + sig_of % 128
    b_row = torch.where(validb, nat_off.long() // 64, big)
    newr = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      b_row[1:] != b_row[:-1]])
    keyq = torch.where(validb & newr, b_row, big)
    firstn_all = torch.sort(keyq, stable=True).indices
    if nbc_pad >= t_rows_pad:
        first_q = firstn_all[:t_rows_pad]
    else:
        first_q = torch.cat([firstn_all, firstn_all.new_full(
            (t_rows_pad - nbc_pad,), nbc_pad)])
    j_iota = torch.arange(j_max, device=dev)[None, :]
    nat_id = torch.clamp(first_q[:, None] + j_iota, max=nbc_pad)
    tail = torch.full((1,), big, dtype=torch.int64, device=dev)
    br = torch.cat([b_row, tail])[nat_id]
    q_iota = torch.arange(t_rows_pad, device=dev)[:, None]
    srow_ext = torch.cat([srow.long(), tail])
    return torch.where(br == q_iota, srow_ext[nat_id], big).int()


def _numeric_stage(a_flat, b_flat, launches, rows: int, sig_hi, sig_lo,
                   sig_off, groups: tuple, kernels: bool, nnz_pad: int,
                   num_c_nnz: int, compress: str = "scatter", g_tbl=None):
    """The whole numeric phase (products, K-sums, compress) on plan data;
    `compress` is the plan's compress mode, whose "scatter" is the
    bitmap-rank compress (the sigma rows cover C's num_c_nnz positions
    once each): the kernel where `kernels`, its plain twin elsewhere. Spans:
    the products (`spgemm.products`) and the compress
    (`spgemm.compress`)."""
    with span("spgemm.products"):
        c_rows = _numeric_products(a_flat, b_flat, launches, rows, kernels)
    with span("spgemm.compress"):
        if compress == "fold":
            return _compress_fold(c_rows, sig_hi, sig_lo, sig_off, g_tbl,
                                  nnz_pad)
        if compress == "mxu":
            return _compress_mxu(c_rows, sig_hi, sig_lo, sig_off, groups,
                                 nnz_pad, kernels)
        run = _bk.bitmap_compress if kernels else _bk.bitmap_compress_plain
        return run(c_rows, sig_hi, sig_lo, sig_off, nnz_pad, num_c_nnz)


# ---------------------------------------------------------------------------
# Shared orchestration: symbolic phases + numeric plan
# ---------------------------------------------------------------------------
class _ProductPlan:
    """Everything structure-dependent about one C = A @ B product.
    Value-independent: ops.product.PreparedProduct caches one per
    structure."""

    __slots__ = (
        "a", "b", "a_flat", "b_flat", "keys_tbl",
        "starts_sig", "cnt_sig", "ends_sig", "groups",
        "tas", "tbs", "sig_st", "sig_sigma",
        "win", "win_starts", "jmax", "g_tbl", "compress_mode",
        "pwin", "pws", "nba_pad", "nbb_pad", "launches", "rows",
        "num_tasks", "num_alive", "num_c_blocks", "num_c_nnz",
        "nbc_pad", "nb_pad_c", "nnz_pad", "a_idx", "b_idx", "c_seg",
        "cbrow", "cbcol", "c_off", "c_hi", "c_lo",
    )


def _plan_fused(a, b, offs, b_row_start, total,
                t_pad: int, sentinel: int, nbc_pad: int):
    """T3..T9 on the operands' device, ending in one packed int64 packet
    so that the host needs one fetch for every data-dependent static."""
    a_idx, b_idx, ck_row, ck_col, t_ph, t_pl, nz_total = _build_tasks(
        a, b, offs, b_row_start, total, t_pad, sentinel)
    c_seg, keys_tbl, nbc, nnzc = _c_symbolic_scan(
        t_ph, t_pl, ck_row, ck_col, sentinel, a_idx, b_idx)
    (starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk, chunk_stats,
     nat_cols, sig_cols) = _plan_sell_device(
        c_seg, nz_total, nbc, nbc_pad, keys_tbl)
    # compress-run stats: the longest run of blocks starting in one
    # 64-wide output row (jmax, kept for parity with the JAX packet)
    b_iota = torch.arange(nbc_pad, device=c_seg.device)
    validb = b_iota < nbc
    b_row = torch.where(validb, nat_cols[4] // 64, 2**30)
    newr = torch.cat([torch.ones(1, dtype=torch.bool, device=c_seg.device),
                      b_row[1:] != b_row[:-1]])
    run_start = torch.cummax(torch.where(newr, b_iota, 0), 0).values
    jmax = torch.where(validb, b_iota - run_start, 0).max() + 1
    head = torch.stack([nz_total, nbc, nnzc, jmax])
    packet = torch.cat([head, k_chunk, *chunk_stats])
    return (packet, keys_tbl, c_seg, a_idx, b_idx,
            starts_sig, cnt_sig, ends_sig, nat_cols, nat_of_sig, sig_cols)


# the JAX package's slab-window policy (rows = dense 64-slot tiles)
_WIN_TABLE_MIN_ROWS = 1 << 17
_WIN_MAX_ROWS = 1 << 18
_SELL_SLAB = 64
# the JAX package's gather-fold eligibility: short contributor runs only,
# and a packed-row table of at most this many rows
_FOLD_MAX_J = 16
_FOLD_MAX_ROWS = 196608


def _slab_chunks(ch: int, k: int) -> int:
    """Chunks per slab of a (ch, k)-shaped K-group (the JAX package's
    numeric scan partition, which its slab windows follow)."""
    if ch <= _SELL_SLAB or ch * k * 128 <= _SELL_SLAB * 128 * 8:
        return ch
    return max(1, min(_SELL_SLAB, (1 << 16) // max(k, 1)))


def _plan_windows(groups, amin_c, amax_c, bmin_c, bmax_c,
                  nb_a: int, nb_b: int, device: torch.device):
    """Per-group, per-slab windows of the JAX package's XLA slab-window
    gather, from the per-chunk operand spans (host numpy). The port runs
    those groups through numeric_sell on absolute indices; the plan keeps
    the windows so that it equals the JAX plan."""
    win = []
    win_starts = []
    for kg, c0, c1 in groups:
        ch = c1 - c0
        ch_pad = bucket_size(ch, minimum=1)
        slab = _slab_chunks(ch_pad, kg)
        nsl = -(-ch_pad // slab)
        sa = np.zeros((nsl,), np.int32)
        sb = np.zeros((nsl,), np.int32)
        span_a = 1
        span_b = 1
        for s in range(nsl):
            lo_c = c0 + s * slab
            hi_c = min(c0 + (s + 1) * slab, c1)
            if lo_c >= c1:
                continue
            a0 = int(amin_c[lo_c:hi_c].min())
            a1 = int(amax_c[lo_c:hi_c].max())
            b0 = int(bmin_c[lo_c:hi_c].min())
            b1 = int(bmax_c[lo_c:hi_c].max())
            if a1 >= a0:
                sa[s] = a0
                span_a = max(span_a, a1 - a0 + 1)
            if b1 >= b0:
                sb[s] = b0
                span_b = max(span_b, b1 - b0 + 1)
        wa = wb = 0
        if nb_a + 1 > _WIN_TABLE_MIN_ROWS:
            w = bucket_size(round_up(span_a, 512), minimum=512)
            if w <= min(_WIN_MAX_ROWS, (nb_a + 1) // 2):
                wa = int(w)
                sa = np.clip(sa, 0, max(nb_a + 1 - wa, 0))
        if nb_b + 1 > _WIN_TABLE_MIN_ROWS:
            w = bucket_size(round_up(span_b, 512), minimum=512)
            if w <= min(_WIN_MAX_ROWS, (nb_b + 1) // 2):
                wb = int(w)
                sb = np.clip(sb, 0, max(nb_b + 1 - wb, 0))
        win.append((wa, wb))
        win_starts.append((_to_device(sa, device), _to_device(sb, device)))
    return tuple(win), tuple(win_starts)


def _plan_pallas_windows(groups, amin_c, amax_c, bmin_c, bmax_c,
                         nb_a: int, nb_b: int, enable: bool = True,
                         itemsize: int = 4,
                         device: torch.device = torch.device("cpu")):
    """Per-group, per-8-chunk-tile operand windows for numeric_window
    (host numpy over the packet's per-chunk operand spans).

    The eligibility rules are the TPU kernel's, kept as they are so that
    both packages build the same plan: W <= W_MAX rows per side (pow2 per
    group and side), the VMEM budget, 128-aligned starts, the t-ladder
    (8, 4, 2, 1) and the kg == 1 guard against a TPU compiler crash. The
    CUDA kernel reads its windows from global memory, so it takes any
    window this planner accepts.

    Returns (pwin, pws, ws_host, nba_pad, nbb_pad): pwin[g] = (wa, wb, t,
    cap) or None; pws[g] = (wsa, wsb) per-tile int32 starts or None, on
    `device`; ws_host[g] the same starts as host arrays."""
    big = np.int64(2**30)
    nba_pad = max(round_up(nb_a + 1, 128), _wk.W_MAX)
    nbb_pad = max(round_up(nb_b + 1, 128), _wk.W_MAX)
    pwin: list = []
    pws: list = []
    ws_host: list = []
    for kg, c0, c1 in groups:
        ch = c1 - c0
        cap = bucket_size(ch, minimum=1)
        found = None
        for t in ((_wk.TILE_CHUNKS, 4, 2, 1) if enable else ()):
            if t > cap:
                continue
            ntiles = -(-cap // t)
            am = np.full((ntiles * t,), big)
            ax = np.full((ntiles * t,), np.int64(-1))
            bmn = np.full((ntiles * t,), big)
            bx = np.full((ntiles * t,), np.int64(-1))
            am[:ch] = amin_c[c0:c1]
            ax[:ch] = amax_c[c0:c1]
            bmn[:ch] = bmin_c[c0:c1]
            bx[:ch] = bmax_c[c0:c1]
            am_t = am.reshape(ntiles, t).min(1)
            ax_t = ax.reshape(ntiles, t).max(1)
            bm_t = bmn.reshape(ntiles, t).min(1)
            bx_t = bx.reshape(ntiles, t).max(1)
            real_a = ax_t >= 0
            real_b = bx_t >= 0
            aa_t = np.where(real_a, am_t, 0) // 128 * 128
            ab_t = np.where(real_b, bm_t, 0) // 128 * 128
            sp_a = int((ax_t - aa_t + 1)[real_a].max()) if real_a.any() \
                else 1
            sp_b = int((bx_t - ab_t + 1)[real_b].max()) if real_b.any() \
                else 1
            wa = 256
            while wa < sp_a:
                wa *= 2
            wb = 256
            while wb < sp_b:
                wb *= 2
            if wa > _wk.W_MAX or wb > _wk.W_MAX:
                continue
            if _wk.window_vmem_bytes(wa, wb, itemsize) > \
                    _wk._VMEM_WINDOW_BUDGET:
                continue
            if kg == 1 and wa + wb > 6144:
                continue
            wsa = np.clip(aa_t, 0, nba_pad - wa).astype(np.int32)
            wsb = np.clip(ab_t, 0, nbb_pad - wb).astype(np.int32)
            found = ((wa, wb, t, cap), (wsa, wsb))
            break
        pwin.append(None if found is None else found[0])
        ws_host.append(None if found is None else found[1])
        pws.append(None if found is None else tuple(
            _to_device(w, device) for w in found[1]))
    return tuple(pwin), tuple(pws), tuple(ws_host), nba_pad, nbb_pad


def _plan_product(a, b, a_prep, b_prep, timer, verbose,
                  winkernel: str | None = None) -> _ProductPlan:
    """T1-T9 with exactly two host syncs — the task total and the plan
    packet — plus host-side static planning on the packet. winkernel
    overrides config spgemm_winkernel ("off" for the multi-device plans,
    parallel/product.py, which derive their own slot tables)."""
    cfg = get_config()
    if cfg.spgemm_compress not in COMPRESS_MODES:
        raise ValueError(f"spgemm_compress must be one of {COMPRESS_MODES}, "
                         f"got {cfg.spgemm_compress!r}")
    p = _ProductPlan()
    p.a, p.b = a, b
    dev = a.device
    with timer.phase("T_1"):
        _, offs, b_row_start, total = _task_counts(a, b, b.block_rows)
        p.num_tasks = int(total)           # host sync 1 of 2 (ref :1095)
    sentinel = a.block_rows + 1
    t_pad = round_up(bucket_size(max(p.num_tasks, 1)), _SCAN_W)
    p.nbc_pad = round_up(t_pad, 128)
    p.a_flat = (a_prep.dense_flat if a_prep is not None
                else a.decompress_blocks_flat())
    p.b_flat = (b_prep.dense_flat if b_prep is not None
                else b.decompress_blocks_flat())

    with timer.phase("T_3"):
        (packet, keys_tbl, c_seg, a_idx, b_idx,
         starts_sig, cnt_sig, ends_sig, nat_cols, nat_of_sig,
         sig_cols) = _plan_fused(a, b, offs, b_row_start, total,
                                 t_pad, sentinel, p.nbc_pad)
    with timer.phase("T_6"):
        pkt = packet.cpu().numpy()         # host sync 2 of 2 (ref :1106)
    nchunk = p.nbc_pad // 128
    p.num_alive = int(pkt[0])
    p.num_c_blocks = int(pkt[1])
    p.num_c_nnz = int(pkt[2])
    p.jmax = int(pkt[3])
    kc = pkt[4:4 + nchunk]
    amin_c, amax_c, bmin_c, bmax_c = (
        pkt[4 + i * nchunk:4 + (i + 1) * nchunk] for i in range(1, 5))
    if verbose:
        print(f"Task list size: {p.num_tasks}")
        print(f"Bmp reduction: {p.num_tasks - p.num_alive}")

    p.a_idx, p.b_idx, p.c_seg, p.keys_tbl = a_idx, b_idx, c_seg, keys_tbl
    p.starts_sig, p.cnt_sig, p.ends_sig = starts_sig, cnt_sig, ends_sig
    p.sig_sigma = sig_cols
    p.nnz_pad = max(bucket_size(max(p.num_c_nnz, 1)), 1)

    with timer.phase("T_9"):
        p.groups = _contiguous_k_groups(kc)
        nb_a, nb_b = p.a_flat.shape[0], p.b_flat.shape[0]
        p.win, p.win_starts = _plan_windows(
            p.groups, amin_c, amax_c, bmin_c, bmax_c, nb_a, nb_b, dev)
        wk = winkernel or cfg.spgemm_winkernel
        if wk not in ("auto", "on", "off"):
            raise ValueError(f"unknown spgemm_winkernel {wk!r}")
        p.pwin, p.pws, ws_host, p.nba_pad, p.nbb_pad = _plan_pallas_windows(
            p.groups, amin_c, amax_c, bmin_c, bmax_c, nb_a, nb_b,
            enable=(
                (wk == "on" or (wk == "auto" and dev.type == "cuda"))
                and p.a_flat.dtype != torch.float64
                and p.b_flat.dtype != torch.float64),
            itemsize=p.a_flat.dtype.itemsize, device=dev)
        # compress plan: the gather-fold where contributor runs are short
        # and the packed-row table small, else the row scatter-add; the
        # segment compress when asked for ("mxu")
        r_rows = sum(bucket_size(c1 - c0, minimum=1) * 128
                     for _, c0, c1 in p.groups)
        t_rows_pad = max(-(-p.nnz_pad // 64), 1)
        use_fold = bool(
            cfg.spgemm_compress == "fold"
            and p.groups and 0 < p.jmax <= _FOLD_MAX_J
            and t_rows_pad * p.jmax <= max(4 * r_rows, 1)
            and r_rows <= _FOLD_MAX_ROWS)
        if cfg.spgemm_compress == "mxu" and p.groups:
            p.compress_mode = "mxu"
        else:
            p.compress_mode = "fold" if use_fold else "scatter"
        fold = None
        if use_fold:
            chunk_base = np.full((nchunk,), r_rows, np.int64)
            base = 0
            for _, c0, c1 in p.groups:
                chunk_base[c0:c1] = base + np.arange(c1 - c0) * 128
                base += bucket_size(c1 - c0, minimum=1) * 128
            fold = (nat_of_sig, _to_device(chunk_base, dev), p.jmax,
                    t_rows_pad)
        p.nb_pad_c = min(
            round_up(max(bucket_size(max(p.num_c_blocks, 1)), 128), 128),
            p.nbc_pad)
        (p.tas, p.tbs, p.sig_st, p.g_tbl, p.cbrow, p.cbcol, p.c_hi, p.c_lo,
         p.c_off) = _plan_stage2(
            keys_tbl, starts_sig, cnt_sig, sig_cols, nat_cols,
            p.num_c_blocks, p.num_c_nnz, p.pws, tuple(p.groups),
            sent_a=nb_a, sent_b=nb_b, nb_pad_c=p.nb_pad_c,
            block_rows_a=a.block_rows, pallas_win=p.pwin, fold=fold)
        p.launches, p.rows, p.tas, p.tbs = _product_launches(
            p.groups, p.pwin, p.pws, ws_host, p.tas, p.tbs, amin_c)
    return p


def _product_launches(groups, pwin, pws, ws_host, tas, tbs, amin_c):
    """The numeric phase's two launches: numeric_window over every group
    with a tile-window plan, numeric_sell over every other group, each a
    spgemm_kernel.GroupLaunch whose work table has one row per 128-block
    chunk. Both write one c_rows in the stacked layout: groups in order,
    bucket_size(ch) * 128 rows each (a window group's chunk slots past
    that are not listed, so they are neither computed nor written).

    Each table is ordered by the chunk's first A block (amin_c, per chunk
    of the plan, host numpy; a group's padding chunks last), so the chunks
    of the K-groups over the same block rows run side by side and share
    their operand tiles through L2 instead of each group re-reading them
    from device memory. ws_host[g] holds a windowed group's tile starts on
    the host (pws[g] on the device).

    Returns ((window, sell), rows, tas, tbs): a launch is None where no
    group is of its kind; rows is c_rows' row count; tas/tbs are the
    groups' slot tables as views into the launches' concatenated tables."""
    big = np.iinfo(np.int64).max
    kinds: dict = {}
    row0 = 0
    for g, (_, c0, c1) in enumerate(groups):
        n = bucket_size(c1 - c0, minimum=1)
        kinds.setdefault(pwin[g] is not None, []).append((g, row0, n))
        row0 += n * 128
    tas, tbs = list(tas), list(tbs)
    launches = {}
    for win, members in kinds.items():
        flat = []
        for tabs in (tas, tbs):
            parts = [tabs[g].reshape(-1, 128) for g, _, _ in members]
            flat.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        work, keys, parts = [], [], []
        base = 0
        for g, r0, n in members:
            kg, c0, c1 = groups[g]
            size = tas[g].numel() // 128
            tas[g] = flat[0][base:base + size].view(tas[g].shape)
            tbs[g] = flat[1][base:base + size].view(tbs[g].shape)
            j = np.arange(n)
            if win:
                t = pwin[g][2]
                slot = base + j // t * kg * _wk.TILE_CHUNKS + j % t
                wsa, wsb = (np.asarray(w, np.int64)[j // t]
                            for w in ws_host[g])
                args = (tas[g], tbs[g], *pws[g], kg, t)
            else:
                slot = base + j * kg
                wsa = wsb = np.zeros(n, np.int64)
                args = (tas[g], tbs[g])
            work.append(np.stack([np.full(n, kg), slot, wsa, wsb,
                                  r0 // 128 + j], axis=1))
            key = np.full(n, big)
            key[:c1 - c0] = amin_c[c0:c1]
            keys.append(key)
            parts.append((r0, n * 128, args))
            base += size
        order = np.argsort(np.concatenate(keys), kind="stable")
        launches[win] = _sk.GroupLaunch(
            _to_device(np.concatenate(work)[order].astype(np.int32),
                       flat[0].device),
            flat[0], flat[1], max(groups[g][0] for g, _, _ in members),
            tuple(parts))
    return ((launches.get(True), launches.get(False)), row0, tuple(tas),
            tuple(tbs))


def _plan_stage2(keys_tbl, starts_sig, cnt_sig, sig_cols, nat_cols,
                 nbc: int, nnzc: int, pws, groups: tuple, sent_a: int,
                 sent_b: int, nb_pad_c: int, block_rows_a: int,
                 pallas_win: tuple = (), fold=None):
    """Everything the plan derives after the packet: the per-group slot
    tables, the stacked sigma compress columns, the gather-fold's
    contributor table g_tbl (fold = (nat_of_sig, chunk_base, j_max,
    t_rows_pad); without it a (1, 1) zero table, as in the JAX package)
    and the masked natural-order container fields.

    Groups with a tile-window plan get their slot tables window-relative
    in the kernel's (ntiles, K, 8, 128) layout; sentinels become
    _SENT_REL, and tiles with t < 8 real chunks pad with sentinel
    slots."""
    nbc_pad = starts_sig.shape[0]
    dev = keys_tbl.device
    if not pallas_win:
        pallas_win = (None,) * len(groups)
    sent_row = keys_tbl.new_full((1, 2), sent_a)
    sent_row[:, 1] = sent_b
    slot_tbl = torch.cat([keys_tbl[:, 6:8], sent_row])
    tas = []
    tbs = []
    sig_st = [[], [], []]
    for g, (kg, c0, c1) in enumerate(groups):
        ch = c1 - c0
        ch_pad = bucket_size(ch, minimum=1)
        ta, tb = _gather_group_slots(slot_tbl, starts_sig, cnt_sig, c0,
                                     ch_pad, kg)
        if pallas_win[g] is not None:
            _, _, t, _ = pallas_win[g]
            wsa, wsb = pws[g]
            ntiles = wsa.shape[0]

            def rel(tt, ws, sent):
                pad_ch = ntiles * t - ch_pad
                if pad_ch:
                    tt = torch.cat([tt, tt.new_full((pad_ch, kg, 128), sent)])
                tt = tt.reshape(ntiles, t, kg, 128)
                tt = torch.where(tt >= sent, _wk._SENT_REL,
                                 tt - ws[:, None, None, None])
                if t < _wk.TILE_CHUNKS:
                    tt = torch.cat([tt, tt.new_full(
                        (ntiles, _wk.TILE_CHUNKS - t, kg, 128),
                        _wk._SENT_REL)], dim=1)
                return tt.transpose(1, 2).contiguous()

            ta, tb = rel(ta, wsa, sent_a), rel(tb, wsb, sent_b)
        tas.append(ta)
        tbs.append(tb)
        lo_r = c0 * 128
        real = min(ch * 128, max(nbc_pad - lo_r, 0))
        for i in range(3):
            seg = sig_cols[i][lo_r:lo_r + real]
            if real < ch_pad * 128:
                seg = torch.cat([seg, seg.new_zeros(ch_pad * 128 - real)])
            sig_st[i].append(seg)
    sig_st_t = tuple(
        torch.cat(c) if c else torch.zeros(1, dtype=torch.int64, device=dev)
        for c in sig_st)
    if fold is not None:
        nat_of_sig, chunk_base, j_max, t_rows_pad = fold
        g_tbl = _compress_fold_plan(nat_cols[4], nat_of_sig, chunk_base, nbc,
                                    j_max, t_rows_pad)
    else:
        g_tbl = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    valid_b = torch.arange(nb_pad_c, device=dev) < nbc
    cbrow = torch.where(valid_b, nat_cols[0][:nb_pad_c], block_rows_a).int()
    cbcol = torch.where(valid_b, nat_cols[1][:nb_pad_c], 0).int()
    c_hi = torch.where(valid_b, nat_cols[2][:nb_pad_c], 0)
    c_lo = torch.where(valid_b, nat_cols[3][:nb_pad_c], 0)
    c_off = torch.where(valid_b, nat_cols[4][:nb_pad_c],
                        max(nnzc - 1, 0)).int()
    return (tuple(tas), tuple(tbs), sig_st_t, g_tbl,
            cbrow, cbcol, c_hi, c_lo, c_off)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------
def spgemm(a, b, impl: str | None = None,
           verbose: bool | None = None) -> BmSparse:
    """C = A @ B, host-orchestrated.

    A untransposed; B in either intra-block layout (transposed is the
    reference's and the fast one, ref: src/bmSparse_SPGEMM.cu:1261-1262).
    Operands may be BmSparse or Prepared (ops.plan.prepare), both on one
    device. fp32 output (f64 for f64 operands). For iterated products with
    fixed structure use ops.product.prepare_product.

    impl: "auto" | "cuda" | "plain" | "xla" | None (config default); see
    the module docstring. verbose prints the reference's phase labels.
    Span: the symbolic phase and the plan (`spgemm.plan`).
    """
    from .plan import Prepared, as_matrix

    a_prep = a if isinstance(a, Prepared) else None
    b_prep = b if isinstance(b, Prepared) else None
    a, b = as_matrix(a), as_matrix(b)
    _check_operands(a, b)
    cfg = get_config()
    impl = impl or cfg.spgemm_impl
    kernels = _use_kernels(impl, a.device,
                           torch.promote_types(a.dtype, b.dtype))
    verbose = cfg.verbose if verbose is None else verbose
    timer = PhaseTimer(enabled=verbose, device=a.device)

    with span("spgemm.plan"):
        p = _plan_product(a, b, a_prep, b_prep, timer, verbose)

    with timer.phase("T_9b"):
        c_values = (_numeric_xla_from_plan(p) if impl == "xla"
                    else _numeric_from_plan(p, kernels))
    timer.report()
    return _assemble_c(p, c_values)


def _numeric_from_plan(p: _ProductPlan, kernels: bool, a_flat=None,
                       b_flat=None):
    """Numeric phase + bit-order compress, given a structure plan (and
    optionally operand tiles with new values)."""
    a_flat = p.a_flat if a_flat is None else a_flat
    b_flat = p.b_flat if b_flat is None else b_flat
    if p.groups and p.num_c_blocks > 0:
        return _numeric_stage(
            a_flat, b_flat, p.launches, p.rows, *p.sig_st, tuple(p.groups),
            kernels, p.nnz_pad, p.num_c_nnz, compress=p.compress_mode,
            g_tbl=p.g_tbl)
    return torch.zeros(
        p.nnz_pad, dtype=torch.promote_types(a_flat.dtype, torch.float32),
        device=a_flat.device)


def _numeric_xla_from_plan(p: _ProductPlan):
    """impl="xla": the chunked numeric over the plan's alive tasks, into
    C's container fields."""
    if p.num_alive == 0:
        return torch.zeros(
            p.nnz_pad, dtype=torch.promote_types(p.a_flat.dtype,
                                                 torch.float32),
            device=p.a_flat.device)
    n = p.num_alive
    return _numeric_and_compress(
        p.a_flat, p.b_flat, p.a_idx[:n], p.b_idx[:n], p.c_seg[:n],
        p.c_hi, p.c_lo, p.c_off, p.nb_pad_c, p.nnz_pad)


def _assemble_c(p: _ProductPlan, c_values) -> BmSparse:
    return BmSparse(
        brow=p.cbrow, bcol=p.cbcol, bmp_hi=p.c_hi, bmp_lo=p.c_lo,
        offsets=p.c_off, values=c_values, nb=p.num_c_blocks,
        num_rows=p.a.num_rows, num_cols=p.b.num_cols, nnz=p.num_c_nnz,
        transposed=False)


def spgemm_padded(a: BmSparse, b: BmSparse, max_tasks: int,
                  max_c_blocks: int | None = None,
                  max_c_nnz: int | None = None) -> BmSparse:
    """C = A @ B with static upper bounds and no host sync.

    The result is padded: C.nb is the true block count (a 0-d tensor) and
    blocks past it have zero bitmaps; C.nnz is max_c_nnz. Tasks past
    max_tasks, blocks past max_c_blocks and values past max_c_nnz are cut,
    so the bounds must hold (parallel/spgemm.py::estimate_bounds gives
    safe ones). Runs the chunked numeric (_numeric_and_compress), plain
    torch on every device: the task-SELL kernels need the host planning of
    spgemm() and prepare_product().
    """
    _check_operands(a, b)
    max_c_blocks = max_c_blocks or max_tasks
    max_c_nnz = max_c_nnz or max_c_blocks * 64
    sentinel = a.block_rows + 1
    _, offs, b_row_start, total = _task_counts(a, b, b.block_rows)
    a_idx, b_idx, ck_row, ck_col, ph, pl, _ = _build_tasks(
        a, b, offs, b_row_start, total, max_tasks, sentinel)
    c_seg, cbrow, cbcol, c_hi, c_lo, c_off, nbc, _ = _c_symbolic(
        ph, pl, ck_row, ck_col, sentinel)
    k = min(max_c_blocks, max_tasks)
    c_values = _numeric_and_compress(
        a.decompress_blocks_flat(), b.decompress_blocks_flat(),
        a_idx, b_idx, c_seg, c_hi[:k], c_lo[:k], c_off[:k], k, max_c_nnz)
    return BmSparse(
        brow=cbrow[:k], bcol=cbcol[:k], bmp_hi=c_hi[:k], bmp_lo=c_lo[:k],
        offsets=c_off[:k], values=c_values, nb=nbc,
        num_rows=a.num_rows, num_cols=b.num_cols, nnz=max_c_nnz,
        transposed=False)
