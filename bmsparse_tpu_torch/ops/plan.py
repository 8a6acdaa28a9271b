"""Execution plans: the per-matrix tiered SpMV layout.

Counterpart of ``bmsparse_tpu/ops/plan.py``. `prepare()` is host numpy,
ported nearly verbatim so that its arrays equal the JAX package's: it
moves all data-dependent addressing into a one-time build, and moves the
finished tensors to the device once.

Tier 1 — DIA: diagonals whose fill fraction reaches `DIA_MIN_FILL` are
  extracted into a dense (ndiags, R, 128) strip; their SpMV contribution
  is ndiags shifted multiply-adds (csrc/dia_spmv.cu).

Tier 2 — SELL (sliced-ELL over slots of 8 rows x cw columns, C = 128
  lanes): the remaining slots are organized with the block-row index on
  the 128-lane axis. Block rows are sorted by slot count (SELL-sigma),
  grouped into chunks of 128 rows, and each chunk padded to its K class.
  These are the JAX package's routing decisions; its plan holds each
  group as a dense slab of cw * 8 coefficients per slot, which the port
  builds only on the host, for a group with a window plan, and only to
  cut that group's pack. Groups whose chunks each fit one
  WINDOW_UNITS-wide column window get a compact pack of their nonzeros
  (sell_pack) for the windowed kernel (csrc/sell_window.cu); the others
  are packed together, each nonzero once (sell_gpack), for the gathered
  groups' kernel (csrc/sell_gather.cu).

Overflow — a mini-SELL of each row's far outlier slots, so that a few
  long links do not keep their chunk out of the windowed kernel; its
  groups are packed as the gathered ones are (ovf_gpack).

Stream — scattered structures (web graphs, uniform random matrices): the
  rows with at most K_CAP entries go to the stream tier (ops/route.py,
  csrc/window_product.cu and csrc/rowwise_gather.cu) when its cost model
  says it clearly beats the block tiers, or always under stream="force".

Plans persist on disk through io/binary.py (save_prepared, load_prepared).
The multi-device options of prepare() (`force_layout`, `col_shift`) build
one shard's plan with the static structure that parallel/plan.py unifies
across shards; such plans keep the fixed K ladder, have no windowed
groups and no stream tier, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..config import BLOCK_HEIGHT
from ..format.bmsparse import BmSparse, cdiv
from ..utils.timing import span
from . import route
from .cuda import sell_kernel as _sk
from .cuda.sell_gather_kernel import GatherPack, gather_pack

# The port's own stamp on plan dumps (io/binary.save_prepared): a dump
# loads only under the stamp it was written with. Bump it whenever a
# field of Prepared or StreamPlan changes. It starts at the JAX package's
# layout 10, whose arrays the port's plans equal array for array; 11
# adds the windowed groups' packs (sell_pack), 12 the gathered groups'
# (sell_gpack, ovf_gpack); 13 drops the JAX package's dense slabs and
# their column and window arrays, which no SpMV read any more, for the
# groups' chunk counts (sell_chunks, ovf_chunks).
PLAN_LAYOUT_VERSION = 13

SELL_C = 128                 # lanes per chunk
DIA_MIN_FILL = 0.15          # min diagonal fill to justify a dense pass
MAX_DIAGS = 128              # cap on extracted diagonals
_K_BUCKETS = tuple(
    sorted({1, 2, 3} | {m for b in range(2, 16) for m in ((1 << b), 3 << (b - 1))})
)
MAX_SELL_GROUPS = 12     # cap on adaptive per-matrix K classes
STREAM_MODES = ("auto", "force", "off")
# Per-slot cost of the block tiers' v gather beyond its bytes: seconds per
# index of a torch gather of 8-scalar v segments, 2**22 indices
# (chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
# records the run). The bytes are priced at route.BW. Read at call time.
G_NS = 5.8e-11


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if b >= k:
            return b
    return k


def _adaptive_k_buckets(chunk_max: np.ndarray) -> np.ndarray:
    """Per-chunk padded depths from an optimal bucket set fitted to this
    matrix's chunk-max histogram (<= MAX_SELL_GROUPS distinct values): a
    partition DP over the distinct maxima picks the padded-slot-minimizing
    bucket values; matrices with few distinct depths get their exact
    values back. Never worse than the fixed geometric ladder."""
    uniq, inv, wts = np.unique(
        chunk_max, return_inverse=True, return_counts=True)
    m_u = len(uniq)
    if m_u <= MAX_SELL_GROUPS:
        return chunk_max.copy()
    if m_u > 512:
        # bound the DP: pre-quantize the histogram to the geometric ladder
        ladder_u = np.array([_bucket_k(int(v)) for v in uniq], np.int64)
        uniq2, inv2 = np.unique(ladder_u, return_inverse=True)
        wts = np.bincount(inv2, weights=wts).astype(np.int64)
        inv = inv2[inv]
        uniq = uniq2
        m_u = len(uniq)
    # weighted suffix-partition DP: cost(i..j) = uniq[j] * sum(w[i..j])
    G = MAX_SELL_GROUPS
    wcum = np.concatenate([[0], np.cumsum(wts)])
    INF = float("inf")
    f = np.full((m_u + 1, G + 1), INF)
    arg = np.zeros((m_u + 1, G + 1), np.int64)
    f[0, 0] = 0.0
    for j in range(1, m_u + 1):
        for g in range(1, min(G, j) + 1):
            # last bucket covers uniq[i..j-1], padded to uniq[j-1]
            costs = f[:j, g - 1] + int(uniq[j - 1]) * (
                wcum[j] - wcum[:j])
            i_best = int(np.argmin(costs))
            f[j, g] = costs[i_best]
            arg[j, g] = i_best
    g_best = int(np.argmin(f[m_u, 1:])) + 1
    cuts = []
    j = m_u
    g = g_best
    while j > 0:
        cuts.append(j - 1)              # bucket value index uniq[j-1]
        j = int(arg[j, g])
        g -= 1
    bucket_vals = uniq[np.array(sorted(cuts))]
    pad_to = bucket_vals[np.searchsorted(bucket_vals, uniq)]
    dp_pad = pad_to[inv]
    ladder_pad = np.array(
        [_bucket_k(int(k)) for k in chunk_max], np.int64)
    if dp_pad.sum() > ladder_pad.sum():
        return ladder_pad
    return dp_pad


@dataclasses.dataclass(frozen=True)
class Prepared:
    """A BmSparse plus its tiered execution plan."""

    m: BmSparse
    plan_dtype: str = "float32"
    # (nb_pad, 64) row-major dense slots in the plan dtype, made on first
    # SpGEMM use (the dense_flat property) and kept
    dense_flat_: torch.Tensor | None = None

    # --- DIA tier (None disables) ---
    # dia[d, q, l] is the diagonal-d entry of scalar row q*128 + l.
    dia: torch.Tensor | None = None          # (nd, ceil(npad/128), 128)
    dia_offsets: tuple = ()

    # --- SELL tier: groups of 128-row chunks sharing padded depth K ---
    # group g: sell_chunks[g] chunks of 128 block rows, depth sell_ks[g];
    # the groups' rows are stacked in group order
    sell_ks: tuple = ()
    sell_chunks: tuple = ()
    # sell_pack[g]: the windowed group's nonzeros for the kernel
    # (ops/cuda/sell_kernel.SellPack), None where the group gathers
    sell_pack: tuple = ()
    # the nonzeros of every group without a pack, for the gathered groups'
    # kernel (ops/cuda/sell_gather_kernel.GatherPack), None where there is
    # no such group
    sell_gpack: GatherPack | None = None
    # block-row r's SELL output lives at stacked row out_gather[r]; rows
    # with no SELL slots point past the end (read as zero).
    out_gather: torch.Tensor | None = None   # (block_rows,) int32
    sell_rows: int = 0

    # --- Overflow tier: per-row outlier slots, every group gathered ---
    ovf_ks: tuple = ()
    ovf_chunks: tuple = ()
    ovf_gather: torch.Tensor | None = None   # (block_rows,) int32
    ovf_rows: int = 0
    ovf_gpack: GatherPack | None = None

    # --- Stream tier: the routing plan of the scattered rows (float32) ---
    stream: route.StreamPlan | None = None

    def to(self, device) -> "Prepared":
        """The same plan with every tensor on `device`."""
        def mv(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(mv(t) for t in x)
            return x.to(device)

        return dataclasses.replace(
            self, m=self.m.to(device), dense_flat_=None,
            stream=None if self.stream is None else self.stream.to(device),
            **{f: mv(getattr(self, f))
               for f in ("dia", "sell_pack", "sell_gpack", "out_gather",
                         "ovf_gather", "ovf_gpack")})

    @property
    def dense_flat(self) -> torch.Tensor:
        """(nb_pad, 64) dense row-major slots in the plan dtype, computed on
        first SpGEMM use and kept."""
        df = object.__getattribute__(self, "dense_flat_")
        if df is None:
            df = self.m.decompress_blocks_flat(getattr(torch, self.plan_dtype))
            object.__setattr__(self, "dense_flat_", df)
        return df

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "m"), name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype the plan is built in on the host. numpy has no
    bfloat16: bf16 tiers are built in float32 and rounded once at the end,
    which gives the same bits as rounding the (float32-exact) values
    directly."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _core_window_mask(
    ublocks: np.ndarray, ubr: np.ndarray, ubc: np.ndarray,
    w_row: int, ncu: int,
) -> np.ndarray:
    """Per-super-slot core/overflow mask: for every block row, keep the
    densest width-`w_row` (column units) window of its slots (core); slots
    outside are overflow. ublocks must be sorted (np.unique output)."""
    n = len(ubr)
    # slots of a row are ubc-ascending inside sorted ublocks, so the
    # window starting at slot i covers a contiguous run; its end is a
    # searchsorted on the combined key (clamped so it stays in-row)
    j_end = np.searchsorted(
        ublocks, ubr * np.int64(ncu) + np.minimum(ubc + w_row, ncu))
    cnt = j_end - np.arange(n)
    rows_u, row_start = np.unique(ubr, return_index=True)
    # densest window per row, earliest on ties: max of cnt*n + (n-1-i)
    scored = cnt.astype(np.int64) * n + (n - 1 - np.arange(n))
    best = np.maximum.reduceat(scored, row_start)
    best_i = n - 1 - (best % n)
    lo = ubc[best_i][np.searchsorted(rows_u, ubr)]
    return (ubc >= lo) & (ubc < lo + w_row)


def _build_sell_tier(
    ub_idx: np.ndarray,
    ubr: np.ndarray, ubc: np.ndarray,
    slot: np.ndarray, vals: np.ndarray, binv: np.ndarray,
    nbr: int, ncu: int, cw: int, dtype: torch.dtype,
    *,
    forced_groups=None,
    adaptive: bool = False,
    secondary_wlo: bool = False,
    win_ok: bool = False,
    elig_split: bool = False,
):
    """Build one SELL tier over the super-slots selected by ub_idx
    (sorted global indices into the ublocks arrays).

    forced_groups: (K, chunks) pairs in descending K; the chunks of depth
    K fill group K in chunk order and the rest is padding (a shard's plan
    in the layout parallel/plan.py unifies).

    elig_split: compute per-chunk window eligibility and split each K
    class into an eligible group (may get a window plan) and a remainder
    group (gathered).

    Returns (ks, chunks, packs, out_gather_np, rows_total, gpack): each
    group's depth and chunk count, the SellPack of each group with a
    window plan (None where the group gathers), the row map, and the
    GatherPack of the groups left without a window plan (None where
    there is none), built from the scalars' coordinates.
    """
    np_dtype = _host_dtype(dtype)
    itemsize = dtype.itemsize
    sel_ubr = ubr[ub_idx]
    sel_ubc = ubc[ub_idx]
    row_count = np.bincount(sel_ubr, minlength=nbr)
    nonempty = np.nonzero(row_count)[0]
    # SELL-sigma row order; see prepare() for the tie-break rationale
    if secondary_wlo:
        row_minbc = np.full((nbr,), np.int64(ncu))
        np.minimum.at(row_minbc, sel_ubr, sel_ubc)
        perm = nonempty[np.lexsort(
            (nonempty, row_minbc[nonempty], -row_count[nonempty])
        )]
    else:
        perm = nonempty[np.argsort(-row_count[nonempty], kind="stable")]
    row_pos = np.full((nbr,), -1, np.int64)
    row_pos[perm] = np.arange(len(perm))

    nchunks = cdiv(len(perm), SELL_C)
    counts_sorted = row_count[perm]
    cs_pad = np.zeros((nchunks * SELL_C,), np.int64)
    cs_pad[: len(perm)] = counts_sorted
    cm = cs_pad.reshape(nchunks, SELL_C).max(axis=1) if nchunks else \
        np.zeros((0,), np.int64)
    if forced_groups is None and adaptive:
        k_chunk = _adaptive_k_buckets(cm)
    else:
        k_chunk = np.array([_bucket_k(int(k)) for k in cm], np.int64)

    p = row_pos[sel_ubr]
    chunk = p // SELL_C
    lane = p % SELL_C
    # rank of the slot within its row (sel arrays are sorted by
    # (row, col) because ub_idx is ascending over sorted ublocks)
    krank = np.arange(len(sel_ubr)) - np.searchsorted(sel_ubr, sel_ubr)

    elig = np.zeros((nchunks,), bool)
    if elig_split and nchunks:
        cmin = np.full((nchunks,), np.int64(1) << 40)
        cmax = np.full((nchunks,), np.int64(-1))
        np.minimum.at(cmin, chunk, sel_ubc)
        np.maximum.at(cmax, chunk, sel_ubc)
        al = np.where(cmax < 0, 0, cmin) // 128 * 128
        elig = (cmax - al < _sk.WINDOW_UNITS) | (cmax < 0)

    if forced_groups is not None:
        kvals = [int(k) for k, _ in forced_groups]
        missing = sorted(set(int(k) for k in k_chunk) - set(kvals))
        if missing:
            raise ValueError(f"forced layout lacks K groups {missing} this "
                             "shard needs")
        group_of_chunk = np.array([kvals.index(int(k)) for k in k_chunk],
                                  np.int64)
        local_of_chunk = np.zeros((nchunks,), np.int64)
        seen: dict = {}
        for c in range(nchunks):
            g = int(group_of_chunk[c])
            local_of_chunk[c] = seen.get(g, 0)
            seen[g] = local_of_chunk[c] + 1
        for g, (k, cap) in enumerate(forced_groups):
            if seen.get(g, 0) > cap:
                raise ValueError(f"forced K={k} group holds {cap} chunks, "
                                 f"this shard needs {seen[g]}")
        groups = [(int(k), int(cap), False) for k, cap in forced_groups]
    else:
        # groups keyed (K desc, eligible-first); chunks keep their stable
        # order within a group
        gkey = [
            (-int(k), (0 if bool(e) else 1) if elig_split else 1)
            for k, e in zip(k_chunk, elig)
        ]
        uniq = sorted(set(gkey))
        gid_of = {kk: i for i, kk in enumerate(uniq)}
        group_of_chunk = np.array(
            [gid_of[kk] for kk in gkey], np.int64
        ) if nchunks else np.zeros((0,), np.int64)
        local_of_chunk = np.zeros((nchunks,), np.int64)
        caps = np.zeros((max(len(uniq), 1),), np.int64)
        for g in range(len(uniq)):
            sel_c = np.nonzero(group_of_chunk == g)[0]
            local_of_chunk[sel_c] = np.arange(len(sel_c))
            caps[g] = len(sel_c)
        groups = [
            (-uniq[g][0], int(caps[g]), uniq[g][1] == 0)
            for g in range(len(uniq))
        ]

    bases = np.cumsum([0] + [cap * SELL_C for _, cap, _ in groups])
    pack_l: list = []
    # the gathered groups' scalars: pack row, scalar column, value
    g_row: list = []
    g_col: list = []
    g_val: list = []
    g_rows: list = []
    for g, (kg, cap, gelig) in enumerate(groups):
        sel = group_of_chunk[chunk] == g if nchunks else np.zeros((0,), bool)
        ub_sel = np.nonzero(sel)[0]
        if len(ub_sel):
            cl = local_of_chunk[chunk[ub_sel]]
            kk = krank[ub_sel]
            ll = lane[ub_sel]
            # the scalars of the selected slots
            sel_all = np.zeros((len(ubr),), bool)
            sel_all[ub_idx[ub_sel]] = True
            s_sel = sel_all[binv]
            loc = np.searchsorted(ub_idx[ub_sel], binv[s_sel])
        pack = None
        want_win = win_ok and (gelig if elig_split else True)
        if want_win and len(ub_sel) and _sk.group_vmem_ok(
                cw, kg, itemsize):
            bcol_g = np.full((cap, kg, SELL_C), ncu, np.int32)
            bcol_g[cl, kk, ll] = sel_ubc[ub_sel]
            real = bcol_g != ncu                     # (cap, kg, 128)
            wmin = np.where(real, bcol_g, 2**30).min(axis=(1, 2))
            wmax = np.where(real, bcol_g, -1).max(axis=(1, 2))
            # 128-aligned starts; eligibility measured from the aligned
            # start (the JAX package's rule, kept so the plans agree)
            al = np.where(wmax < 0, 0, wmin) // 128 * 128
            if bool(((wmax - al < _sk.WINDOW_UNITS)
                     | (wmax < 0)).all()):
                ncu_pad = _sk.ncu_padded(ncu)
                ws = np.minimum(
                    al, ncu_pad - _sk.WINDOW_UNITS,
                ).astype(np.int32)
                rel = np.where(
                    real, bcol_g - ws[:, None, None], 0
                ).astype(np.int32)
                # the group's slab, [w, chunk, k, i, lane], lives only
                # until its pack is cut
                slab = np.zeros((cap, kg, cw * 8, SELL_C), np_dtype)
                slab[cl[loc], kk[loc], slot[s_sel], ll[loc]] = vals[s_sel]
                pack = _sk.pack_group(torch.from_numpy(np.ascontiguousarray(
                    slab.reshape(cap, kg, cw, 8, SELL_C)
                    .transpose(2, 0, 1, 3, 4)
                )).to(dtype), torch.from_numpy(rel), torch.from_numpy(ws))
                del slab
        pack_l.append(pack)
        if pack is None:
            roff = sum(len(x) for x in g_rows)
            g_rows.append(np.arange(bases[g] * 8, bases[g + 1] * 8))
            if len(ub_sel):
                g_row.append(roff + (cl[loc] * SELL_C + ll[loc]) * 8
                             + slot[s_sel] % 8)
                g_col.append(sel_ubc[ub_sel][loc] * cw + slot[s_sel] // 8)
                g_val.append(vals[s_sel])

    rows_total = int(bases[-1])
    gpack = None
    if g_rows:
        # the tier's zero row (out_gather's target of rows without slots)
        # is written with the gathered rows
        g_rows.append(np.arange(rows_total * 8, rows_total * 8 + 8))
        empty = np.zeros(0, np.int64)
        gpack = gather_pack(
            np.concatenate(g_row) if g_row else empty,
            np.concatenate(g_col) if g_col else empty,
            np.concatenate(g_val) if g_val else np.zeros(0, np_dtype),
            np.concatenate(g_rows), dtype)
    if nchunks:
        stacked_pos = (
            bases[group_of_chunk] + local_of_chunk * SELL_C
        )                                   # per chunk
        og = np.where(
            row_pos >= 0,
            stacked_pos[np.clip(row_pos // SELL_C, 0, nchunks - 1)]
            + row_pos % SELL_C,
            rows_total,
        ).astype(np.int32)
    else:
        og = np.full((nbr,), rows_total, np.int32)
    ks = [kg for kg, _, _ in groups]
    chunks = [cap for _, cap, _ in groups]
    return ks, chunks, pack_l, og, rows_total, gpack


def _choose_diagonals(
    rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int,
    col_shift: int = 0,
) -> np.ndarray:
    """Offsets of diagonals dense enough for the DIA tier. With col_shift
    (a shard's rows local, its columns global) offset o holds the entries
    (i, i + col_shift + o)."""
    if len(rows) == 0:
        return np.empty((0,), np.int64)
    dev = cols.astype(np.int64) - rows.astype(np.int64) - col_shift
    # offset histogram via bincount over the bounded range
    lo_b = int(dev.min())
    hist = np.bincount(dev - lo_b)
    offs = np.nonzero(hist)[0] + lo_b
    counts = hist[offs - lo_b]
    # diag o holds (i, i+col_shift+o) for
    # i in [max(0,-col_shift-o), min(n_rows, n_cols-col_shift-o))
    length = (np.minimum(n_rows, n_cols - col_shift - offs)
              - np.maximum(0, -col_shift - offs))
    fill = counts / np.maximum(length, 1)
    keep = offs[fill >= DIA_MIN_FILL]
    if len(keep) > MAX_DIAGS:
        order = np.argsort(fill[np.isin(offs, keep)])[::-1]
        keep = keep[order[:MAX_DIAGS]]
    return np.sort(keep)


def prepare(m: BmSparse, dtype: torch.dtype | None = None,
            sell_unit: int | None = None, stream: str = "auto",
            device=None, force_layout=None, col_shift: int = 0) -> Prepared:
    """Build the tiered execution plan (host numpy, once per matrix).

    dtype: storage dtype of the plan tiers; defaults to the matrix's own
    value dtype (bf16 matrices get bf16 tiers, f64 matrices f64 tiers).
    The sum is always promote(dtype, float32).

    sell_unit: SELL slot granularity in scalar columns (8 = one slot per
    8x8 block, 64 = super-slots merging a row's blocks that share a
    64-scalar column window). None = automatic (64 when the merge factor
    reaches 2x).

    stream: "auto" routes scattered structures to the stream tier when
    its cost model (route.stream_cost_estimate, the H100's constants)
    says it beats the block tiers by 2x; "force" routes every row with at
    most K_CAP entries there; "off" disables the tier. Float32 plans with
    automatic slot granularity only, as in the JAX package.

    device: where the finished plan lives; defaults to the matrix's.

    force_layout: optional (dia_offsets, groups), groups (K, chunks) pairs
    in descending K or None. Forces the plan's static structure:
    diagonals absent from the matrix get zero strips, groups get padding
    chunks, so the plans of a partitioned matrix's shards stack
    (parallel/plan.py).

    col_shift: subtracted from the column indices when scalars are
    assigned to diagonals: a shard keeps its columns global and its rows
    local, so diagonal offset o means v[row + col_shift + o].

    A plan with either option or a fixed sell_unit keeps the fixed K
    ladder and gathers every SELL group (no windowed group), and stream
    is ignored (no stream tier), as in the JAX package.

    The host seconds of its phases add up in utils.timing.kept under
    "plan.coo" (the matrix's coordinates), "plan.dia" (tier 1),
    "plan.stream" (the stream routing) and "plan.sell" (the SELL and
    overflow tiers and their packs).
    """
    if isinstance(m, Prepared):
        return m
    if stream not in STREAM_MODES:
        raise ValueError(f"stream must be one of {STREAM_MODES}, got "
                         f"{stream!r}")
    if dtype is None:
        dtype = m.dtype if m.dtype.is_floating_point else torch.float32
    if not dtype.is_floating_point:
        raise TypeError(f"plan dtype must be a float dtype, got {dtype}")
    device = m.device if device is None else torch.device(device)
    np_dtype = _host_dtype(dtype)
    itemsize = dtype.itemsize

    with span("plan.coo", keep=True):
        rows, cols, vals = m.generate_coo(order="any")
        rows = rows.astype(np.int64)
        cols = cols.astype(np.int64)
        vals = vals.astype(np_dtype)
    nbr = m.block_rows
    nbc = m.block_cols
    npad = nbr * BLOCK_HEIGHT
    forced_dia, forced_groups = force_layout if force_layout else (None, None)

    with span("plan.dia", keep=True):
        # ---- Tier 1: extract dense diagonals --------------------------------
        dia = None
        dia_offsets: tuple = ()
        if len(rows) or forced_dia:
            if forced_dia is not None:
                offs = np.asarray(forced_dia, np.int64)
            else:
                offs = _choose_diagonals(rows, cols, m.num_rows, m.num_cols,
                                         col_shift)
            if len(offs):
                dev = cols - rows - col_shift
                on_dia = np.isin(dev, offs)
                by_off = np.argsort(offs, kind="stable")
                d_slot = by_off[np.searchsorted(offs[by_off], dev[on_dia])]
                r128 = cdiv(npad, 128)
                dia_np = np.zeros((len(offs), r128, 128), np_dtype)
                r_dia = rows[on_dia]
                dia_np[d_slot, r_dia // 128, r_dia % 128] = vals[on_dia]
                dia = torch.from_numpy(dia_np).to(dtype)
                dia_offsets = tuple(int(o) for o in offs)
                rows, cols, vals = rows[~on_dia], cols[~on_dia], vals[~on_dia]

    sell_ks: list = []
    sell_chunks: list = []
    sell_pack: list = []
    sell_gpack = None
    out_gather = None
    sell_rows = 0
    ovf_ks: list = []
    ovf_chunks: list = []
    ovf_gather = None
    ovf_rows = 0
    ovf_gpack = None
    with span("plan.stream", keep=True):
        # the single-device plan: automatic slot width, adaptive K classes,
        # window plans, overflow and stream tiers
        single = forced_groups is None and col_shift == 0 and sell_unit is None
        nblk = nwin = 0
        if single and len(rows):
            br0 = rows >> 3
            nblk = len(np.unique(br0 * np.int64(nbc) + (cols >> 3)))
            nwin = len(np.unique(br0 * np.int64(cdiv(nbc, 8)) + (cols >> 6)))

        # ---- Stream tier: scattered rows with at most K_CAP entries --------
        # Decided before the block sort, while the scalar arrays are aligned.
        # The block tiers pay a slab per slot plus one v-segment gather index;
        # the stream tier pays its tables' bytes (route.stream_cost_estimate).
        stream_plan = None
        if (single and dtype == torch.float32 and stream != "off"
                and len(rows) and (len(rows) >= 4096 or stream == "force")):
            stream_plan, heavy = _route_stream(
                rows, cols, vals, m, nblk, nwin, itemsize, np_dtype,
                force=stream == "force")
            if stream_plan is not None:
                rows, cols, vals = rows[heavy], cols[heavy], vals[heavy]

    with span("plan.sell", keep=True):
        # ---- Tier 2: SELL-C-128 over the remaining blocks -------------------
        # Slot granularity: when a block row's columns cluster, merging its
        # blocks into 64-scalar column-window super-slots (cw = 64) divides
        # the per-slot v reads by the merge factor; scattered structures keep
        # cw = 8, where the 8x denser coefficient slabs would cost more than
        # the reads they save (so do the few deep rows a stream plan leaves).
        cw = 8
        if sell_unit is not None:
            cw = int(sell_unit)
        elif single and len(rows) and stream_plan is None:
            if nblk >= 2 * nwin and nwin * 512 * itemsize <= (2 << 30):
                cw = 64

        if len(rows) or forced_groups:
            ncu = cdiv(m.num_cols, cw)      # column units (cw scalars each)
            br = rows >> 3
            bc = cols // cw
            # slot order (j, i): row j*8+i of the slab, so the sum over the
            # window's cw scalars runs over contiguous 8-row faces
            slot = (cols % cw) * 8 + (rows & 7)
            bid = br * ncu + bc
            order = np.argsort(bid, kind="stable")
            br, bc, slot, vals, bid = (
                x[order] for x in (br, bc, slot, vals, bid)
            )
            ublocks, binv = np.unique(bid, return_inverse=True)
            ubr = (ublocks // ncu).astype(np.int64)
            ubc = (ublocks % ncu).astype(np.int64)

            # Window eligibility: automatic slot width, f32/bf16/f16 plans.
            # The SELL-sigma order's secondary key is then the row's minimum
            # block column, so that equal-count rows cluster by column window
            # and per-chunk windows come out tight.
            win_ok = single and itemsize in (2, 4)

            # Core/overflow split: keep each row's densest column window in
            # the main tier; far outliers move to the overflow mini-SELL so
            # they cannot keep their chunk out of the windowed kernel.
            # Skipped when nothing overflows, or when >50% of slots would.
            core_idx = np.arange(len(ublocks))
            ovf_idx = None
            if win_ok and len(ublocks):
                core_mask = _core_window_mask(
                    ublocks, ubr, ubc, max(_sk.WINDOW_UNITS - 128, 1), ncu)
                n_ovf = int((~core_mask).sum())
                if 0 < n_ovf <= 0.5 * len(ublocks):
                    core_idx = np.nonzero(core_mask)[0]
                    ovf_idx = np.nonzero(~core_mask)[0]

            (sell_ks, sell_chunks, sell_pack, og, sell_rows,
             sell_gpack) = _build_sell_tier(
                core_idx, ubr, ubc, slot, vals, binv, nbr, ncu, cw, dtype,
                forced_groups=forced_groups, adaptive=single,
                secondary_wlo=single, win_ok=win_ok, elig_split=win_ok,
            )
            out_gather = torch.from_numpy(og)
            if ovf_idx is not None:
                (ovf_ks, ovf_chunks, _, og2, ovf_rows,
                 ovf_gpack) = _build_sell_tier(
                    ovf_idx, ubr, ubc, slot, vals, binv, nbr, ncu, cw, dtype,
                )
                ovf_gather = torch.from_numpy(og2)

    return Prepared(
        m=m, plan_dtype=_dtype_name(dtype),
        dia=dia, dia_offsets=dia_offsets,
        sell_ks=tuple(sell_ks), sell_chunks=tuple(sell_chunks),
        sell_pack=tuple(sell_pack), sell_gpack=sell_gpack,
        out_gather=out_gather, sell_rows=sell_rows,
        ovf_ks=tuple(ovf_ks), ovf_chunks=tuple(ovf_chunks),
        ovf_gather=ovf_gather, ovf_rows=ovf_rows,
        ovf_gpack=ovf_gpack, stream=stream_plan,
    ).to(device)


def _route_stream(rows, cols, vals, m: BmSparse, nblk: int, nwin: int,
                  itemsize: int, np_dtype, force: bool):
    """The stream-tier decision of prepare() (the JAX package's, with the
    H100's constants). Returns (plan, heavy): the stream plan of the rows
    with at most K_CAP entries and the mask of the scalars left to the
    block tiers, or (None, None) when the block tiers stay cheaper."""
    bw = route.BW
    est_block = min(nblk * (8 * 8 * itemsize / bw + G_NS),
                    nwin * (64 * 8 * itemsize / bw + G_NS))
    rcount = np.bincount(rows, minlength=m.num_rows)
    # the grid's depth is the deepest row under the cap: heavier rows stay
    # on the block tiers and are not billed here
    under = rcount[rcount <= route.K_CAP]
    k_est = int(under.max()) if len(under) else 1
    est_stream = route.stream_cost_estimate(len(rows), k_est, m.num_rows)
    # 2x margin: slack escalation can double the tables, and the block
    # estimate ignores the windowed kernel
    if not (force or 2 * est_stream < est_block):
        return None, None
    heavy = (rcount > route.K_CAP)[rows]
    args = (rows[~heavy], cols[~heavy], vals[~heavy], m.num_rows,
            m.num_cols, np_dtype)
    plan = route.build_stream_plan(*args)
    # stage-2 slack escalation by estimate: rebuild at s2 = 8 only when
    # the residue it would remove costs more than the larger tables
    added = (route.stream_cost_estimate(len(rows), k_est, m.num_rows, s2=8)
             - route.stream_cost_estimate(len(rows), k_est, m.num_rows))
    if int(plan.res_rows.shape[0]) * route.RES_NS > added:
        plan = route.build_stream_plan(*args, s2=8)
    return plan, heavy


def cast_prepared(p: Prepared, dtype: torch.dtype) -> Prepared:
    """Re-dtype a plan's value tiers on its device. The tiers are values
    cast element-wise and the index arrays do not depend on the dtype, so
    the result equals prepare(m, dtype) for float32-exact values. Window
    eligibility is re-checked for the target itemsize, as prepare would
    decide it; a group that keeps its window keeps its pack, values
    cast. The gathered groups' packs are cast too; where a group loses
    its window, its pack's entries join the tier's gathered pack."""
    if dtype == getattr(torch, p.plan_dtype):
        return p
    packs = tuple(
        pk.astype(dtype) if pk is not None and dtype.itemsize in (2, 4)
        and _sk.group_vmem_ok(pk.cw, kg, dtype.itemsize) else None
        for pk, kg in zip(p.sell_pack, p.sell_ks))
    lost = [g for g, (a, b) in enumerate(zip(p.sell_pack, packs))
            if a is not None and b is None]
    if lost:
        gpack = _gather_lost_windows(p, packs, lost, dtype)
    else:
        gpack = None if p.sell_gpack is None else p.sell_gpack.astype(dtype)
    return dataclasses.replace(
        p,
        dense_flat_=None,
        plan_dtype=_dtype_name(dtype),
        dia=None if p.dia is None else p.dia.to(dtype),
        sell_pack=packs,
        sell_gpack=gpack,
        ovf_gpack=None if p.ovf_gpack is None else p.ovf_gpack.astype(dtype),
    )


def _gather_lost_windows(p: Prepared, packs: tuple, lost: list,
                         dtype: torch.dtype) -> GatherPack:
    """The SELL tier's GatherPack in `dtype` once the groups `lost` have
    lost their window (packs: the tier's windowed packs after the cast):
    the entries of its gathered pack and of the lost groups' packs, on
    the tier's stacked scalar rows, packed again on the host."""
    bases = np.cumsum([0] + [c * SELL_C for c in p.sell_chunks])
    row_l, col_l, val_l = [], [], []
    if p.sell_gpack is not None:
        gk = p.sell_gpack
        row_l.append(gk.rows[gk.entry_rows()])
        col_l.append(gk.cols[:gk.nnz])
        val_l.append(gk.vals[:gk.nnz])
    for g in lost:
        # output row (c * 8 + i) * 128 + l is stacked scalar row
        # (base + c * 128 + l) * 8 + i
        r, col, val = _sk.pack_entries(p.sell_pack[g])
        c, i, lane = r // _sk.CHUNK_ROWS, r // SELL_C % 8, r % SELL_C
        row_l.append((int(bases[g]) + c * SELL_C + lane) * 8 + i)
        col_l.append(col)
        val_l.append(val)
    rows = np.concatenate(
        [np.arange(bases[g] * 8, bases[g + 1] * 8)
         for g, pk in enumerate(packs) if pk is None]
        + [np.arange(bases[-1] * 8, bases[-1] * 8 + 8)])
    stacked = torch.cat([x.long() for x in row_l]).cpu().numpy()
    return gather_pack(
        np.searchsorted(rows, stacked),
        torch.cat([x.long() for x in col_l]).cpu().numpy(),
        torch.cat([x.cpu() for x in val_l]), rows, dtype,
    ).to(p.out_gather.device)


def as_matrix(x) -> BmSparse:
    return x.m if isinstance(x, Prepared) else x


# Per-container plan memoization for spmv(m, v, impl="cuda") on a raw
# BmSparse: the host plan is built once per container, not per call.
# Keyed on container identity; weakrefs keep the cache from pinning dead
# matrices, and the referent is checked so a recycled id never aliases.
_PLAN_CACHE: dict = {}


def prepare_cached(m: BmSparse) -> Prepared:
    """prepare(m) with per-container-identity memoization (default
    arguments only)."""
    if isinstance(m, Prepared):
        return m
    key = id(m)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0]() is m:
        return hit[1]
    p = prepare(m)
    ref = weakref.ref(m, lambda _r, k=key: _PLAN_CACHE.pop(k, None))
    _PLAN_CACHE[key] = (ref, p)
    return p
