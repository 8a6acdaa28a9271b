"""The SELL tiers' gathered groups: the CUDA kernel (csrc/sell_gather.cu),
its plain torch version, and the tier's compact layout (`GatherPack`,
built once per matrix by `gather_pack`).

A SELL K-group without a window plan gathers v per slot. Its rows are
scattered (Graph500's hubs, a road network's overflow links), so the
tier holds its nonzeros only, one pack per tier over all of its
gathered groups:

    out[rows[r]] = sum over the entries e of pack row r:
                   vals[e] * v[cols[e] - col_off]

with v read as 0 outside [0, n). col_off is the column of the whole
vector at which v starts: 0 on one device, a shard's window start in the
multi-device halo mode (parallel/spmv.py). Each entry holds its value
(plan dtype) and its global scalar column (int32); entries are sorted by
(pack row, column). A pack row is a scalar row of the tier's stacked
(rows, 8) layout, the layout that out_gather reads: every row of the
gathered groups, the tier's trailing zero row included, whether it has
entries or not. The entries of a pack row are cut into segments of at
most SEG_LEN entries: segment s holds entries [seg_off[s],
seg_off[s + 1]) and row r the segments [row_seg[r], row_seg[r + 1]), none
where it has no entries. vals and cols are padded with zeros to a
multiple of 4 entries, for the kernel's vector loads.

The JAX package computes these groups with XLA over dense slabs, not in
a Pallas kernel; this kernel replaces no TPU kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

# Entries per segment: the most one warp sums. Long rows (Graph500 hubs
# run to tens of thousands of entries) are cut into segments so that the
# work is balanced by entries, not by rows.
SEG_LEN = 1024
_VEC = 4                     # entries per vector load


@dataclasses.dataclass(frozen=True)
class GatherPack:
    """The nonzeros of a SELL tier's gathered groups (module docstring)."""

    vals: torch.Tensor       # (E,) plan dtype; E a multiple of 4, padding 0
    cols: torch.Tensor       # (E,) int32 global scalar columns
    seg_off: torch.Tensor    # (S + 1,) int64 entry offsets of the segments
    row_seg: torch.Tensor    # (R + 1,) int64 segment offsets of the rows
    rows: torch.Tensor       # (R,) int32 stacked scalar row of pack row r
    nnz: int                 # entries less padding

    TENSORS = ("vals", "cols", "seg_off", "row_seg", "rows")
    STATICS = ("nnz",)

    def to(self, device) -> "GatherPack":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.TENSORS})

    def astype(self, dtype: torch.dtype) -> "GatherPack":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def state(self) -> dict:
        """Its fields by name (what io/binary.py stores)."""
        return {f: getattr(self, f) for f in self.TENSORS + self.STATICS}

    def entry_rows(self) -> torch.Tensor:
        """The pack row of each entry but the padding."""
        dev = self.vals.device
        seg_row = torch.repeat_interleave(
            torch.arange(self.rows.shape[0], device=dev),
            torch.diff(self.row_seg))
        return torch.repeat_interleave(seg_row, torch.diff(self.seg_off))


def gather_pack(row: np.ndarray, col: np.ndarray, vals,
                rows: np.ndarray, dtype: torch.dtype) -> GatherPack:
    """The GatherPack of entries (row[e], col[e], vals[e]) on the host.

    row: each entry's pack row, an index into `rows` (the stacked scalar
    rows the pack writes); col: its global scalar column; vals: a numpy
    array or a CPU tensor, cast to `dtype`. Duplicate (row, column) pairs
    are not expected (a matrix's nonzeros)."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    nrows = len(rows)
    o = np.argsort(row * (int(col.max(initial=0)) + 1) + col)
    row, col = row[o], col[o]
    vals = torch.as_tensor(vals)[torch.from_numpy(o)].to(dtype)
    e = len(row)
    cnt = np.bincount(row, minlength=nrows)
    start = np.zeros(nrows + 1, np.int64)
    start[1:] = np.cumsum(cnt)
    nseg = -(-cnt // SEG_LEN)
    row_seg = np.zeros(nrows + 1, np.int64)
    row_seg[1:] = np.cumsum(nseg)
    seg_row = np.repeat(np.arange(nrows), nseg)
    j = np.arange(len(seg_row)) - row_seg[seg_row]
    seg_off = np.append(start[seg_row] + j * SEG_LEN, e)
    pad = -e % _VEC
    return GatherPack(
        vals=torch.cat([vals, torch.zeros(pad, dtype=dtype)]),
        cols=torch.from_numpy(np.append(col, np.zeros(pad, np.int64))
                              .astype(np.int32)),
        seg_off=torch.from_numpy(seg_off),
        row_seg=torch.from_numpy(row_seg),
        rows=torch.from_numpy(np.asarray(rows, np.int32)),
        nnz=e,
    )


def _check(pack: GatherPack, v: torch.Tensor, n: int,
           out: torch.Tensor) -> None:
    e, s, r = (pack.vals.shape[0], pack.seg_off.shape[0] - 1,
               pack.rows.shape[0])
    want = {"vals": (pack.vals.dtype, (e,)), "cols": (torch.int32, (e,)),
            "seg_off": (torch.int64, (s + 1,)),
            "row_seg": (torch.int64, (r + 1,)), "rows": (torch.int32, (r,))}
    for f, (dt, shape) in want.items():
        t = getattr(pack, f)
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"pack.{f} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if e % _VEC:
        raise ValueError(f"pack entries must be a multiple of {_VEC}, got {e}")
    if v.dim() != 1 or out.dim() != 1:
        raise ValueError("v and out must be 1-D")
    if not 0 <= n <= v.shape[0]:
        raise ValueError(f"n={n} outside [0, {v.shape[0]}]")
    for t in (*(getattr(pack, f) for f in pack.TENSORS), v, out):
        if t.device != pack.vals.device:
            raise ValueError(f"pack on {pack.vals.device} but an operand "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError("sell_gather operands must be contiguous")


def sell_gather_plain(pack: GatherPack, v: torch.Tensor, n: int,
                      out: torch.Tensor, col_off: int = 0) -> torch.Tensor:
    """Plain torch version of `sell_gather`: a gather, a multiply and an
    index_add_ (the sum in out's dtype)."""
    _check(pack, v, n, out)
    dev = pack.vals.device
    e = pack.nnz
    col = pack.cols[:e].long() - col_off
    x = torch.where((col >= 0) & (col < n), v[col.clamp(0, max(n - 1, 0))],
                    torch.zeros((), dtype=v.dtype, device=dev))
    acc = torch.zeros(pack.rows.shape[0], dtype=out.dtype, device=dev)
    acc.index_add_(0, pack.entry_rows(),
                   pack.vals[:e].to(out.dtype) * x.to(out.dtype))
    out[pack.rows.long()] = acc
    return out


def sell_gather(pack: GatherPack, v: torch.Tensor, n: int,
                out: torch.Tensor, col_off: int = 0) -> torch.Tensor:
    """The gathered groups' kernel: writes out[rows[r]] for every pack row
    r (module docstring) and leaves the rest of `out` as it was. CUDA
    tensors launch csrc/sell_gather.cu: two kernels, the segments' sums
    and the rows' (each launch adds one to `sell_gather.launches`); float32
    or bfloat16 values, float32 v and out. Tensors on the CPU take
    `sell_gather_plain`."""
    _check(pack, v, n, out)
    dev = pack.vals.device
    if dev.type == "cpu":
        return sell_gather_plain(pack, v, n, out, col_off)
    if dev.type != "cuda":
        raise ValueError(f"sell_gather: unsupported device {dev}")
    if pack.vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sell_gather: values must be float32 or bfloat16, "
                        f"got {pack.vals.dtype}")
    if v.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"sell_gather: v and out must be float32, got "
                        f"{v.dtype} and {out.dtype}")
    if pack.vals.data_ptr() % 16 or pack.cols.data_ptr() % 16:
        raise ValueError("sell_gather: pack.vals and pack.cols must be "
                         "16-byte aligned (vector loads)")
    nseg = pack.seg_off.shape[0] - 1
    nrows = pack.rows.shape[0]
    lib = build.load()
    partial = torch.empty(nseg, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bmsp_sell_gather(
            pack.vals.data_ptr(), int(pack.vals.dtype == torch.bfloat16),
            pack.cols.data_ptr(), pack.seg_off.data_ptr(), nseg,
            pack.row_seg.data_ptr(), pack.rows.data_ptr(), nrows,
            v.data_ptr(), n, col_off, partial.data_ptr(), out.data_ptr(),
            out.shape[0], torch.cuda.current_stream().cuda_stream)
    build.check(err, "sell_gather launch")
    sell_gather.launches += (nseg > 0) + (nrows > 0)
    return out


sell_gather.launches = 0
