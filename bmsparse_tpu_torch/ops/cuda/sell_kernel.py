"""Windowed SELL-group SpMV: the CUDA kernel (csrc/sell_window.cu), its
plain torch version, the group's compact layout (`SellPack`, built once
per matrix by `pack_group`), and the planner's window helpers.
Counterpart of ``bmsparse_tpu/ops/pallas/sell_kernel.py``
(``sell_window_group``).

One K-group's contribution, (cap, 8, 128) float32:

    out[c, i, l] = sum_k sum_w dense[w, c, k, i, l] * v[(ws[c] + rel[c, k, l]) * cw + w]

with v read as 0 at or past n. Every chunk's slots lie in one window of
WINDOW_UNITS column units (cw scalars each) starting at ws[c], which the
planner (ops/plan.py) checks when it builds the window plan.

The slab `dense` holds cw * 8 coefficients per slot, most of them zero
(97.5% at road1M). The kernel reads the group from a SellPack instead:
each nonzero once, with its column relative to the chunk's window start
in 16 bits, laid out SELL-32 — slices of 32 output rows, each slice
padded to its longest row, rows sorted by length inside each 1024-row
chunk (sigma = 1024) with a 16-bit row map. Inside a slice the entries
of a row sit G to a group, G = 4 where the slice's length is a multiple
of 4, else 2 where it is even, else 1: entry j of slice row t lies at

    slice_off[s] + (j // G) * 32 * G + t * G + j % G

so that a warp reads G entries per thread with one vector load, the
warp's loads side by side.

The planning helpers below are copied unchanged from the JAX package, so
that both packages build the same plan; their VMEM budget describes the
TPU kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

# Window width in column units (one unit = cw scalars of v).
WINDOW_UNITS = 256
# Rows per pack slice (one warp) and per chunk (8 sublanes x 128 lanes).
SLICE = 32
CHUNK_ROWS = 8 * 128

# Per-chunk VMEM budget of the TPU kernel; k_slice and group_vmem_ok keep
# the plan's eligibility rules identical to the JAX package's.
_VMEM_BUDGET = 6 * 1024 * 1024


def ncu_padded(ncu: int) -> int:
    """Lane padding of the (cw, ncu) v table: at least one all-zero
    sentinel column past ncu and enough room that every window start in
    [0, ncu_pad - W] stays in bounds."""
    return max(WINDOW_UNITS, -(-(ncu + 1) // 128) * 128)


def k_slice(cw: int, kg: int, itemsize: int = 4) -> int:
    """Largest k-slice whose double-buffered blocks fit the VMEM budget
    (0 if even one slot per slice doesn't — cannot happen for cw <= 64).
    16-bit dense tiles (bf16) keep the k-slice even so every block's
    trailing (ks*8, 128) face stays a multiple of the packed-sublane
    tile."""
    win = 2 * cw * WINDOW_UNITS * 4
    per_k = 2 * (cw * 8 * 128 * itemsize + 128 * 4)  # dense + idx, 2 bufs
    ks = (_VMEM_BUDGET - win) // per_k
    ks = max(0, min(kg, ks))
    if itemsize < 4 and ks % 2:
        ks = ks - 1 if ks > 1 else (2 if kg >= 2 else 0)
    return ks


def group_vmem_ok(cw: int, kg: int, itemsize: int = 4) -> bool:
    """Whether the group gets a window plan at all (bf16 single-K groups
    stay on the gather path, as in the JAX package)."""
    if itemsize < 4 and kg < 2:
        return False
    return k_slice(cw, kg, itemsize) >= 1


@dataclasses.dataclass(frozen=True)
class SellPack:
    """One windowed K-group's nonzeros, SELL-32 (module docstring)."""

    vals: torch.Tensor       # (E,) plan dtype; padding entries 0
    cols: torch.Tensor       # (E,) int16 columns relative to ws[c] * cw
    slice_off: torch.Tensor  # (cap * 32 + 1,) int64 entry offsets
    rows: torch.Tensor       # (cap * 1024,) int16: chunk row of position p
    ws: torch.Tensor         # (cap,) int32 window starts in column units
    cw: int                  # window width of a column unit, in scalars
    nnz: int                 # nonzeros packed (entries less padding)

    TENSORS = ("vals", "cols", "slice_off", "rows", "ws")
    STATICS = ("cw", "nnz")

    @property
    def cap(self) -> int:
        return self.ws.shape[0]

    def to(self, device) -> "SellPack":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.TENSORS})

    def astype(self, dtype: torch.dtype) -> "SellPack":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self.TENSORS)

    def state(self) -> dict:
        """Its fields by name (what io/binary.py stores)."""
        return {f: getattr(self, f) for f in self.TENSORS + self.STATICS}


def pack_group(dense_g: torch.Tensor, rel_g: torch.Tensor,
               ws_g: torch.Tensor) -> SellPack:
    """The SellPack of one windowed group from its slab dense_g (cw, cap,
    kg, 8, 128), rel_g (cap, kg, 128) and ws_g (cap,), on the host (host
    numpy; the pack lands on dense_g's device). Every coefficient whose
    bits are not zero is packed, so the pack expands back to the slab
    bit for bit."""
    if dense_g.dim() != 5 or dense_g.shape[3:] != (8, 128):
        raise ValueError(
            f"dense_g must be (cw, cap, kg, 8, 128), got {tuple(dense_g.shape)}")
    cw, cap = dense_g.shape[:2]
    if WINDOW_UNITS * cw > 1 << 15:
        raise ValueError(f"cw={cw}: window-relative columns exceed 16 bits")
    d = dense_g.detach().cpu().contiguous()
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    w, c, k, i, lane = np.nonzero(
        d.view(ibits[d.element_size()]).numpy())
    rel = rel_g.cpu().numpy().astype(np.int64)
    col = rel[c, k, lane] * cw + w
    row = (c * 8 + i) * 128 + lane                  # output row, (c, i, l)
    o = np.lexsort((col, row))
    row, col = row[o], col[o]
    vals = d[tuple(torch.from_numpy(x[o]) for x in (w, c, k, i, lane))]

    # sigma = 1024: rows sorted by length inside each chunk, longest first
    cnt = np.bincount(row, minlength=cap * CHUNK_ROWS).reshape(
        cap, CHUNK_ROWS)
    order = np.argsort(-cnt, axis=1, kind="stable")
    pos = np.empty_like(order)
    np.put_along_axis(pos, order, np.arange(CHUNK_ROWS)[None, :], axis=1)
    length = np.take_along_axis(cnt, order, axis=1).reshape(
        -1, SLICE).max(axis=1)                      # per slice
    g = np.where(length % 4 == 0, 4, np.where(length % 2 == 0, 2, 1))
    off = np.zeros(len(length) + 1, np.int64)
    off[1:] = np.cumsum(SLICE * length)

    j = np.arange(len(row)) - np.searchsorted(row, row)   # rank in row
    p = pos.reshape(-1)[row]                        # position in its chunk
    s = row // CHUNK_ROWS * (CHUNK_ROWS // SLICE) + p // SLICE
    t = p % SLICE
    e = torch.from_numpy(off[s] + j // g[s] * SLICE * g[s] + t * g[s]
                         + j % g[s])
    vals_p = torch.zeros(int(off[-1]), dtype=d.dtype)
    vals_p[e] = vals
    cols_p = torch.zeros(int(off[-1]), dtype=torch.int16)
    cols_p[e] = torch.from_numpy(col.astype(np.int16))
    return SellPack(
        vals=vals_p, cols=cols_p, slice_off=torch.from_numpy(off),
        rows=torch.from_numpy(order.reshape(-1).astype(np.int16)),
        ws=ws_g.detach().cpu().to(torch.int32).contiguous(),
        cw=int(cw), nnz=len(row),
    ).to(dense_g.device)


def _check(pack: SellPack, v: torch.Tensor, n: int) -> None:
    cap = pack.cap
    if pack.vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"pack values must be float32 or bfloat16, got {pack.vals.dtype}")
    want = {"vals": (pack.vals.dtype, None), "cols": (torch.int16, None),
            "slice_off": (torch.int64, (cap * SLICE + 1,)),
            "rows": (torch.int16, (cap * CHUNK_ROWS,)),
            "ws": (torch.int32, (cap,))}
    for f, (dt, shape) in want.items():
        t = getattr(pack, f)
        if t.dtype != dt or t.dim() != 1 or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"pack.{f} must be {dt} {shape or '(E,)'}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pack.cols.shape != pack.vals.shape:
        raise ValueError("pack.cols and pack.vals differ in length")
    if v.dim() != 1 or v.dtype != torch.float32:
        raise TypeError(f"v must be a 1-D float32 vector, got {v.dtype} "
                        f"{tuple(v.shape)}")
    if not 0 <= n <= v.shape[0]:
        raise ValueError(f"n={n} outside [0, {v.shape[0]}]")
    for t in (*(getattr(pack, f) for f in pack.TENSORS), v):
        if t.device != pack.vals.device:
            raise ValueError(f"pack on {pack.vals.device} but an operand "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError("sell_window operands must be contiguous")


def _entry_coords(pack: SellPack) -> tuple:
    """Each entry's output row, (c * 8 + i) * 128 + l of the group's
    (cap, 8, 128) output, and its global scalar column, padding entries
    included (on the pack's device)."""
    dev = pack.vals.device
    off = pack.slice_off
    length = (off[1:] - off[:-1]) // SLICE
    g = torch.where(length % 4 == 0, 4, torch.where(length % 2 == 0, 2, 1))
    s = torch.repeat_interleave(torch.arange(length.numel(), device=dev),
                                SLICE * length)
    t = (torch.arange(s.numel(), device=dev) - off[s]) // g[s] % SLICE
    chunk = s // (CHUNK_ROWS // SLICE)
    row = chunk * CHUNK_ROWS + pack.rows[s * SLICE + t].long()
    col = pack.ws[chunk].long() * pack.cw + pack.cols.long()
    return row, col


def pack_entries(pack: SellPack) -> tuple:
    """The nonzeros that pack_group packed, as (row, col, vals): output
    rows as in `_entry_coords`, global scalar columns, values; the
    padding entries (zero bits) are left out."""
    row, col = _entry_coords(pack)
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    keep = pack.vals.view(ibits[pack.vals.element_size()]) != 0
    return row[keep], col[keep], pack.vals[keep]


def sell_window_plain(pack: SellPack, v: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain torch version of `sell_window` (the sum is float32, or
    float64 for float64 values): every entry of the pack, padding
    included, added to its row."""
    cdt = torch.promote_types(pack.vals.dtype, torch.float32)
    dev = pack.vals.device
    row, col = _entry_coords(pack)
    x = torch.where(col < n, v[col.clamp(max=max(n - 1, 0))],
                    torch.zeros((), dtype=v.dtype, device=dev))
    out = torch.zeros(pack.cap * CHUNK_ROWS, dtype=cdt, device=dev)
    out.index_add_(0, row, pack.vals.to(cdt) * x.to(cdt))
    return out.reshape(pack.cap, 8, 128)


def sell_window(pack: SellPack, v: torch.Tensor, n: int) -> torch.Tensor:
    """The windowed SELL kernel: launches csrc/sell_window.cu for CUDA
    tensors; tensors on the CPU take `sell_window_plain`."""
    _check(pack, v, n)
    dev = pack.vals.device
    if dev.type == "cpu":
        return sell_window_plain(pack, v, n)
    if dev.type != "cuda":
        raise ValueError(f"sell_window: unsupported device {dev}")
    if pack.vals.data_ptr() % 16 or pack.cols.data_ptr() % 8:
        raise ValueError("sell_window: pack.vals must be 16-byte and "
                         "pack.cols 8-byte aligned (vector loads)")
    lib = build.load()
    out = torch.empty((pack.cap, 8, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bmsp_sell_window(
            pack.vals.data_ptr(), int(pack.vals.dtype == torch.bfloat16),
            pack.cols.data_ptr(), pack.slice_off.data_ptr(),
            pack.rows.data_ptr(), pack.ws.data_ptr(), v.data_ptr(),
            pack.cap, pack.cw, n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sell_window launch")
    sell_window.launches += 1
    return out


sell_window.launches = 0
