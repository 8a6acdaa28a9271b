"""Task-SELL SpGEMM products: the CUDA kernel (csrc/spgemm_sell.cu) and its
plain torch version. Counterpart of
``bmsparse_tpu/ops/pallas/spgemm_kernel.py`` (``numeric_sell_pallas``),
with the operand gather (``_gather_kc`` there, an XLA take) fused in:

    c_rows[c*128 + l, i*8 + m] =
        sum_k sum_j A[ta[c, k, l], i*8 + j] * B[tb[c, k, l], j*8 + m]

A and B are the (nb, 64) row-major dense tiles of the operands
(``dense_flat``), float32 or bfloat16; an index outside [0, nb) — the
planner's sentinel is nb — reads a zero tile. The result is
(ch * 128, 64) float32 in sigma order.

The kernel runs a work table of chunks (`GroupLaunch`, one row per
128-block chunk) drawn from any number of K-groups, in the table's order,
into one output. `numeric_sell_groups` launches it once over all of a
product's groups (the table that ops/spgemm.py::_product_launches builds at
plan time); `numeric_sell` launches it over one group. Both add one to
`numeric_sell.launches` per launch. This module also holds what the window
kernel's wrapper shares: the launch record, its checks and the product's
plain twin (`groups_plain`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

WORK_COLS = 5     # kg, slot row, wsa, wsb, out chunk (csrc/spgemm_tiles.cuh)


class GroupLaunch(NamedTuple):
    """One kernel launch over the chunks of one or more K-groups.

    work     (n, WORK_COLS) int32, one row per 128-block chunk in launch
             order: [kg, slot row, wsa, wsb, out chunk]. Task k of the
             chunk reads row `slot row + k * stride` of the slot tables
             (stride 1 for numeric_sell, TILE_CHUNKS for numeric_window);
             wsa/wsb are the window starts (window kernel only); the
             chunk's C rows start at out chunk * 128.
    slots_a  (rows, 128) int32: the groups' slot tables, concatenated
    slots_b  the same for B
    max_kg   the deepest K of the table (sizes the kernel's slot staging)
    parts    per group, (row0, rows, args): rows [row0, row0 + rows) of
             the output are the first `rows` rows of the per-group
             wrapper's result on `args` (its arguments after the two
             operand tables). The plain twin computes exactly that.
    """
    work: torch.Tensor
    slots_a: torch.Tensor
    slots_b: torch.Tensor
    max_kg: int
    parts: tuple


def check_tables(a_flat: torch.Tensor, b_flat: torch.Tensor) -> None:
    for name, t in (("a_flat", a_flat), ("b_flat", b_flat)):
        if t.dim() != 2 or t.shape[1] != 64:
            raise ValueError(f"{name} must be (nb, 64), got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(
                f"{name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_flat.dtype != b_flat.dtype:
        raise TypeError(f"a_flat is {a_flat.dtype} but b_flat {b_flat.dtype}")
    if a_flat.device != b_flat.device:
        raise ValueError(f"a_flat on {a_flat.device} but b_flat on "
                         f"{b_flat.device}")


def check_slots(ref: torch.Tensor, shape: tuple, **tabs) -> None:
    """Each of `tabs` is a contiguous int32 tensor of `shape` on ref's
    device."""
    for name, t in tabs.items():
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be int32 {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device} but the tables on "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def products_plain(a_flat: torch.Tensor, b_flat: torch.Tensor,
                   ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """(n, K) absolute operand indices per C block -> (n, 64) C tiles:
    C[n] = sum_k A[ia[n, k]] @ B[ib[n, k]] as 8x8 blocks, indices outside
    [0, nb) reading zero. The sum is float32 (float64 for float64
    tables)."""
    cdt = torch.promote_types(torch.promote_types(a_flat.dtype, b_flat.dtype),
                              torch.float32)
    n, k = ia.shape

    def gather(tbl, idx):
        nb = tbl.shape[0]
        ext = torch.cat([tbl.to(cdt), tbl.new_zeros((1, 64), dtype=cdt)])
        idx = idx.long()
        return ext[torch.where((idx >= 0) & (idx < nb), idx, nb)]

    ga = gather(a_flat, ia).reshape(n, k, 8, 8)       # [., k, i, j]
    gb = gather(b_flat, ib).reshape(n, k, 8, 8)       # [., k, j, m]
    return torch.einsum("nkij,nkjm->nim", ga, gb).reshape(n, 64)


def _check(a_flat, b_flat, ta, tb) -> None:
    check_tables(a_flat, b_flat)
    if ta.dim() != 3 or ta.shape[2] != 128 or ta.shape[1] < 1:
        raise ValueError(f"ta must be (ch, K >= 1, 128), got {tuple(ta.shape)}")
    check_slots(a_flat, tuple(ta.shape), ta=ta, tb=tb)


def numeric_sell_plain(a_flat: torch.Tensor, b_flat: torch.Tensor,
                       ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `numeric_sell` (any float dtype)."""
    ch, k, _ = ta.shape

    def per_block(t):                     # (ch, K, 128) -> (ch*128, K)
        return t.permute(0, 2, 1).reshape(ch * 128, k)

    return products_plain(a_flat, b_flat, per_block(ta), per_block(tb))


def sell_launch(ta: torch.Tensor, tb: torch.Tensor) -> GroupLaunch:
    """The one-group launch of (ch, K, 128) slot tables, chunks in order;
    built on their device without a host copy."""
    ch, kg, _ = ta.shape
    j = torch.arange(ch, dtype=torch.int32, device=ta.device)
    zero = torch.zeros_like(j)
    work = torch.stack([torch.full_like(j, kg), j * kg, zero, zero, j], dim=1)
    return GroupLaunch(work, ta.view(-1, 128), tb.view(-1, 128), kg,
                       ((0, ch * 128, (ta, tb)),))


def check_launch(a_flat: torch.Tensor, b_flat: torch.Tensor,
                 launch: GroupLaunch, out: torch.Tensor) -> None:
    check_tables(a_flat, b_flat)
    n = launch.work.shape[0] if launch.work.dim() == 2 else -1
    check_slots(a_flat, (n, WORK_COLS), work=launch.work)
    if launch.slots_a.dim() != 2 or launch.slots_a.shape[1] != 128:
        raise ValueError(f"slots_a must be (rows, 128), got "
                         f"{tuple(launch.slots_a.shape)}")
    check_slots(a_flat, tuple(launch.slots_a.shape), slots_a=launch.slots_a,
                slots_b=launch.slots_b)
    if launch.max_kg < 1:
        raise ValueError(f"max_kg={launch.max_kg} below 1")
    if out.dim() != 2 or out.shape[1] != 64 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous (R, 64), got "
                         f"{tuple(out.shape)}")
    if out.device != a_flat.device:
        raise ValueError(f"out on {out.device} but the tables on "
                         f"{a_flat.device}")
    end = max((r0 + n for r0, n, _ in launch.parts), default=0)
    if end > out.shape[0]:
        raise ValueError(f"the groups fill {end} rows but out has "
                         f"{out.shape[0]}")


def groups_plain(plain, a_flat, b_flat, launch: GroupLaunch,
                 out: torch.Tensor) -> torch.Tensor:
    """The plain twin of a launch: each group's plain products, cut to
    the rows it keeps, at its row offset in out."""
    for row0, rows, args in launch.parts:
        out[row0:row0 + rows] = plain(a_flat, b_flat, *args)[:rows]
    return out


def run_launch(entry: str, a_flat: torch.Tensor, b_flat: torch.Tensor,
               launch: GroupLaunch, out: torch.Tensor) -> None:
    """Launch C entry `entry` over the work table into out (float32, on
    the tables' CUDA device); raises on a launch error."""
    if a_flat.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {a_flat.device}")
    if out.dtype != torch.float32:
        raise TypeError(f"out must be float32, got {out.dtype}")
    lib = build.load()
    with torch.cuda.device(a_flat.device):
        err = getattr(lib, entry)(
            a_flat.data_ptr(), b_flat.data_ptr(),
            int(a_flat.dtype == torch.bfloat16), a_flat.shape[0],
            b_flat.shape[0], launch.slots_a.data_ptr(),
            launch.slots_b.data_ptr(), launch.work.data_ptr(),
            launch.work.shape[0], launch.max_kg, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, f"{entry} launch")


def numeric_sell_groups_plain(a_flat, b_flat, launch: GroupLaunch,
                              out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `numeric_sell_groups` (any float dtype)."""
    return groups_plain(numeric_sell_plain, a_flat, b_flat, launch, out)


def numeric_sell_groups(a_flat, b_flat, launch: GroupLaunch,
                        out: torch.Tensor) -> torch.Tensor:
    """The products of every chunk of `launch` into out, in one launch of
    csrc/spgemm_sell.cu for CUDA tensors; tensors on the CPU take
    `numeric_sell_groups_plain`. Returns out."""
    check_launch(a_flat, b_flat, launch, out)
    if a_flat.device.type == "cpu":
        return numeric_sell_groups_plain(a_flat, b_flat, launch, out)
    if launch.work.shape[0]:
        run_launch("bmsp_numeric_sell", a_flat, b_flat, launch, out)
        numeric_sell.launches += 1
    return out


def numeric_sell(a_flat: torch.Tensor, b_flat: torch.Tensor,
                 ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """One K-group's products: csrc/spgemm_sell.cu over the group's
    one-group work table for CUDA tensors; tensors on the CPU take
    `numeric_sell_plain`."""
    _check(a_flat, b_flat, ta, tb)
    if a_flat.device.type == "cpu":
        return numeric_sell_plain(a_flat, b_flat, ta, tb)
    ch = ta.shape[0]
    out = torch.empty((ch * 128, 64), dtype=torch.float32,
                      device=a_flat.device)
    if out.numel() == 0:
        return out
    return numeric_sell_groups(a_flat, b_flat, sell_launch(ta, tb), out)


numeric_sell.launches = 0
