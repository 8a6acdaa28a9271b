"""Tile-window SpGEMM products: the CUDA kernel (csrc/spgemm_window.cu),
its plain torch version, and the planner's window constants. Counterpart
of ``bmsparse_tpu/ops/pallas/spgemm_window_kernel.py``
(``numeric_window_pallas``).

Slot tables are window-relative, in the (ntiles, K, 8, 128) layout the
planner stores (ops/spgemm.py::_plan_stage2): the operand of tile `tile`,
task k, chunk slot tt and lane l is block wsa[tile] + ra[tile, k, tt, l]
(likewise for B), _SENT_REL reads zero, and so does any block at or past
nb (on the TPU, the zero padding of its padded table). Of the 8 chunk
slots of a tile the first t_real are real; the result drops the rest:

    out[(tile*t_real + tt)*128 + l, i*8 + m] =
        sum_k sum_j A[wsa[tile] + ra[tile, k, tt, l], i*8 + j]
                    * B[wsb[tile] + rb[tile, k, tt, l], j*8 + m]

The kernel runs a work table of chunk slots (spgemm_kernel.GroupLaunch,
each row carrying its tile's window starts) drawn from any number of
K-groups, in the table's order, into one output.
`numeric_window_groups` launches it once over all of a product's
windowed groups; `numeric_window` over one group's tiles. Both add one to
`numeric_window.launches` per launch.

The constants below are the TPU kernel's, copied as they are so that both
packages accept the same windows; they describe VMEM, not Hopper, whose
kernel copies each task's two tiles from global memory.
"""

from __future__ import annotations

import torch

from . import build
from .spgemm_kernel import (
    GroupLaunch, check_launch, check_slots, check_tables, groups_plain,
    products_plain, run_launch,
)

TILE_CHUNKS = 8        # chunk slots per tile (t_real of them real)
W_MAX = 4096           # max window rows per side
_VMEM_WINDOW_BUDGET = 10 * 1024 * 1024   # both sides' double buffers
_SENT_REL = 1 << 24    # window-relative sentinel


def window_vmem_bytes(wa: int, wb: int, itemsize: int = 4) -> int:
    return 2 * 64 * (wa + wb) * itemsize


def _check(a_flat, b_flat, ra, rb, wsa, wsb, kg, t_real) -> None:
    check_tables(a_flat, b_flat)
    if ra.dim() != 4 or ra.shape[1:] != (kg, TILE_CHUNKS, 128) or kg < 1:
        raise ValueError(f"ra must be (ntiles, {kg}, {TILE_CHUNKS}, 128) "
                         f"with kg >= 1, got {tuple(ra.shape)}")
    if not 1 <= t_real <= TILE_CHUNKS:
        raise ValueError(f"t_real={t_real} outside [1, {TILE_CHUNKS}]")
    check_slots(a_flat, tuple(ra.shape), ra=ra, rb=rb)
    check_slots(a_flat, (ra.shape[0],), wsa=wsa, wsb=wsb)


def numeric_window_plain(a_flat, b_flat, ra, rb, wsa, wsb, kg: int,
                         t_real: int = TILE_CHUNKS) -> torch.Tensor:
    """Plain torch version of `numeric_window` (any float dtype)."""
    ntiles = ra.shape[0]

    def absolute(r, ws):                  # -> (ntiles*t_real*128, kg)
        r = r[:, :, :t_real, :].long()
        idx = torch.where(r == _SENT_REL, -1,
                          ws.long()[:, None, None, None] + r)
        return idx.permute(0, 2, 3, 1).reshape(ntiles * t_real * 128, kg)

    return products_plain(a_flat, b_flat, absolute(ra, wsa),
                          absolute(rb, wsb))


def window_launch(ra, rb, wsa, wsb, kg: int, t_real: int) -> GroupLaunch:
    """The one-group launch of (ntiles, K, 8, 128) window-relative tables:
    the t_real real chunk slots of each tile, in order; built on their
    device without a host copy."""
    ntiles = ra.shape[0]
    j = torch.arange(ntiles * t_real, device=ra.device)
    tile, tt = j // t_real, j % t_real
    work = torch.stack([torch.full_like(j, kg),
                        tile * kg * TILE_CHUNKS + tt,
                        wsa.long()[tile], wsb.long()[tile], j],
                       dim=1).int()
    return GroupLaunch(work, ra.view(-1, 128), rb.view(-1, 128), kg,
                       ((0, ntiles * t_real * 128,
                         (ra, rb, wsa, wsb, kg, t_real)),))


def numeric_window_groups_plain(a_flat, b_flat, launch: GroupLaunch,
                                out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `numeric_window_groups` (any float dtype)."""
    return groups_plain(numeric_window_plain, a_flat, b_flat, launch, out)


def numeric_window_groups(a_flat, b_flat, launch: GroupLaunch,
                          out: torch.Tensor) -> torch.Tensor:
    """The products of every chunk slot of `launch` into out, in one
    launch of csrc/spgemm_window.cu for CUDA tensors; tensors on the CPU
    take `numeric_window_groups_plain`. Returns out."""
    check_launch(a_flat, b_flat, launch, out)
    if a_flat.device.type == "cpu":
        return numeric_window_groups_plain(a_flat, b_flat, launch, out)
    if launch.work.shape[0]:
        run_launch("bmsp_numeric_window", a_flat, b_flat, launch, out)
        numeric_window.launches += 1
    return out


def numeric_window(a_flat, b_flat, ra, rb, wsa, wsb, kg: int,
                   t_real: int = TILE_CHUNKS) -> torch.Tensor:
    """One K-group's products through its tile windows:
    csrc/spgemm_window.cu over the group's one-group work table for CUDA
    tensors; tensors on the CPU take `numeric_window_plain`."""
    _check(a_flat, b_flat, ra, rb, wsa, wsb, kg, t_real)
    if a_flat.device.type == "cpu":
        return numeric_window_plain(a_flat, b_flat, ra, rb, wsa, wsb, kg,
                                    t_real)
    out = torch.empty((ra.shape[0] * t_real * 128, 64), dtype=torch.float32,
                      device=a_flat.device)
    if out.numel() == 0:
        return out
    return numeric_window_groups(
        a_flat, b_flat, window_launch(ra, rb, wsa, wsb, kg, t_real), out)


numeric_window.launches = 0
