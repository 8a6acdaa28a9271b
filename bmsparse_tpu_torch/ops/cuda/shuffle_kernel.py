"""The stream tier's kernels: the CUDA kernels (csrc/window_product.cu,
csrc/rowwise_gather.cu) and their plain torch versions. Counterpart of
``bmsparse_tpu/ops/pallas/shuffle_kernel.py``.

  window_product   products[r, l] = vals[r, l] * vtab[ws[r // TILE_R] + rel[r, l]]
                   (the tier's v gather: the sources of each TILE_R-row
                   tile lie in one w-scalar window of vtab starting at
                   ws[tile]; a rel outside [0, w) reads 0);
  rowwise_gather   out[r, g, l] = x[r, idx[r, g, l]], and 0 where idx is
                   outside [0, W) (the planner's sentinel is W): stages 2
                   and 3 of the tier's static routing network.

The TPU kernel of window_product also takes the per-tile panel ids and
next-panel starts (`pp`, `nxt`) for its double-buffered window fetch;
these kernels need neither, and the plan keeps them only for parity.
"""

from __future__ import annotations

import torch

from ..route import TILE_R
from . import build


def _check_device(name: str, ref: torch.Tensor, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on {ref.device} and "
                             f"{t.device}")
    if not all(t.is_contiguous() for t in (ref, *ts)):
        raise ValueError(f"{name} operands must be contiguous")


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    """The kernels read and write 16 bytes per thread."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} operands must be 16-byte aligned")


def _check_window(vals, rel, ws, vtab, w) -> None:
    if vals.dim() != 2 or vals.shape[1] != 128 or vals.shape[0] % TILE_R:
        raise ValueError(f"vals must be (R, 128) with R a multiple of "
                         f"{TILE_R}, got {tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if tuple(rel.shape) != tuple(vals.shape) or rel.dtype != torch.int32:
        raise ValueError(f"rel must be int32 {tuple(vals.shape)}, got "
                         f"{rel.dtype} {tuple(rel.shape)}")
    ntiles = vals.shape[0] // TILE_R
    if tuple(ws.shape) != (ntiles,) or ws.dtype != torch.int32:
        raise ValueError(f"ws must be int32 ({ntiles},), got {ws.dtype} "
                         f"{tuple(ws.shape)}")
    if vtab.dim() != 1 or vtab.dtype != torch.float32:
        raise TypeError(f"vtab must be a 1-D float32 vector, got "
                        f"{vtab.dtype} {tuple(vtab.shape)}")
    if w < 1 or w > vtab.shape[0]:
        raise ValueError(f"window width {w} outside [1, {vtab.shape[0]}]")
    _check_device("window_product", vals, rel, ws, vtab)


def window_product_plain(vals: torch.Tensor, rel: torch.Tensor,
                         ws: torch.Tensor, vtab: torch.Tensor,
                         w: int) -> torch.Tensor:
    """Plain torch version of `window_product`: a rel outside [0, w), or a
    window entry outside vtab, reads 0 (the planner builds neither)."""
    n = vtab.shape[0]
    tile = torch.arange(vals.shape[0], device=vals.device) // TILE_R
    r = rel.long()
    idx = ws.long()[tile][:, None] + r
    ok = (r >= 0) & (r < w) & (idx >= 0) & (idx < n)
    v = torch.where(ok, vtab[idx.clamp(0, max(n - 1, 0))], 0.0)
    return vals * v


def window_product(vals: torch.Tensor, rel: torch.Tensor, ws: torch.Tensor,
                   vtab: torch.Tensor, w: int) -> torch.Tensor:
    """The stream tier's v gather: launches csrc/window_product.cu for
    CUDA tensors; tensors on the CPU take `window_product_plain`."""
    _check_window(vals, rel, ws, vtab, w)
    if vals.device.type == "cpu":
        return window_product_plain(vals, rel, ws, vtab, w)
    if vals.device.type != "cuda":
        raise ValueError(f"window_product: unsupported device {vals.device}")
    out = torch.empty_like(vals)
    if out.numel() == 0:
        return out
    _check_aligned("window_product", vals, rel, out)
    lib = build.load()
    with torch.cuda.device(vals.device):
        err = lib.bmsp_window_product(
            vals.data_ptr(), rel.data_ptr(), ws.data_ptr(), vtab.data_ptr(),
            vtab.shape[0], vals.shape[0] // TILE_R, TILE_R, w,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "window_product launch")
    window_product.launches += 1
    return out


window_product.launches = 0


def _check_gather(x, idx, g_out) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a (R, W) float32 matrix, got {x.dtype} "
                        f"{tuple(x.shape)}")
    want = (x.shape[0], g_out, 128)
    if tuple(idx.shape) != want or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 {want}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    _check_device("rowwise_gather", x, idx)


def rowwise_gather_plain(x: torch.Tensor, idx: torch.Tensor,
                         g_out: int) -> torch.Tensor:
    """Plain torch version of `rowwise_gather`: one gather on x with a
    zero column appended."""
    r, w = x.shape
    x_ext = torch.cat([x, x.new_zeros((r, 1))], dim=1)
    ix = idx.long()
    ix = torch.where((ix >= 0) & (ix < w), ix, w)
    return x_ext.gather(1, ix.reshape(r, g_out * 128)).reshape(r, g_out, 128)


def rowwise_gather(x: torch.Tensor, idx: torch.Tensor,
                   g_out: int) -> torch.Tensor:
    """One stage of the stream tier's routing network: launches
    csrc/rowwise_gather.cu for CUDA tensors; tensors on the CPU take
    `rowwise_gather_plain`."""
    _check_gather(x, idx, g_out)
    if x.device.type == "cpu":
        return rowwise_gather_plain(x, idx, g_out)
    if x.device.type != "cuda":
        raise ValueError(f"rowwise_gather: unsupported device {x.device}")
    r, w = x.shape
    out = torch.empty((r, g_out, 128), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _check_aligned("rowwise_gather", idx, out)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.bmsp_rowwise_gather(
            x.data_ptr(), idx.data_ptr(), r, w, g_out, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rowwise_gather launch")
    rowwise_gather.launches += 1
    return out


rowwise_gather.launches = 0
