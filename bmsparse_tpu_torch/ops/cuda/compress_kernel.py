"""The SpGEMM segment compress: the CUDA kernel (csrc/segment_compress.cu)
and its plain torch version. Counterpart of
``bmsparse_tpu/ops/pallas/compress_kernel.py`` (``segment_compress_class``).

One sigma class's contribution to the (t_pad, 128) output:

    out[q] = sum of w[r] over the rows r with b_row[r] == q

w (R, 128) float32 holds the class's packed C rows (ops/spgemm._pack_rows)
and b_row (R,) int32 their output rows, non-decreasing as the planner
builds them; rows whose b_row lies outside [0, t_pad) drop out (the
planner pads with 2**30). The kernel relies on the order, the plain
version does not.
"""

from __future__ import annotations

import torch

from . import build

_T_PAD_MAX = 1 << 30   # b_row padding; output rows stay below it


def _check(w, b_row, t_pad) -> None:
    if w.dim() != 2 or w.shape[1] != 128 or w.dtype != torch.float32:
        raise TypeError(f"w must be a (R, 128) float32 matrix, got {w.dtype} "
                        f"{tuple(w.shape)}")
    if tuple(b_row.shape) != (w.shape[0],) or b_row.dtype != torch.int32:
        raise ValueError(f"b_row must be int32 ({w.shape[0]},), got "
                         f"{b_row.dtype} {tuple(b_row.shape)}")
    if not 0 <= t_pad < _T_PAD_MAX:
        raise ValueError(f"t_pad={t_pad} outside [0, 2**30)")
    if b_row.device != w.device:
        raise ValueError(f"w on {w.device} but b_row on {b_row.device}")
    if not (w.is_contiguous() and b_row.is_contiguous()):
        raise ValueError("segment_compress_class operands must be contiguous")


def segment_compress_class_plain(w: torch.Tensor, b_row: torch.Tensor,
                                 t_pad: int) -> torch.Tensor:
    """Plain torch version of `segment_compress_class`: index_add_ onto a
    dump row that takes the rows outside [0, t_pad)."""
    b = b_row.long()
    idx = torch.where((b >= 0) & (b < t_pad), b, t_pad)
    return w.new_zeros((t_pad + 1, 128)).index_add_(0, idx, w)[:t_pad]


def segment_compress_class(w: torch.Tensor, b_row: torch.Tensor,
                           t_pad: int) -> torch.Tensor:
    """The segment compress: launches csrc/segment_compress.cu for CUDA
    tensors; tensors on the CPU take `segment_compress_class_plain`."""
    _check(w, b_row, t_pad)
    if w.device.type == "cpu":
        return segment_compress_class_plain(w, b_row, t_pad)
    if w.device.type != "cuda":
        raise ValueError(f"segment_compress_class: unsupported device "
                         f"{w.device}")
    out = torch.empty((t_pad, 128), dtype=torch.float32, device=w.device)
    if t_pad == 0:
        return out
    if w.data_ptr() % 16:
        raise ValueError("segment_compress_class: w must be 16-byte aligned")
    lib = build.load()
    with torch.cuda.device(w.device):
        err = lib.bmsp_segment_compress(
            w.data_ptr(), b_row.data_ptr(), w.shape[0], t_pad, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "segment_compress_class launch")
    segment_compress_class.launches += 1
    return out


segment_compress_class.launches = 0
