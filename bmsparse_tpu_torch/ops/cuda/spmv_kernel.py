"""DIA-tier SpMV: the CUDA kernel (csrc/dia_spmv.cu) and its plain torch
version. Counterpart of ``bmsparse_tpu/ops/pallas/spmv_kernel.py``
(``dia_spmv_pallas``).

    u[e] = sum_d dia[d, e] * v[e + shift + offsets[d]]   for e < R * 128,

with v read as 0 outside [0, len(v)). `dia` keeps the JAX package's
(nd, R, 128) natural layout, the result is (R, 128) float32. The shift is
0 on one device; a shard of the multi-device path passes its column base
(parallel/spmv.py), which may lie past the end of v.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_DIAGS = 128


def _check(dia: torch.Tensor, v: torch.Tensor, offsets, shift: int) -> None:
    if dia.dim() != 3 or dia.shape[2] != 128:
        raise ValueError(f"dia must be (nd, R, 128), got {tuple(dia.shape)}")
    if dia.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dia must be float32 or bfloat16, got {dia.dtype}")
    if v.dim() != 1 or v.dtype != torch.float32:
        raise TypeError(f"v must be a 1-D float32 vector, got {v.dtype} "
                        f"{tuple(v.shape)}")
    if v.device != dia.device:
        raise ValueError(f"dia on {dia.device} but v on {v.device}")
    if not (dia.is_contiguous() and v.is_contiguous()):
        raise ValueError("dia and v must be contiguous")
    if len(offsets) != dia.shape[0] or len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} offsets for {dia.shape[0]} "
                         f"diagonals (at most {MAX_DIAGS})")
    if any(not -2**31 <= o < 2**31 for o in offsets):
        raise ValueError("offsets must fit int32")
    if not -2**62 <= shift < 2**62:
        raise ValueError(f"shift {shift} out of range")


def dia_spmv_plain(dia: torch.Tensor, v: torch.Tensor, offsets: tuple,
                   shift: int = 0) -> torch.Tensor:
    """Plain torch version of `dia_spmv` (any float dtype; the sum is in
    float32, or float64 for float64 inputs)."""
    nd, r_rows, _ = dia.shape
    cdt = torch.promote_types(dia.dtype, torch.float32)
    elems = r_rows * 128
    u = torch.zeros(elems, dtype=cdt, device=dia.device)
    if nd == 0:
        return u.reshape(r_rows, 128)
    # columns [base, top) hold every read; vx is that span of v with zeros
    # outside [0, len(v)), so diagonal d reads vx from shift + o - base
    base = shift + min(offsets)
    top = shift + max(offsets) + elems
    vx = torch.zeros(top - base, dtype=cdt, device=dia.device)
    a, b = max(base, 0), min(top, v.shape[0])
    if b > a:
        vx[a - base:b - base] = v[a:b]
    flat = dia.reshape(nd, elems)
    for d, o in enumerate(offsets):
        s = shift + o - base
        u += flat[d].to(cdt) * vx[s:s + elems]
    return u.reshape(r_rows, 128)


def dia_spmv(dia: torch.Tensor, v: torch.Tensor, offsets: tuple,
             shift: int = 0) -> torch.Tensor:
    """The DIA-tier kernel: launches csrc/dia_spmv.cu for CUDA tensors;
    tensors on the CPU take `dia_spmv_plain`."""
    offsets = tuple(int(o) for o in offsets)
    shift = int(shift)
    _check(dia, v, offsets, shift)
    if dia.device.type == "cpu":
        return dia_spmv_plain(dia, v, offsets, shift)
    if dia.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {dia.device}")
    lib = build.load()
    nd, r_rows, _ = dia.shape
    out = torch.empty((r_rows, 128), dtype=torch.float32, device=dia.device)
    offs = (ctypes.c_int * max(nd, 1))(*offsets)
    with torch.cuda.device(dia.device):
        err = lib.bmsp_dia_spmv(
            dia.data_ptr(), int(dia.dtype == torch.bfloat16), v.data_ptr(),
            offs, nd, r_rows * 128, v.shape[0], shift, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "dia_spmv launch")
    dia_spmv.launches += 1
    return out


dia_spmv.launches = 0
