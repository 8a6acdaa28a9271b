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
"""

from __future__ import annotations

import torch

from . import build


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


def numeric_sell(a_flat: torch.Tensor, b_flat: torch.Tensor,
                 ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """One K-group's products: launches csrc/spgemm_sell.cu for CUDA
    tensors; tensors on the CPU take `numeric_sell_plain`."""
    _check(a_flat, b_flat, ta, tb)
    if a_flat.device.type == "cpu":
        return numeric_sell_plain(a_flat, b_flat, ta, tb)
    if a_flat.device.type != "cuda":
        raise ValueError(f"numeric_sell: unsupported device {a_flat.device}")
    ch, kg, _ = ta.shape
    out = torch.empty((ch * 128, 64), dtype=torch.float32,
                      device=a_flat.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(a_flat.device):
        err = lib.bmsp_numeric_sell(
            a_flat.data_ptr(), b_flat.data_ptr(),
            int(a_flat.dtype == torch.bfloat16), a_flat.shape[0],
            b_flat.shape[0], ta.data_ptr(), tb.data_ptr(), ch, kg,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "numeric_sell launch")
    numeric_sell.launches += 1
    return out


numeric_sell.launches = 0
