"""Sparse matrix-vector multiply u = A @ v on BmSparse.

Counterpart of ``bmsparse_tpu/ops/spmv.py``. A Prepared plan
(ops/plan.py) runs the tiered path:

  DIA tier        -> dia_spmv      (csrc/dia_spmv.cu)
  SELL tier       -> sell_window   (csrc/sell_window.cu) on the packs of the
                     groups with a window plan; sell_gather
                     (csrc/sell_gather.cu) on the pack of the others
  overflow tier   -> sell_gather on the tier's pack
  row placement   -> torch gather through out_gather / ovf_gather
  stream tier     -> window_product + rowwise_gather (csrc/window_product.cu,
                     csrc/rowwise_gather.cu), transposes and the residue's
                     index_add_ in torch (ops/route.py::stream_apply)

The groups without a window plan and the overflow mini-SELL are computed
by XLA over dense slabs in the JAX package; here they read a pack of
their nonzeros (ops/cuda/sell_gather_kernel.py), on one device and on the
multi-device path (parallel/spmv.py) alike.

impl:
  "auto"  — the CUDA kernels for float32 and bfloat16 plans on a CUDA
            device, their plain torch versions for tensors on the CPU and
            for float64 plans (the kernels take float32 and bfloat16 only;
            the JAX package likewise runs its Pallas kernels for float32
            only and XLA otherwise);
  "cuda"  — the CUDA kernels; raises for tensors on the CPU and for
            float64 plans;
  "plain" — the plain torch versions everywhere (tests, and the
            comparison in chip_smoke.py).

A raw BmSparse under "auto"/"plain" runs `_spmv_xla` (decompress, per-block
matvec, row sum); impl="cuda" builds the tiered plan once per container
(ops.plan.prepare_cached).
"""

from __future__ import annotations

import torch

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH, get_config
from ..format.bmsparse import BmSparse
from ..utils.timing import span
from .cuda.sell_gather_kernel import sell_gather, sell_gather_plain
from .cuda.sell_kernel import sell_window, sell_window_plain
from .cuda.spmv_kernel import dia_spmv, dia_spmv_plain
from .plan import SELL_C, Prepared, prepare_cached
from .route import stream_apply

IMPLS = ("auto", "cuda", "plain")

# Blocks decompressed per step of the raw path; bounds the (chunk, 64)
# working set to a few MB regardless of matrix size.
_SPMV_CHUNK = 1 << 17


def _spmv_xla(m: BmSparse, v: torch.Tensor) -> torch.Tensor:
    """Raw-container SpMV (named after its JAX counterpart; plain torch):
    decompress each block, multiply by its v segment, sum per block row.
    Padding blocks carry the brow sentinel block_rows and drop out."""
    from ..format import bitmap as bm
    from ..format.blockops import block_matvec_flat

    nbr = m.block_rows
    n = m.block_cols * BLOCK_WIDTH
    acc = torch.promote_types(m.dtype, torch.float32)
    vpad = torch.zeros(n, dtype=acc, device=v.device)
    k = min(n, v.shape[0])
    vpad[:k] = v[:k]
    u = torch.zeros((nbr + 1, BLOCK_HEIGHT), dtype=acc, device=v.device)
    lane = torch.arange(BLOCK_WIDTH, device=v.device)
    for s in range(0, m.nb_pad, _SPMV_CHUNK):
        sl = slice(s, s + _SPMV_CHUNK)
        bits = bm.expand_bits(m.bmp_hi[sl], m.bmp_lo[sl])      # (c, 64)
        slot = bm.prefix_popcount(bits)
        idx = (m.offsets[sl].long()[:, None] + slot).clamp(
            0, max(m.nnz_pad - 1, 0))
        dense = torch.where(bits > 0, m.values[idx].to(acc),
                            torch.zeros((), dtype=acc, device=v.device))
        # storage is row-major (SpMV requires untransposed matrices)
        vseg = vpad[m.bcol[sl].long()[:, None] * BLOCK_WIDTH + lane]
        contrib = block_matvec_flat(dense, vseg, acc)            # (c, 8)
        # rows outside [0, nbr) drop out, as in JAX's segment_sum: the
        # padding blocks' sentinel, and negative rows where a shard's
        # padding rows were localized (parallel/spmv.py)
        brow = m.brow[sl].long()
        u.index_add_(0, torch.where((brow >= 0) & (brow < nbr), brow, nbr),
                     contrib)
    return u[:nbr].reshape(-1)[: m.num_rows].to(v.dtype)


def _spmv_prepared(p, v: torch.Tensor, impl: str) -> torch.Tensor:
    """Tiered SpMV on a Prepared plan (see ops/plan.py). Spans: the call
    (`spmv`), each tier's own call inside it (`spmv.dia`, `.sell`,
    `.overflow`, `.stream`); the fills, copies, adds and the cast around
    them are the call's own."""
    with span("spmv"):
        m = p.m
        cdt = torch.promote_types(getattr(torch, p.plan_dtype),
                                  torch.float32)
        kernels = _use_kernels(impl, v.device, cdt)
        if v.device != m.device:
            raise ValueError(f"plan on {m.device} but v on {v.device}")
        nbr = m.block_rows
        nbc = m.block_cols
        npad = nbr * BLOCK_HEIGHT
        n = nbc * BLOCK_WIDTH
        vpad = torch.zeros(n, dtype=cdt, device=v.device)
        k = min(n, v.shape[0])
        vpad[:k] = v[:k]

        u = torch.zeros(npad, dtype=cdt, device=v.device)
        if p.dia is not None:
            with span("spmv.dia"):
                u_t = dia_apply(p.dia, p.dia_offsets, vpad, kernel=kernels)
            u += u_t.reshape(-1)[:npad]
        if p.sell_ks:
            with span("spmv.sell"):
                u_t = sell_apply(p.sell_chunks, p.out_gather, vpad,
                                 packs=p.sell_pack, gpack=p.sell_gpack,
                                 kernel=kernels)
            u += u_t.reshape(npad)
        if p.ovf_ks:
            # per-row outlier slots: few and scattered by construction, so
            # every group reads the tier's gathered pack
            with span("spmv.overflow"):
                u_t = sell_apply(p.ovf_chunks, p.ovf_gather, vpad,
                                 gpack=p.ovf_gpack, kernel=kernels)
            u += u_t.reshape(npad)
        if p.stream is not None:
            with span("spmv.stream"):
                u_t = stream_apply(p.stream, vpad, kernels=kernels)
            u[: u_t.shape[0]] += u_t
        return u[: m.num_rows].to(v.dtype)


def _use_kernels(impl: str, device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a path launches the CUDA kernels for data of `dtype` on
    `device` (the rule of the module docstring, SpGEMM's too); raises
    where impl="cuda" cannot run."""
    cuda = device.type == "cuda"
    if impl == "cuda":
        if not cuda:
            raise ValueError("impl='cuda' needs tensors on a CUDA device")
        if dtype == torch.float64:
            raise NotImplementedError(
                "float64 has no CUDA kernel; use impl='auto' or 'plain'")
        return True
    return impl == "auto" and cuda and dtype != torch.float64


def dia_apply(dia: torch.Tensor, offsets: tuple, vpad: torch.Tensor,
              kernel: bool = False, col_shift: int = 0) -> torch.Tensor:
    """DIA-tier contribution in the natural (R, 128) layout: element e at
    [e // 128, e % 128]. `vpad` is the padded vector; columns outside it
    read zero.

    col_shift: diagonal offset o of element e reads vpad[e + col_shift +
    o]. The multi-device path (parallel/spmv.py) keeps a shard's rows
    local while the offsets are global diagonals and vpad is the global
    vector or the shard's halo window. A shift past the end of vpad (a
    tall matrix's late shards) reads zeros, so the JAX package's
    `max_shift_rows` sizing of a sliced copy has no counterpart here."""
    fn = dia_spmv if kernel else dia_spmv_plain
    return fn(dia, vpad, offsets, col_shift)


def sell_apply(
    chunks: tuple,
    out_gather: torch.Tensor,
    vpad: torch.Tensor,
    packs: tuple = (),
    gpack=None,
    kernel: bool = False,
    col_off: int = 0,
) -> torch.Tensor:
    """SELL-tier contribution: (block_rows, 8) row-major, in vpad's dtype.

    The tier's groups' rows are stacked in group order, chunks[g] * 128
    rows each, and a zero row last. A windowed group (one with a pack,
    packs[g]) goes through `sell_window`; the others are read from the
    tier's gathered pack `gpack` (ops/cuda/sell_gather_kernel.py) by
    `sell_gather`, which writes their rows and the zero row in place, with
    one pass over all of them. The rows are then placed by the out_gather
    row map (rows with no slots read the zero row).

    col_off: the column of the whole vector at which vpad starts, for the
    gathered pack's global columns (the multi-device halo mode, whose
    plans have no windowed group); v reads 0 outside vpad.
    """
    n = vpad.shape[0]
    rows_total = sum(chunks) * SELL_C
    u_rows = torch.empty((rows_total + 1, BLOCK_HEIGHT), dtype=vpad.dtype,
                         device=vpad.device)
    if gpack is not None:
        gather = sell_gather if kernel else sell_gather_plain
        gather(gpack, vpad, n, u_rows.view(-1), col_off)
    else:
        u_rows[rows_total:] = 0
    base = 0
    for g, ch in enumerate(chunks):
        if g < len(packs) and packs[g] is not None:
            win = sell_window if kernel else sell_window_plain
            u_rows[base:base + ch * SELL_C] = win(packs[g], vpad, n).transpose(
                1, 2).reshape(-1, BLOCK_HEIGHT)
        base += ch * SELL_C
    return u_rows[out_gather.long().clamp(max=rows_total)]


def spmv(m, v: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """u = A @ v.

    Args:
      m: BmSparse matrix (untransposed intra-block layout), or a Prepared
        plan from ops.plan.prepare().
      v: dense vector of length m.num_cols, on the matrix's device.
      impl: "auto" | "cuda" | "plain" | None (config default); see the
        module docstring.
    """
    if m.transposed:
        raise ValueError("SpMV expects an untransposed (row-major) matrix")
    if v.dim() != 1 or v.shape[0] != m.num_cols:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected "
                         f"({m.num_cols},)")
    impl = impl or get_config().spmv_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown SpMV impl {impl!r}")
    if isinstance(m, Prepared):
        return _spmv_prepared(m, v, impl)
    if impl == "cuda":
        return _spmv_prepared(prepare_cached(m), v, impl)
    return _spmv_xla(m, v)


def csr_spmv(a, v: torch.Tensor) -> torch.Tensor:
    """u = A @ v for a CSRMatrix (format/convert.py), as a gather and an
    index_add_ over its row ids: the CSR reference path. No kernel computes
    it in the JAX package either."""
    contrib = a.data * v[a.indices.long()]
    return torch.zeros(a.num_rows, dtype=contrib.dtype,
                       device=contrib.device).index_add_(
        0, a.row_ids().long(), contrib)
