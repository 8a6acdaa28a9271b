"""Containers and plans from numpy arrays.

These build the port's BmSparse, Prepared and SpGEMM product plan from the
arrays of another implementation's container or plan (for instance the JAX package's, pulled
to the host with np.asarray), so that both implementations can be fed the
same matrix and the same plan. Bitmap words are numpy uint32; bfloat16
arrays (numpy extension dtype named "bfloat16") are taken bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .format import bitmap as bm
from .format.bmsparse import BmSparse
from .ops.cuda.sell_gather_kernel import GatherPack, gather_pack
from .ops.cuda.sell_kernel import pack_group
from .ops.cuda.spgemm_window_kernel import _SENT_REL
from .ops.plan import Prepared
from .ops.route import StreamPlan
from .ops.spgemm import _product_launches

_PLAN_TENSORS = ("dia", "out_gather", "ovf_gather")
_PLAN_STATICS = ("dia_offsets", "sell_ks", "sell_rows", "ovf_ks",
                 "ovf_rows")


def tensor_from_numpy(a, device=None) -> torch.Tensor | None:
    """numpy array -> tensor, bfloat16 included (by its bit pattern)."""
    if a is None:
        return None
    a = np.array(a)   # a writable copy: the source may be read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def bmsparse_from_numpy(arrays: Mapping[str, Any], num_rows: int,
                        num_cols: int, nnz: int, transposed: bool,
                        device="cuda") -> BmSparse:
    """A BmSparse on `device` (the card unless the caller asks for the
    CPU) from its arrays: brow, bcol, bmp_hi, bmp_lo (uint32 words),
    offsets, values, nb."""
    return BmSparse(
        brow=tensor_from_numpy(np.asarray(arrays["brow"], np.int32), device),
        bcol=tensor_from_numpy(np.asarray(arrays["bcol"], np.int32), device),
        bmp_hi=bm.words_to_tensor(arrays["bmp_hi"], device),
        bmp_lo=bm.words_to_tensor(arrays["bmp_lo"], device),
        offsets=tensor_from_numpy(np.asarray(arrays["offsets"], np.int32),
                                  device),
        values=tensor_from_numpy(arrays["values"], device),
        nb=int(np.asarray(arrays["nb"])),
        num_rows=num_rows, num_cols=num_cols, nnz=nnz,
        transposed=transposed,
    )


def prepared_from_numpy(m: BmSparse, arrays: Mapping[str, Any],
                        device=None) -> Prepared:
    """A Prepared plan for `m` from the JAX package's plan arrays, keyed
    by its Prepared field names: plan_dtype (a dtype name), dia,
    out_gather, ovf_gather (arrays or None), the per-group tuples of its
    slabs sell_dense (cw, chunks, K, 8, 128), sell_bcol, sell_ws,
    sell_rel, ovf_dense, ovf_bcol (entries may be None), the statics
    dia_offsets, sell_ks, sell_rows, ovf_ks, ovf_rows, and optionally
    `stream`: a mapping of the StreamPlan fields (arrays and statics) or
    None. The slabs are read on the host and not kept: the windowed
    groups' packs (sell_pack) are cut from them as prepare() cuts them,
    and so are the gathered groups' (sell_gpack, ovf_gpack)."""
    device = m.device if device is None else device
    fields: dict = {f: tensor_from_numpy(arrays.get(f))
                    for f in _PLAN_TENSORS}
    for f in _PLAN_STATICS:
        v = arrays.get(f, ())
        fields[f] = tuple(int(x) for x in v) if isinstance(
            v, (tuple, list)) else int(v)
    slabs = {f: tuple(tensor_from_numpy(a) for a in arrays.get(f, ()))
             for f in ("sell_dense", "sell_bcol", "sell_ws", "sell_rel",
                       "ovf_dense", "ovf_bcol")}
    fields["sell_pack"] = tuple(
        None if rel is None else pack_group(d, rel, ws)
        for d, rel, ws in zip(slabs["sell_dense"], slabs["sell_rel"],
                              slabs["sell_ws"]))
    for tier, windowed in (("sell", fields["sell_pack"]), ("ovf", ())):
        dense = slabs[f"{tier}_dense"]
        fields[f"{tier}_chunks"] = tuple(d.shape[1] for d in dense)
        gathered = [g for g in range(len(dense))
                    if g >= len(windowed) or windowed[g] is None]
        fields[f"{tier}_gpack"] = pack_from_slabs(
            dense, slabs[f"{tier}_bcol"], gathered,
            fields[f"{tier}_rows"]) if gathered else None
    st = arrays.get("stream")
    if st is not None:
        fields["stream"] = StreamPlan(
            **{f: tensor_from_numpy(st[f]) for f in StreamPlan.TENSORS},
            **{f: int(st[f]) for f in StreamPlan.STATICS})
    return Prepared(m=m, plan_dtype=str(arrays["plan_dtype"]),
                    **fields).to(device)


def pack_from_slabs(dense: tuple, bcol: tuple, groups,
                    rows_total: int) -> GatherPack:
    """The GatherPack of a tier's groups `groups` read from the JAX
    package's slabs dense[g] (cw, cap, kg, 8, 128) and bcol[g] (cap * kg *
    128,). Every coefficient whose bits are not zero is packed.
    rows_total: the tier's stacked rows; groups are stacked in order, each
    cap * 128 rows."""
    caps = [d.shape[1] for d in dense]
    bases = np.cumsum([0] + [c * 128 for c in caps])
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    row_l, col_l, val_l, rows_l = [], [], [], []
    roff = 0
    for g in groups:
        d = dense[g].detach().cpu().contiguous()
        cw, cap, kg = d.shape[:3]
        w, c, k, i, lane = (x.numpy() for x in torch.nonzero(
            d.view(ibits[d.element_size()]), as_tuple=True))
        b = bcol[g].detach().cpu().numpy().reshape(cap, kg, 128)
        stacked = np.arange(bases[g] * 8, bases[g + 1] * 8)
        row_l.append(roff + (c * 128 + lane) * 8 + i)
        col_l.append(b[c, k, lane].astype(np.int64) * cw + w)
        val_l.append(d[tuple(torch.from_numpy(x)
                             for x in (w, c, k, i, lane))])
        rows_l.append(stacked)
        roff += len(stacked)
    rows_l.append(np.arange(rows_total * 8, rows_total * 8 + 8))
    dtype = dense[0].dtype
    return gather_pack(
        np.concatenate(row_l) if row_l else np.zeros(0, np.int64),
        np.concatenate(col_l) if col_l else np.zeros(0, np.int64),
        torch.cat(val_l) if val_l else torch.zeros(0, dtype=dtype),
        np.concatenate(rows_l), dtype)


def _words(a, device) -> torch.Tensor:
    """uint32 words, or the same bits in int32 -> int64 32-bit patterns."""
    return bm.words_to_tensor(np.asarray(a).view(np.uint32), device)


def _int32s(x, device):
    """An int32 array, or nested tuples of them (entries may be None)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_int32s(t, device) for t in x)
    return tensor_from_numpy(np.asarray(x, np.int32), device)


def product_plan_from_numpy(a: BmSparse, b: BmSparse,
                            arrays: Mapping[str, Any], device=None):
    """An SpGEMM product plan (ops.spgemm._ProductPlan) for A @ B from a
    plan's fields, keyed by the _ProductPlan slot names: arrays, tuples
    of arrays (tas, tbs, pws, win_starts, sig_st; entries may be None)
    and statics (groups, pwin, win, nnz_pad, num_c_nnz, ...). Missing
    fields stay unset; a_flat / b_flat are the operands' dense tiles.
    Given groups, tas and tbs, the numeric launches are built as the
    port's planner builds them (ops.spgemm._product_launches), ordered by
    `chunk_amin` of the slot tables.
    Bitmap words — c_hi, c_lo, the first two sig_st columns and
    keys_tbl's columns 2-3 — may come as uint32 or as int32 views."""
    from .ops.spgemm import _ProductPlan

    device = a.device if device is None else torch.device(device)
    p = _ProductPlan()
    p.compress_mode, p.g_tbl = "scatter", None
    p.a, p.b = a.to(device), b.to(device)
    p.a_flat = p.a.decompress_blocks_flat()
    p.b_flat = p.b.decompress_blocks_flat()
    for name in _ProductPlan.__slots__:
        if name not in arrays:
            continue
        x = arrays[name]
        if name in ("c_hi", "c_lo"):
            v = _words(x, device)
        elif name == "sig_st":
            v = (_words(x[0], device), _words(x[1], device),
                 tensor_from_numpy(np.asarray(x[2], np.int64), device))
        elif name == "keys_tbl":
            k = np.asarray(x).astype(np.int64)
            k[:, 2:4] = np.asarray(x)[:, 2:4].view(np.uint32)
            v = torch.from_numpy(k).to(device)
        elif name in ("tas", "tbs", "pws", "win_starts"):
            v = _int32s(x, device)
        elif name in ("groups", "pwin", "win"):
            v = [None if g is None else tuple(int(i) for i in g) for g in x]
            v = v if name == "groups" else tuple(v)
        elif isinstance(x, (str, int, np.integer)):
            v = x if isinstance(x, str) else int(x)
        else:
            v = tensor_from_numpy(np.asarray(x), device)
        setattr(p, name, v)
    if all(f in arrays for f in ("groups", "tas", "tbs")):
        none = (None,) * len(p.groups)
        if "pwin" not in arrays:
            p.pwin = none
        ws_host = arrays.get("pws") or none
        if "pws" not in arrays:
            p.pws = none
        p.launches, p.rows, p.tas, p.tbs = _product_launches(
            p.groups, p.pwin, p.pws, ws_host, p.tas, p.tbs,
            chunk_amin(p.groups, p.pwin, ws_host, arrays["tas"],
                       p.a_flat.shape[0]))
    return p


def chunk_amin(groups, pwin, pws, tas, nb_a: int) -> np.ndarray:
    """Per chunk of a product plan, the least A block its slots read (the
    int64 maximum where it reads none), from host slot tables: the order
    key of the numeric work tables (the port's planner takes it from its
    plan packet)."""
    big = np.iinfo(np.int64).max
    amin = np.full(max((c1 for _, _, c1 in groups), default=0), big)
    for g, (_, c0, c1) in enumerate(groups):
        x = np.asarray(tas[g]).astype(np.int64)  # sell: (ch_pad, K, 128)
        if pwin[g] is not None:                  # (ntiles, K, 8, 128)
            ws = np.asarray(pws[g][0]).astype(np.int64)
            x = np.where(x == _SENT_REL, -1, ws[:, None, None, None] + x)
            x = x[:, :, :pwin[g][2]].transpose(0, 2, 1, 3)
            x = x.reshape(-1, *x.shape[2:])      # (ntiles * t, K, 128)
        v = np.where((x >= 0) & (x < nb_a), x, big).min(axis=(1, 2))
        m = min(v.shape[0], c1 - c0)
        amin[c0:c0 + m] = v[:m]
    return amin
