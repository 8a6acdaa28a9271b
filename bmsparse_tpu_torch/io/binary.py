"""Binary persistence of BmSparse matrices and of their SpMV plans —
counterpart of ``bmsparse_tpu/io/binary.py``.

The reference includes cusp/io/binary.h under the comment "Dumping
bmSparse matrices to disk" (ref: src/bmSparse_SPGEMM.cu:21-27) but the
dump code did not survive. The container dump is the JAX package's npz,
byte for byte where the values are float32 or bfloat16, so a file crosses
between the packages in both directions:

  version (int32 1); brow, bcol, offsets (int32[nb]); bmp_hi, bmp_lo
  (uint32[nb]); values (dtype[nnz]); meta (int64 [num_rows, num_cols,
  nnz, transposed]).

numpy has no bfloat16: bf16 values are stored as their 2-byte patterns
under the header descr '<V2', as numpy writes JAX's ml_dtypes bfloat16,
and a 2-byte void array is read back as bf16 bits.
"""

from __future__ import annotations

import dataclasses
import zipfile

import numpy as np
import torch

from ..format import bitmap as bm
from ..format.bmsparse import BmSparse

_FORMAT_VERSION = 1
_BF16_DESCR = "<V2"


def _write_npy(f, a) -> None:
    """One .npy member; a bf16 tensor as its bit patterns under '<V2'."""
    if isinstance(a, torch.Tensor):   # bf16 values only
        bits = a.cpu().contiguous().view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": bits.shape})
        f.write(bits.tobytes())
    else:
        np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def save_bmsparse(path: str, m: BmSparse) -> None:
    """Write m's valid blocks and values as the JAX package's npz
    (uncompressed, as np.savez writes it; `.npz` is appended to a path
    without it)."""
    nb = int(m.nb)
    if m.values.dtype == torch.bfloat16:
        values = m.values[: m.nnz]
    else:
        values = m.values[: m.nnz].cpu().numpy()
    arrays = dict(
        version=np.int32(_FORMAT_VERSION),
        brow=m.brow[:nb].cpu().numpy(),
        bcol=m.bcol[:nb].cpu().numpy(),
        bmp_hi=bm.tensor_to_words_np(m.bmp_hi[:nb]),
        bmp_lo=bm.tensor_to_words_np(m.bmp_lo[:nb]),
        offsets=m.offsets[:nb].cpu().numpy(),
        values=values,
        meta=np.array(
            [m.num_rows, m.num_cols, m.nnz, int(m.transposed)], np.int64),
    )
    if not path.endswith(".npz"):
        path = path + ".npz"
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, a in arrays.items():
            with z.open(key + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, a)


def load_bmsparse(path: str, device="cuda") -> BmSparse:
    """Read an npz written by either package onto `device` (the card
    unless the caller asks for the CPU). Raises ValueError on a dump
    version this code does not read."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported bmsparse dump version {z['version']}")
        nr, nc, nnz, transposed = (int(x) for x in z["meta"])
        vals = z["values"]
        if vals.dtype.kind == "V" and vals.dtype.itemsize == 2:
            values = torch.from_numpy(
                vals.view(np.uint16).view(np.int16)).view(torch.bfloat16)
        else:
            values = torch.from_numpy(np.ascontiguousarray(vals))

        def i32(key):
            return torch.from_numpy(np.asarray(z[key], np.int32)).to(device)

        return BmSparse(
            brow=i32("brow"), bcol=i32("bcol"),
            bmp_hi=bm.words_to_tensor(z["bmp_hi"], device),
            bmp_lo=bm.words_to_tensor(z["bmp_lo"], device),
            offsets=i32("offsets"), values=values.to(device),
            nb=len(z["brow"]), num_rows=nr, num_cols=nc, nnz=nnz,
            transposed=bool(transposed),
        )


# ---------------------------------------------------------------------------
# Prepared-plan persistence: the tiered SpMV plan is a pure function of
# the matrix, deterministic and costly to build on the host at SuiteSparse
# scale, so CLI and benchmark loops keep it on disk next to the matrix
# dump.
# ---------------------------------------------------------------------------
_PLAN_DUMP_VERSION = 1


def _cpu(x):
    """Tensors moved to the CPU, in tuples and in a SellPack's or a
    GatherPack's fields (a dict of them, which torch.load's weights_only
    mode accepts)."""
    from ..ops.cuda.sell_gather_kernel import GatherPack
    from ..ops.cuda.sell_kernel import SellPack

    if isinstance(x, tuple):
        return tuple(_cpu(t) for t in x)
    if isinstance(x, (SellPack, GatherPack)):
        return {k: _cpu(t) for k, t in x.state().items()}
    return x.cpu() if isinstance(x, torch.Tensor) else x


def save_prepared(path: str, p) -> None:
    """Dump a Prepared plan (ops/plan.py) to `path` with torch.save: every
    field of the plan and of its StreamPlan by name, tensors on the CPU,
    stamped with the plan dtype, the dump version and PLAN_LAYOUT_VERSION.

    The container is not stored: pair the dump with save_bmsparse and
    attach the live matrix on load. The dump is the port's own: the JAX
    package pickles a JAX treedef, so plan dumps do not cross between the
    packages (container npz files do)."""
    from ..ops.plan import PLAN_LAYOUT_VERSION, Prepared

    if not isinstance(p, Prepared):
        raise TypeError(f"expected a Prepared plan, got {type(p).__name__}")
    fields = {f.name: _cpu(getattr(p, f.name))
              for f in dataclasses.fields(p)
              if f.name not in ("m", "dense_flat_", "stream")}
    stream = None if p.stream is None else {
        f.name: _cpu(getattr(p.stream, f.name))
        for f in dataclasses.fields(p.stream)}
    torch.save({"version": _PLAN_DUMP_VERSION,
                "layout_version": PLAN_LAYOUT_VERSION,
                "fields": fields, "stream": stream}, path)


def load_prepared(path: str, m: BmSparse):
    """Load a plan dumped by save_prepared and attach it to the live
    container `m` (which must be the same matrix); every tensor moves to
    m's device in one pass. Returns None when the dump's version or layout
    stamp does not match the running code: callers fall back to
    prepare(m)."""
    from ..ops.cuda.sell_gather_kernel import GatherPack
    from ..ops.cuda.sell_kernel import SellPack
    from ..ops.plan import PLAN_LAYOUT_VERSION, Prepared
    from ..ops.route import StreamPlan

    d = torch.load(path, map_location="cpu", weights_only=True)
    if (d.get("version") != _PLAN_DUMP_VERSION
            or d.get("layout_version") != PLAN_LAYOUT_VERSION):
        return None
    stream = None if d["stream"] is None else StreamPlan(**d["stream"])
    fields = dict(d["fields"])
    fields["sell_pack"] = tuple(None if x is None else SellPack(**x)
                                for x in fields["sell_pack"])
    for f in ("sell_gpack", "ovf_gpack"):
        if fields[f] is not None:
            fields[f] = GatherPack(**fields[f])
    return Prepared(m=m, stream=stream, **fields).to(m.device)
