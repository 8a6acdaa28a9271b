"""Cached SpGEMM products — counterpart of ``bmsparse_tpu/ops/product.py``:
pay the symbolic and planning cost once per structure, re-run only the
numeric phase per multiply.

`prepare_product(A, B)` runs T1-T6 and the numeric plan
(ops/spgemm.py::_plan_product) and keeps every structure-dependent
tensor: the per-K-group slot tables, the compress columns and C's
container fields. Calling the product then runs only

    operand gathers + block products + K-sums (the two kernels) -> compress

on the device, with no host work and no host sync. The compress is the
one the plan chose (`compress_mode`: "scatter", "fold" or "mxu", from
config spgemm_compress at prepare time). Values may change
between calls while the structure (blocks and bitmaps) stays: pass the
updated operands to __call__.
"""

from __future__ import annotations

import torch

from ..format.bmsparse import BmSparse
from ..utils.timing import PhaseTimer, span
from . import spgemm as sg


def _structure_fingerprint(m: BmSparse):
    """A hash of the bitmaps for CPU tensors, None for tensors on a
    device: comparing there would cost the device-to-host sync the cached
    product exists to avoid."""
    if m.bmp_hi.device.type != "cpu" or m.bmp_lo.device.type != "cpu":
        return None
    return hash((m.bmp_hi.numpy().tobytes(), m.bmp_lo.numpy().tobytes()))


class PreparedProduct:
    """A structure-frozen C = A @ B with a device-only numeric path."""

    def __init__(self, plan: "sg._ProductPlan", impl: str):
        self.plan = plan
        self.impl = impl
        self.shape = (plan.a.num_rows, plan.b.num_cols)
        self.num_c_blocks = plan.num_c_blocks
        self.num_c_nnz = plan.num_c_nnz
        self.compress_mode = plan.compress_mode
        self._fp_a = _structure_fingerprint(plan.a)
        self._fp_b = _structure_fingerprint(plan.b)

    def _operand(self, x, m_ref: BmSparse, flat_ref, fp_ref, name: str):
        from .plan import Prepared

        m = x.m if isinstance(x, Prepared) else x
        if m.nb != m_ref.nb or m.nnz != m_ref.nnz or m.shape != m_ref.shape:
            raise ValueError(f"operand {name} structure changed; re-prepare")
        if fp_ref is not None:
            fp = _structure_fingerprint(m)
            if fp is not None and fp != fp_ref:
                raise ValueError(f"operand {name} bitmaps changed; re-prepare")
        flat = x.dense_flat if isinstance(x, Prepared) \
            else m.decompress_blocks_flat()
        if flat.shape != flat_ref.shape:
            raise ValueError(f"operand {name} structure changed; re-prepare")
        return flat

    def __call__(self, a=None, b=None) -> BmSparse:
        """Multiply with the cached structure.

        a/b: optional operands (BmSparse or Prepared) with new values and
        the same structure; default the ones captured at prepare time.
        Block count, nnz and shape are always checked, and the bitmaps
        too where both operands lie on the CPU. Spans: the call
        (`product`) and the operands' decompress (`product.decompress`).
        """
        p = self.plan
        with span("product"):
            with span("product.decompress"):
                a_flat = p.a_flat if a is None else self._operand(
                    a, p.a, p.a_flat, self._fp_a, "A")
                b_flat = p.b_flat if b is None else self._operand(
                    b, p.b, p.b_flat, self._fp_b, "B")
            kernels = sg._use_kernels(
                self.impl, a_flat.device,
                torch.promote_types(a_flat.dtype, b_flat.dtype))
            return sg._assemble_c(
                p, sg._numeric_from_plan(p, kernels, a_flat, b_flat))


def prepare_product(a, b, impl: str | None = None) -> PreparedProduct:
    """Build the cached product plan for C = A @ B (see module docstring).

    Operands may be BmSparse or Prepared; impl as in ops.spgemm.spgemm
    ("auto" | "cuda" | "plain"), checked now and applied per call.
    """
    from ..config import get_config
    from .plan import Prepared, as_matrix

    a_prep = a if isinstance(a, Prepared) else None
    b_prep = b if isinstance(b, Prepared) else None
    am, bm = as_matrix(a), as_matrix(b)
    sg._check_operands(am, bm)
    impl = impl or get_config().spgemm_impl
    if impl == "xla":
        raise ValueError("prepare_product supports impl 'auto'|'cuda'|"
                         "'plain', got 'xla'")
    sg._use_kernels(impl, am.device, torch.promote_types(am.dtype, bm.dtype))
    plan = sg._plan_product(am, bm, a_prep, b_prep,
                            PhaseTimer(enabled=False), False)
    return PreparedProduct(plan, impl)
