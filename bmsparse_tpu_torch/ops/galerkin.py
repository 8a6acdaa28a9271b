"""Galerkin coarse operators with a frozen structure: A_c = P^T (A P), the
set-up product of an algebraic multigrid level, re-run with new values
of A while the aggregates, P and R = P^T stay (structure reuse, as in
AmgX's `structure_reuse_levels` with `AMGX_solver_resetup`).

`prepare_galerkin(A, P)` forms R = P^T on the device (format/layout.py),
plans the two products A P and R (A P) once (ops/product.py's plans,
ops/spgemm.py::_plan_product) and builds two maps from packed values to
the products' dense operand tiles: one for A, and one that carries the
product A P, as it leaves the first product, into the second product's
B operand (the layout switch to B's transposed layout composed with its
tiles, format/layout.py). A call `g(A_new)` then runs

    A_new's tiles (one scatter) -> A P (products, compress)
      -> R (A P)'s B tiles (one scatter) -> R (A P) (products, compress)

on the device, with no host sync and no COO. A_c is a row-major BmSparse
of the structure the plan froze, as PreparedProduct's outputs are, so
the next level's PreparedGalerkin takes it as its A as it stands.
"""

from __future__ import annotations

import torch

from ..format.bmsparse import BmSparse
from ..format.layout import relayout, tiles_from_values, transpose, value_slots
from ..utils.timing import span
from . import spgemm as sg
from .product import _structure_fingerprint, prepare_product


class PreparedGalerkin:
    """A structure-frozen A_c = P^T (A P) with a device-only numeric path.

    Attributes: `ap` and `rap`, the two PreparedProducts; `r`, R = P^T
    (row-major); `shape`, A_c's; `num_c_nnz`, nnz(A_c)."""

    def __init__(self, a: BmSparse, p: BmSparse, impl: str | None):
        with span("galerkin.plan", keep=True):
            if a.transposed:
                raise ValueError("A must be stored untransposed (row-major "
                                 "blocks)")
            p_b, _ = relayout(p, True)
            self.r, _ = transpose(p_b, False)   # row-major P^T, no switch
            self.ap = prepare_product(a, p_b, impl)
            plan = self.ap.plan
            ap = sg._assemble_c(plan, torch.zeros(
                plan.nnz_pad, dtype=torch.promote_types(a.dtype, p.dtype),
                device=a.device))
            ap_b, perm = relayout(ap, True)
            self.rap = prepare_product(self.r, ap_b, impl)
            # A P's value perm[q] is its B operand's value q, at slots_b[q]
            slots_b = value_slots(ap_b)
            self._ap_slots = torch.empty_like(slots_b)
            self._ap_slots[perm[:ap_b.nnz]] = slots_b
            self._a_slots = value_slots(a)
            self._a = (a.nb, a.nnz, a.nb_pad, a.shape)
            self._fp_a = _structure_fingerprint(a)
            self.shape = self.rap.shape
            self.num_c_nnz = self.rap.num_c_nnz
            self.impl = self.ap.impl

    def _tiles_a(self, a: BmSparse) -> torch.Tensor:
        if (a.nb, a.nnz, a.nb_pad, a.shape) != self._a or a.transposed:
            raise ValueError("operand A structure changed; re-prepare")
        if self._fp_a is not None:
            fp = _structure_fingerprint(a)
            if fp is not None and fp != self._fp_a:
                raise ValueError("operand A bitmaps changed; re-prepare")
        return tiles_from_values(a.values, self._a_slots, a.nb_pad)

    def __call__(self, a: BmSparse) -> BmSparse:
        """A_c = P^T (a P) for a BmSparse `a` with new values and the
        planned structure (block count, nnz, padding and shape checked,
        and the bitmaps too where `a` lies on the CPU). Spans: the call
        (`galerkin`), each product (`product`), A's tiles
        (`product.decompress`) and the switch of A P into the second
        product's B operand (`galerkin.relayout`)."""
        p1, p2 = self.ap.plan, self.rap.plan
        with span("galerkin"):
            with span("product"):
                with span("product.decompress"):
                    a_flat = self._tiles_a(a)
                kernels = sg._use_kernels(
                    self.impl, a_flat.device,
                    torch.promote_types(a_flat.dtype, p1.b_flat.dtype))
                ap_values = sg._numeric_from_plan(p1, kernels, a_flat,
                                                  p1.b_flat)
            with span("product"):
                with span("galerkin.relayout"):
                    b_flat = tiles_from_values(ap_values, self._ap_slots,
                                               p2.b_flat.shape[0])
                return sg._assemble_c(p2, sg._numeric_from_plan(
                    p2, kernels, p2.a_flat, b_flat))


def prepare_galerkin(a: BmSparse, p: BmSparse,
                     impl: str | None = None) -> PreparedGalerkin:
    """Plan A_c = P^T (A P) for a row-major A (n x n) and a P (n x n_c)
    in either intra-block layout, both on one device; impl as in
    ops.spgemm.spgemm ("auto" | "cuda" | "plain"), checked now and
    applied per call. The set-up's host seconds are kept as the phase
    `galerkin.plan` (utils/timing.py)."""
    return PreparedGalerkin(a, p, impl)
