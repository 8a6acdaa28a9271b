"""HPCG's 27-point operator (generators/hpcg27.py, its value sets) and the
first set-up of a smoothed-aggregation AMG hierarchy on it, made on the
device.

The first set-up runs the plain reference (reference/galerkin.py) in
float64 on value set 0: per level the 3x3x3 boxes, rho(D^-1 A) by its
fixed power method, P_l = (I - omega D^-1 A_l) T_l and A_{l+1} = P_l^T A_l
P_l. The P_l are then frozen (structure reuse): the program gets them
rounded to float32, and the reference judges with the same rounded
values. From the hierarchy's patterns come the sizes of the chain's six
products: the nonzeros each writes (the work of one re-set-up) and the
scalar products and operand sizes of its least time.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.generators.hpcg27 import Problem as Hpcg27
from portbench.reference import galerkin as ref


class Problem(Hpcg27):
    """HPCG's operator, and the frozen P_l of its first set-up."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        rows, cols, vals = self.coo(0, 0)
        a0 = ref.Sparse(rows, cols, vals.double(), self.shape).sorted()
        h = ref.hierarchy(a0, self.grid, int(cfg["levels"]))
        # P as the program gets it: float32 (its pattern symbolic)
        self.p = [dataclasses.replace(p, vals=p.vals.float())
                  for p in h["p"]]
        self.omega = h["omega"]
        self.grids = h["grids"]
        # per level: nnz of A_l, P_l, A_l P_l and A_{l+1}, and the scalar
        # products of A_l P_l and of R_l (A_l P_l)
        self.levels = []
        for lvl, (p, ap) in enumerate(zip(h["p"], h["ap"])):
            a, ac = h["a"][lvl], h["a"][lvl + 1]
            self.levels.append({
                "nnz_a": a.rows.numel(), "nnz_p": p.rows.numel(),
                "nnz_ap": ap.rows.numel(), "nnz_c": ac.rows.numel(),
                "products_ap": ref.products(a, p),
                "products_rap": ref.products(p.transpose(), ap)})
        del h, a0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def chain_nnz(self) -> int:
        """Nonzeros the six products of one re-set-up write."""
        return sum(lv["nnz_ap"] + lv["nnz_c"] for lv in self.levels)

    def fine(self, value_set: int, seed: int, dtype) -> ref.Sparse:
        """A0 of a value set in `dtype`, from the float32 values the
        program gets, sorted."""
        rows, cols, vals = self.coo(value_set, seed)
        return ref.Sparse(rows, cols, vals.to(dtype), self.shape).sorted()


def generate(cfg: dict, device) -> Problem:
    return Problem(cfg, device)
