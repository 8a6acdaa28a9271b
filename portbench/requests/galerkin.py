"""Request kind `galerkin`: the re-set-up of a smoothed-aggregation AMG
hierarchy with its structure reused, through the program's cached
Galerkin product. At set-up, per level, `prepare_galerkin(A_l, P_l)` on
the frozen P_l of the first set-up (generators/hpcg_sa.py), and A_{l+1}
its first output; each request then recomputes A_1, ..., A_L from A0's
value set s = i mod `value_sets` (each level's output the next level's
input as it stands), then a synchronize: the six products of a
four-level re-set-up.

Compared, per level: the structure of A_{l+1} (every entry's
coordinates, decoded, against the symbolic pattern of |R| |A| |P|) and
its values against P^T A P in float64 (reference/galerkin.py), each
entry's gap scaled by |R| |A| |P|. The inputs of level l are those the
program used: A0 as generated, then the program's own A_l, so each
level's gap is that level's rounding.
"""

from __future__ import annotations

import torch

from portbench import judge, roofline
from portbench.reference import galerkin as ref


class Driver:
    def __init__(self, problem, traffic: dict, run):
        import bmsparse_tpu_torch as bt

        self.bt, self.problem, self.traffic, self.run = bt, problem, traffic, run
        self.sets = self.classes = int(traffic["value_sets"])
        with run.span("convert"):
            self.a0 = [self._fine(0, 0)]
            ps = [self._convert(p) for p in problem.p]
        with run.span("plan"):
            self.gals = []
            a = self.a0[0]
            for p in ps:
                gal = bt.prepare_galerkin(a, p)
                a = gal(a)
                self.gals.append(gal)
        self.work = problem.chain_nnz() * 1e-9          # Gnnz of the C's
        self.seed = None

    def _convert(self, m: ref.Sparse):
        return self.bt.coo_to_bmsparse(m.rows, m.cols, m.vals.float(),
                                       m.shape, backend="device",
                                       device=self.run.device)

    def _fine(self, s: int, seed: int):
        rows, cols, vals = self.problem.coo(s, seed)
        return self.bt.coo_to_bmsparse(rows, cols, vals, self.problem.shape,
                                       backend="device",
                                       device=self.run.device)

    def set_seed(self, seed: int) -> None:
        """Convert the seed's value sets 1.. (set 0 is the seed's too)."""
        self.seed = seed
        self.a0 = self.a0[:1] + [self._fine(s, seed)
                                 for s in range(1, self.sets)]
        self._ref = {}

    def request(self, i: int):
        a, out = self.a0[i % self.sets], []
        for gal in self.gals:
            a = gal(a)
            out.append(a)
        self.run.sync()
        return tuple(out)

    def control(self, i: int):
        """The reference chain in bfloat16 in the program's place, as
        (keys, values, 0) per level."""
        a = self.problem.fine(i % self.sets, self.seed, torch.bfloat16)
        out = []
        for p in self.problem.p:
            c = ref.galerkin(a, ref.Sparse(p.rows, p.cols,
                                           p.vals.to(torch.bfloat16),
                                           p.shape))
            out.append((c.keys(), c.vals[:, 0], 0))
            a = ref.Sparse(c.rows, c.cols, c.vals[:, 0], c.shape)
        return tuple(out)

    def canon(self, level):
        """A held level as (keys, values, entries outside the matrix)."""
        return level if isinstance(level, tuple) else judge.decode(level)

    def check_output(self):
        return None

    control_check_output = check_output

    def judge_check(self, out) -> dict:
        return {}

    def _reference(self, lvl: int, a: ref.Sparse):
        p = self.problem.p[lvl]
        c = ref.galerkin(a, ref.Sparse(p.rows, p.cols, p.vals.double(),
                                       p.shape))
        return c.keys(), c.vals[:, 0], c.vals[:, 1]

    def judge(self, held: list) -> dict:
        mismatch, gap = 0, 0.0
        for i, out in held:
            s = i % self.sets
            if s not in self._ref:          # level 0's, from A0 alone
                self._ref = {s: self._reference(0, self.problem.fine(
                    s, self.seed, torch.float64))}
            want = self._ref[s]
            for lvl, level in enumerate(out):
                keys, vals, outside = self.canon(level)
                m, g = judge.sparse_gap(keys, vals, outside, *want)
                mismatch, gap = mismatch + m, max(gap, g)
                if lvl + 1 < len(out):      # the next level's input
                    n = self.problem.p[lvl].shape[1]
                    inside = (keys >= 0) & (keys < n * n)
                    keys, order = torch.sort(keys[inside])
                    want = self._reference(lvl + 1, ref.from_keys(
                        keys, vals[inside][order].double(), (n, n)))
        return {"c_structure": mismatch, "c_gap": gap}

    # -- traced runs --------------------------------------------------------
    def least_request_s(self) -> float:
        """The six products' least times (each the longer of its bytes
        and its FLOPs), plus the values of each A_l P_l read and written
        once more where they pass to the second product."""
        card = self.run.card
        total = 0.0
        for lv in self.problem.levels:
            for nnz_x, nnz_y, nnz_c, prods in (
                    (lv["nnz_a"], lv["nnz_p"], lv["nnz_ap"],
                     lv["products_ap"]),
                    (lv["nnz_p"], lv["nnz_ap"], lv["nnz_c"],
                     lv["products_rap"])):
                total += roofline.least_seconds(
                    roofline.spgemm_least_bytes(nnz_x, nnz_y, nnz_c),
                    2 * prods, card)[0]
            total += roofline.least_seconds(2 * 4 * lv["nnz_ap"], 0,
                                            card)[0]
        return total

    def probes(self, run) -> None:
        pass

    def free(self) -> None:
        self.gals = []
        self.a0 = []
