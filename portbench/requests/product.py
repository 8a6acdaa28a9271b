"""Request kind `product`: C = A @ B through the program's cached product
(`prepare_product(A, B)` once; each request `pp(a_s, b_s)` with the value
set s = i mod `value_sets`, then a synchronize): a product whose structure
is fixed and whose values change, as in an AMG set-up or an A^k chain.

B is A's own matrix in the transposed intra-block layout, as the program's
SpGEMM takes its right operand. Compared: C's structure (every entry's
coordinates, decoded from its block rows and columns, bitmaps and
offsets, against the reference's pattern of A @ A) and its values.
"""

from __future__ import annotations

import torch

from portbench import judge, roofline


class Driver:
    def __init__(self, problem, traffic: dict, run):
        import bmsparse_tpu_torch as bt

        self.bt, self.problem, self.traffic, self.run = bt, problem, traffic, run
        self.sets = self.classes = int(traffic["value_sets"])
        with run.span("convert"):
            self.ops = [self._operands(0, 0)]
        with run.span("plan"):
            self.pp = bt.prepare_product(*self.ops[0])
        self.nnz_c = problem.square_nnz()
        self.work = self.nnz_c * 1e-9             # Gnnz of C
        self.seed = None

    def _operands(self, s: int, seed: int):
        rows, cols, vals = self.problem.coo(s, seed)
        conv = self.bt.coo_to_bmsparse
        shape = self.problem.shape
        return (conv(rows, cols, vals, shape, backend="device",
                     device=self.run.device),
                conv(rows, cols, vals, shape, transposed=True,
                     backend="device", device=self.run.device))

    def set_seed(self, seed: int) -> None:
        """Convert the seed's value sets 1.. (set 0 is the seed's too)."""
        self.seed = seed
        self.ops = self.ops[:1] + [self._operands(s, seed)
                                   for s in range(1, self.sets)]
        self._ref = {}

    def request(self, i: int):
        c = self.pp(*self.ops[i % self.sets])
        self.run.sync()
        return c

    def control(self, i: int):
        """The reference in bfloat16 in the program's place, as keys and
        values."""
        ref = self.problem.reference(i % self.sets, self.seed,
                                     torch.bfloat16)
        keys, vals, _ = ref.square_coo()
        return keys, vals, 0

    def canon(self, out):
        """A held answer as (keys, values, entries outside the matrix)."""
        return out if isinstance(out, tuple) else judge.decode(out)

    def check_output(self):
        return None

    control_check_output = check_output

    def judge_check(self, out) -> dict:
        return {}

    def judge(self, held: list) -> dict:
        mismatch, gap = 0, 0.0
        for i, out in held:
            s = i % self.sets
            if s not in self._ref:
                self._ref = {s: self.problem.reference(
                    s, self.seed, torch.float64).square_coo()}
            m, g = judge.sparse_gap(*self.canon(out), *self._ref[s])
            mismatch, gap = mismatch + m, max(gap, g)
        return {"c_structure": mismatch, "c_gap": gap}

    # -- traced runs --------------------------------------------------------
    def least_request_s(self) -> float:
        rows_a, cols_a = self.problem.row_col_counts()
        flops = 2 * roofline.spgemm_products(cols_a, rows_a)     # B = A
        nnz = self.problem.nnz
        b = roofline.spgemm_least_bytes(nnz, nnz, self.nnz_c)
        return roofline.least_seconds(b, flops, self.run.card)[0]

    def probes(self, run) -> None:
        pass

    def free(self) -> None:
        self.pp = None
        self.ops = []
